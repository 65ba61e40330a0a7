"""Plain PyTorch references that decide ``correct``. They import nothing
of the program under test."""

import importlib


def of(cfg: dict):
    """The plain reference a configuration names (``reference/<name>.py``)."""
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")
