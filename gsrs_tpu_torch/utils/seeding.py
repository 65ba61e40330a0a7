"""Seeding of the host's global random streams (port of
`gsrs_tpu.utils.seeding`).

Seeds ``random``, numpy's legacy global generator and torch's default
generators (every device's). The port's sampler and initializer take
explicit generators seeded from the config, so this only pins code that
draws from the globals. Called at CLI start."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
