"""Checkpoints with the JAX package's three save streams (port of
`gsrs_tpu.train.checkpoint`):

- ``last``, saved by the trainer at its cadence;
- ``best-epoch<N>`` on an NDCG improvement, with optional keep-top-K
  pruning;
- the periodic legacy name ``<model>-<dataset>-<layers>-<dim>`` every
  ``save_every`` epochs;

and the resume chain: an explicit path, then ``last``, then the legacy
name. A checkpoint is a directory of its stream's name holding one
`torch.save` file (`STATE_FILE`), so names, listings and the swap are
the JAX package's: each save writes ``<name>.tmp`` and swaps it in by two
renames, and a crash between them is recovered at the next resume.
Tensors are saved from the CPU and loaded with ``weights_only=True`` onto
the CPU, so a checkpoint written on the card restores on the CPU and the
other way round."""

from __future__ import annotations

import glob
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def legacy_name(model: str, dataset: str, num_layers: int, dim: int) -> str:
    return f"{model}-{dataset}-{num_layers}-{dim}"


def to_cpu(tree: Any) -> Any:
    """``tree`` (dicts, lists and tuples of tensors and plain values) with
    every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, checkpoint_dir: str):
        self.dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)

    # ----------------------------------------------------------------- save
    def _save(self, path: str, state: Dict[str, Any]) -> None:
        """Write ``path.tmp``, then swap it in: the old checkpoint stays
        whole until the new one is, and a crash leaves a ``.tmp`` or
        ``.old`` that the next save clears or `_recover` promotes."""
        tmp, old = path + ".tmp", path + ".old"
        for stale in (tmp, old):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        torch.save(to_cpu(state), os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    def save_last(self, state: Dict[str, Any]) -> None:
        self._save(os.path.join(self.dir, "last"), state)

    def save_best(self, state: Dict[str, Any], epoch: int, keep_topk: int = 0) -> None:
        self._save(os.path.join(self.dir, f"best-epoch{epoch}"), state)
        if keep_topk > 0:
            bests = sorted(glob.glob(os.path.join(self.dir, "best-epoch*")),
                           key=lambda p: int(re.search(r"best-epoch(\d+)", p).group(1)))
            for stale in bests[:-keep_topk]:
                shutil.rmtree(stale, ignore_errors=True)

    def save_periodic(self, state: Dict[str, Any], name: str) -> None:
        self._save(os.path.join(self.dir, name), state)

    # -------------------------------------------------------------- restore
    def restore(self, path: str) -> Dict[str, Any]:
        """The state saved at ``path`` (a checkpoint directory), tensors on
        the CPU."""
        return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                          weights_only=True)

    def resolve_resume_path(
        self, resume_path: Optional[str], legacy: Optional[str] = None
    ) -> Optional[str]:
        """The resume chain: ``resume_path``, then <dir>/last, then the
        legacy-named checkpoint. An explicit path that does not exist is
        an error, not a fall-through (use no path for resume-if-exists).
        A checkpoint stranded mid-swap (only .tmp/.old left) is recovered
        before the existence check."""
        if resume_path:
            if os.path.isdir(self._recover(resume_path)):
                return resume_path
            raise FileNotFoundError(
                f"--resume_path {resume_path!r} does not exist (refusing to silently fall "
                f"back to {os.path.join(self.dir, 'last')}; use --resume without "
                "--resume_path for resume-if-exists)")
        candidates = [os.path.join(self.dir, "last")]
        if legacy:
            candidates.append(os.path.join(self.dir, legacy))
        for c in candidates:
            if os.path.isdir(self._recover(c)):
                return c
        return None

    @staticmethod
    def _recover(path: str) -> str:
        """Promote a complete .tmp (newest) or .old sibling left by a crash
        between `_save`'s two renames. → ``path``, recovered or not."""
        if not os.path.isdir(path):
            for sib in (path + ".tmp", path + ".old"):
                if os.path.isdir(sib):
                    os.rename(sib, path)
                    print(f"[checkpoint] recovered {path} from {sib}")
                    break
        return path
