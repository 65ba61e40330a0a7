"""CSV and TensorBoard logs of a training run (port of
`gsrs_tpu.train.logging`), with the JAX package's schemas:

- train_epoch_metrics.csv: epoch,time_sec,train_loss,lr
- valid_epoch_metrics.csv: epoch,time_sec,lr,precision@k…,recall@k…,ndcg@k…

TensorBoard scalars keep the JAX package's tags (``Train/loss``,
``Test/Recall@[20]/20``, …). The writer is tensorboardX's when it
imports, else ``torch.utils.tensorboard``'s, and a no-op when neither is
installed or the run asks for none."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional, Sequence


class CsvLogger:
    def __init__(self, path: str, header: Sequence[str]):
        self.path = path
        self.header = list(header)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.header)

    def append(self, row: Dict[str, object]) -> None:
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(col, "") for col in self.header])


class NullLog:
    """A log that writes nothing (a mesh rank other than rank 0)."""

    def append(self, row: Dict[str, object]) -> None:
        pass


def make_train_csv(checkpoint_dir: str) -> CsvLogger:
    return CsvLogger(os.path.join(checkpoint_dir, "train_epoch_metrics.csv"),
                     ["epoch", "time_sec", "train_loss", "lr"])


def make_valid_csv(checkpoint_dir: str, topks: Sequence[int]) -> CsvLogger:
    header = ["epoch", "time_sec", "lr"]
    for k in topks:
        header += [f"precision@{k}", f"recall@{k}", f"ndcg@{k}"]
    return CsvLogger(os.path.join(checkpoint_dir, "valid_epoch_metrics.csv"), header)


def _summary_writer_class():
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter


class TensorboardWriter:
    """Scalars under ``log_dir/<time>--<comment>``; a no-op when
    ``log_dir`` is None or no writer is installed."""

    def __init__(self, log_dir: Optional[str], comment: str = ""):
        self._w = None
        if log_dir is None:
            return
        writer = _summary_writer_class()
        if writer is None:
            return
        run_name = time.strftime("%m-%d-%Hh%Mm%Ss") + (f"--{comment}" if comment else "")
        self._w = writer(os.path.join(log_dir, run_name))

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def eval_metrics(self, metrics: Dict[str, float], topks, epoch: int) -> None:
        if self._w is None:
            return
        ks = list(topks)
        for k in ks:
            self._w.add_scalar(f"Test/Recall@{ks}/{k}", metrics[f"recall@{k}"], epoch)
            self._w.add_scalar(f"Test/Precision@{ks}/{k}", metrics[f"precision@{k}"], epoch)
            self._w.add_scalar(f"Test/NDCG@{ks}/{k}", metrics[f"ndcg@{k}"], epoch)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
