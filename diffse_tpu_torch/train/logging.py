"""Metric logging: JSONL and stdout, optionally wandb (port of
diffse_tpu/train/logging.py).

One JSON object per ``log`` call, with the JAX package's metric names
(train_loss, valid_loss, pesq, si_sdr, estoi, ...), appended to
``<log_dir>/metrics.jsonl``. With ``use_wandb`` the metrics go to wandb too,
and ``log_artifact`` uploads the checkpoint directory at the end of training;
without the ``wandb`` package ``use_wandb`` raises. In a process group of
several ranks (joined before the logger is built) rank 0 alone logs: on the
others the logger opens nothing and logs nothing.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from ..parallel.mesh import is_main_rank


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "diffse_tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        self._file = None
        self._main = is_main_rank()
        if log_dir and self._main:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb and self._main:
            try:
                import wandb
            except ImportError as e:
                raise ImportError("use_wandb (--wandb) needs the wandb package") from e
            self._wandb = wandb
            wandb.init(project=project, name=run_name, config=config or {})

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        """Print and append one record: the time, ``step`` and ``metrics``
        (each a number or a 0-d tensor, read as a float)."""
        if not self._main:
            return
        record = {"ts": time.time()}
        if step is not None:
            record["step"] = int(step)
        record.update({k: float(v) for k, v in metrics.items()})
        line = json.dumps(record)
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log({k: record[k] for k in metrics}, step=step)

    def log_artifact(self, path: str, name: str = "model", type: str = "model") -> None:
        """Upload a file or directory as a wandb Artifact; nothing without an
        active wandb run."""
        if not (self._wandb and getattr(self._wandb, "run", None)):
            return
        try:
            art = self._wandb.Artifact(name, type=type)
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(path)
            self._wandb.run.log_artifact(art)
        except Exception as e:
            print(f"wandb artifact upload failed: {e}", file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
