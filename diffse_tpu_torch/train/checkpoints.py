"""Metric-ranked checkpointing over ``torch.save`` (port of
diffse_tpu/train/checkpoints.py, which saves with orbax).

Keeps ``last`` plus the top-k steps of each monitored metric (the score
model: top 10 by ``pesq`` and top 2 by ``si_sdr``; the SNR estimator: top 3
by ``snr_error``, lowest first). A step is one directory ``step_<k>`` holding
``state.pt`` (``TrainState.state_dict()``: the step count, the parameters,
the EMA and Adam's state). The directory is written under a temporary name
and renamed when complete, then ``metadata.json`` (each step's metrics) is
rewritten; a manager that finds an entry whose directory is missing (a
process that died mid-save) drops it and falls back to the newest complete
step. ``hparams.json`` keeps the model's hyperparameters. These are the
port's own files: the JAX package's orbax checkpoints do not load here, and
a reference Lightning ``.ckpt`` becomes one through
``cli.convert_torch_checkpoint``.

In a group of several ranks every rank calls ``save`` (the state is
gathered whole, a collective under tensor parallelism) and rank 0 alone
writes, whole tensors, so a checkpoint does not depend on the layout that
saved it; every rank keeps the same metadata, and every rank restores and
keeps its own part.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel.mesh import is_main_rank, world_size

STATE_FILE = "state.pt"


class CheckpointManager:
    """Keeps ``last`` plus the top-k steps for each monitored metric."""

    def __init__(self, directory: str,
                 monitors: Sequence[dict] = ({"monitor": "pesq", "mode": "max", "top_k": 10},
                                             {"monitor": "si_sdr", "mode": "max", "top_k": 2}),
                 save_last: bool = True, hparams: Optional[dict] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.monitors = list(monitors)
        self.save_last = save_last
        self._meta_path = os.path.join(self.directory, "metadata.json")
        self._meta: Dict[str, dict] = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)
            # an entry whose directory was never committed (the process died
            # during the save) names no checkpoint: drop it
            for k in [k for k in self._meta if not os.path.isdir(self._step_dir(int(k)))]:
                del self._meta[k]
        self.writes = is_main_rank()
        if hparams is not None and self.writes:
            with open(os.path.join(self.directory, "hparams.json"), "w") as f:
                json.dump(hparams, f, indent=2, default=str)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        return sorted(int(k) for k in self._meta)

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        """Save ``state`` (a ``TrainState``) as ``step`` with its
        ``metrics``, then prune what no monitor keeps."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        whole = state.state_dict()
        if self.writes:
            path = self._step_dir(step)
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(whole, os.path.join(tmp, STATE_FILE))
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
        self._meta[str(step)] = metrics
        self._prune()
        if self.writes:
            with open(self._meta_path, "w") as f:
                json.dump(self._meta, f, indent=2)
        if world_size() > 1:
            dist.barrier()  # the files are there before any rank goes on

    def _retained_steps(self) -> set:
        steps = self.all_steps()
        keep = {steps[-1]} if steps and self.save_last else set()
        for mon in self.monitors:
            name, mode, top_k = mon["monitor"], mon["mode"], mon["top_k"]
            scored = [(s, self._meta[str(s)][name]) for s in steps if name in self._meta[str(s)]]
            scored.sort(key=lambda kv: kv[1], reverse=(mode == "max"))
            keep |= {s for s, _ in scored[:top_k]}
        return keep

    def _prune(self) -> None:
        keep = self._retained_steps()
        for s in self.all_steps():
            if s not in keep:
                if self.writes:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
                del self._meta[str(s)]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self, monitor: str, mode: str = "max") -> Optional[int]:
        scored = [(s, self._meta[str(s)][monitor]) for s in self.all_steps()
                  if monitor in self._meta[str(s)]]
        if not scored:
            return None
        scored.sort(key=lambda kv: kv[1], reverse=(mode == "max"))
        return scored[0][0]

    def load(self, step: Optional[int] = None, map_location=None) -> dict:
        """The saved ``TrainState.state_dict()`` of ``step`` (the latest when
        None), its tensors on ``map_location`` (their saved device when
        None)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location=map_location, weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (the latest when None) into ``state`` (a
        ``TrainState`` of the same model, of any layout), in place; returns
        it."""
        device = next(state.module.parameters()).device
        state.load_state_dict(self.load(step, map_location=device))
        return state

    def load_hparams(self) -> Optional[dict]:
        path = os.path.join(self.directory, "hparams.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
