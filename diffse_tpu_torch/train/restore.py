"""Loading a trained model from a checkpoint directory (port of
diffse_tpu/train/restore.py): the model rebuilt from ``hparams.json`` with
any config overrides, and its ``TrainState`` (parameters, EMA, Adam state,
step) restored from the port's checkpoint."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.score_model import ScoreModel
from ..models.snr_model import SNRModel
from .checkpoints import CheckpointManager
from .state import TrainState


def _manager(ckpt_dir: str) -> Tuple[CheckpointManager, dict]:
    mgr = CheckpointManager(ckpt_dir)
    hparams = mgr.load_hparams()
    if hparams is None:
        raise FileNotFoundError(f"no hparams.json in {ckpt_dir}")
    return mgr, hparams


def _restore(mgr: CheckpointManager, state: TrainState, step: Optional[int],
             monitor: Optional[str], mode: str) -> TrainState:
    if step is None and monitor is not None:
        step = mgr.best_step(monitor, mode=mode)
    return mgr.restore(state, step=step)


def load_score_model(ckpt_dir: str, step: Optional[int] = None, monitor: Optional[str] = None,
                     mode: str = "max", snr_model: Optional[torch.nn.Module] = None,
                     device="cuda", **config_overrides) -> Tuple[ScoreModel, TrainState]:
    """The ScoreModel and TrainState of ``step``: the best by ``monitor``
    (``mode`` "max" or "min") when given, else the latest. ``config_overrides``
    go over the stored config; ``device`` as for ``ScoreModel``. Evaluate
    with ``eval_variables(state)`` (the EMA weights) or load them into the
    backbone."""
    mgr, hparams = _manager(ckpt_dir)
    model = ScoreModel.from_hparams(hparams, snr_model=snr_model, device=device,
                                    **config_overrides)
    state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    return model, _restore(mgr, state, step, monitor, mode)


def load_snr_model(ckpt_dir: str, step: Optional[int] = None,
                   monitor: Optional[str] = "snr_error", mode: str = "min", device="cuda",
                   **config_overrides) -> Tuple[SNRModel, TrainState]:
    """The SNRModel and the TrainState of its SNRNet: ``step``, else the best
    by ``monitor`` (lowest ``snr_error`` by default), and the latest step
    when picking by the monitor fails, as the JAX package does."""
    mgr, hparams = _manager(ckpt_dir)
    model = SNRModel.from_hparams(hparams, device=device, **config_overrides)
    state = TrainState(model.dnn, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    try:
        state = _restore(mgr, state, step, monitor, mode)
    except (OSError, KeyError):  # the monitor's step cannot be read: the latest
        state = _restore(mgr, state, step, None, mode)
    return model, state
