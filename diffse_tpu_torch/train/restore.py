"""Loading a trained score model from a checkpoint directory (port of
diffse_tpu/train/restore.py's ``load_score_model``): the model rebuilt from
``hparams.json`` with any config overrides, and its ``TrainState``
(parameters, EMA, Adam state, step) restored from the port's checkpoint."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.score_model import ScoreModel
from .checkpoints import CheckpointManager
from .state import TrainState


def load_score_model(ckpt_dir: str, step: Optional[int] = None, monitor: Optional[str] = None,
                     mode: str = "max", snr_model: Optional[torch.nn.Module] = None,
                     device="cuda", **config_overrides) -> Tuple[ScoreModel, TrainState]:
    """The ScoreModel and TrainState of ``step``: the best by ``monitor``
    (``mode`` "max" or "min") when given, else the latest. ``config_overrides``
    go over the stored config; ``device`` as for ``ScoreModel``. Evaluate
    with ``eval_variables(state)`` (the EMA weights) or load them into the
    backbone."""
    mgr = CheckpointManager(ckpt_dir)
    hparams = mgr.load_hparams()
    if hparams is None:
        raise FileNotFoundError(f"no hparams.json in {ckpt_dir}")
    model = ScoreModel.from_hparams(hparams, snr_model=snr_model, device=device,
                                    **config_overrides)
    if step is None and monitor is not None:
        step = mgr.best_step(monitor, mode=mode)
    state = TrainState(model.backbone, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay)
    return model, mgr.restore(state, step=step)
