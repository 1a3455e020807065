"""The training loops (port of diffse_tpu/train/loop.py's ``train_score_model``
and ``train_snr_model``). The score model's:

  - epochs over the threaded DataLoader, one eager optimizer step per batch
    (``train/steps.py``), ``max_steps_per_epoch`` and ``log_every_n_steps``;
  - ``accum_steps`` consecutive batches stacked into one update
    (``_stack_groups``);
  - validation on the EMA weights every ``eval_every_n_epochs`` epochs (and
    on the last): the validation loss, ``evaluate_model`` (PESQ, SI-SDR,
    ESTOI over ``num_eval_files`` files) and every
    ``DEEP_INFERENCE_EVERY_EPOCH`` epochs the 9-SNR sweep
    (``deep_evaluate_model``), then a checkpoint ranked by its metrics;
  - ``resume`` from the latest checkpoint, continuing the epoch numbering;
  - SIGTERM: a checkpoint, then a clean return (``_PreemptionGuard``).

The enhancement metrics run with the EMA copied into the backbone's own
parameters (``state.ema_weights``), which get the trained weights back bit
for bit after; the programs they captured are dropped with their card
memory (``ScoreModel.drop_programs``).

Several ranks (a process group, ``parallel.initialize_distributed``): every
rank loads the same global batches; with ``use_mesh`` each takes its rows
over a data mesh (``_maybe_mesh``; ``tp_size`` > 1 a ``(data, model)`` mesh,
the state sharded over ``"model"``), else every rank runs the whole batch,
the same maths. ``chain_steps`` stacks that many consecutive batches into
one call of the step. Rank 0 alone logs and writes checkpoints (whole
tensors); every rank takes part in the collectives of a save. The
validation loss runs on every rank over the whole validation batches; the
enhancement metrics run on rank 0 alone (the others wait at the broadcast
of its numbers). The SIGTERM flag is all-reduced at each check, so one
signalled rank stops every rank at the same step. The loss's generator is
kept in the checkpoints: a resumed run draws on where the interrupted one
stopped.

``train_snr_model`` trains the SNR estimator the same way: one step per
batch, then each epoch the validation loss and ``snr_error`` on the EMA
weights over ``Specs_SNR``'s batches, a checkpoint ranked by ``snr_error``
(the lowest three kept), ``resume`` and the SIGTERM guard.
"""

from __future__ import annotations

import signal
from typing import Optional

import numpy as np
import torch

from ..evaluation.deep_inference import SNR_GRID, deep_evaluate_model
from ..evaluation.inference import dispatch_seed, evaluate_model
from ..parallel.mesh import (is_main_rank, make_mesh, replicate, shard_batch, world_collectives,
                             world_size)
from ..utils import float32_precision
from .checkpoints import CheckpointManager
from .logging import MetricsLogger
from .state import TrainState, ema_weights, eval_variables
from .steps import make_eval_step, make_train_step

DEEP_INFERENCE_EVERY_EPOCH = 10
# the deep sweep's metric names: the effective input SNR (model.py:449-477)
DEEP_LABELS = ["-5", "00", "05", "10", "15", "20", "25", "30", "35"]

SCORE_MONITORS = ({"monitor": "pesq", "mode": "max", "top_k": 10},
                  {"monitor": "si_sdr", "mode": "max", "top_k": 2})
SNR_MONITORS = ({"monitor": "snr_error", "mode": "min", "top_k": 3},)


def _maybe_mesh(use_mesh: bool, batch_size: int, tp_size: int = 1,
                device_type: Optional[str] = None):
    """A data-parallel mesh over the process group's ranks if asked for,
    there are several and the batch divides over them; ``tp_size`` > 1 a
    ``(data, model)`` mesh with ``tp_size`` ranks on ``"model"``. Otherwise
    None, with the JAX package's warning: every rank then runs the whole
    batch."""
    if not use_mesh:
        return None
    n = world_size()
    if n <= 1:
        return None
    if tp_size > 1:
        from ..parallel.model_sharding import make_2d_mesh

        if n % tp_size != 0:
            print(f"warning: {n} devices not divisible by tp_size {tp_size}; "
                  "running without sharding")
            return None
        n_data = n // tp_size
        if batch_size % n_data != 0:
            print(f"warning: batch_size {batch_size} not divisible by the "
                  f"{n_data}-way data axis; running without sharding")
            return None
        return make_2d_mesh(n_data, tp_size, device_type)
    if batch_size % n != 0:
        print(f"warning: batch_size {batch_size} not divisible by {n} devices; "
              "running without data-parallel sharding")
        return None
    return make_mesh(device_type)


def _train_state(model, module, mesh) -> TrainState:
    """The state of ``module`` laid out over ``mesh``: rank 0's weights on
    every rank first."""
    replicate(mesh, module)
    return TrainState(module, lr=model.cfg.lr, ema_decay=model.cfg.ema_decay, mesh=mesh)


class _PreemptionGuard:
    """While installed, SIGTERM sets a flag instead of killing the process;
    the loop checks it after each step, saves a checkpoint and returns, so
    that ``resume`` continues from it. Outside the main thread (where no
    handler can be installed) the loop runs unguarded. In a group of
    several ranks ``stop()`` all-reduces the flag: every rank calls it at the
    same points, and all stop when any was signalled, so that no rank waits
    in a collective for one that left."""

    def __init__(self):
        self.triggered = False
        self._prev = None
        self._installed = False
        self._coll = world_collectives()

    def stop(self) -> bool:
        """Whether to stop: this rank's flag, or any rank's."""
        if self._coll is None:
            return self.triggered
        stop = self._coll.any(self.triggered)
        if stop and not self.triggered:
            print("SIGTERM on another rank: coordinated stop")
        return stop

    def __enter__(self):
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
            self._installed = True
        except ValueError:
            self._installed = False
        return self

    def _on_signal(self, signum, frame):
        self.triggered = True

    def __exit__(self, *exc):
        if self._installed:
            # getsignal() gives None for a handler installed outside Python
            prev = self._prev if self._prev is not None else signal.SIG_DFL
            signal.signal(signal.SIGTERM, prev)
        return False


def _preempt_exit(ckpt_mgr: Optional[CheckpointManager], state: TrainState,
                  epoch: int) -> TrainState:
    """After SIGTERM: a checkpoint of ``state`` under ``epoch`` (no metrics)
    when there is a manager; returns ``state``."""
    if ckpt_mgr is not None:
        print(f"SIGTERM: checkpointing at step {state.step} and exiting (resume with --resume)")
        ckpt_mgr.save(epoch, state, {})
    else:
        print(f"SIGTERM: exiting at step {state.step} (no --ckpt_dir, nothing checkpointed)")
    return state


def _log_record(epoch: int, metrics: dict) -> dict:
    """A step's log line: the loss and, for chained updates, their mean
    ("train_loss" is the last of them)."""
    rec = {"epoch": epoch, "train_loss": metrics["train_loss"]}
    if "train_loss_mean" in metrics:
        rec["train_loss_mean"] = metrics["train_loss_mean"]
    return rec


def _stack_groups(loader, k: int):
    """Group k consecutive loader batches into one with a leading microbatch
    axis (k, b, ...) for gradient accumulation. A trailing group that is
    incomplete or ragged (the epoch's short last batch) is dropped."""
    buf = []
    for b in loader:
        buf.append(b)
        if len(buf) == k:
            uniform = all(np.shape(bb[i]) == np.shape(buf[0][i])
                          for bb in buf for i in range(len(buf[0])))
            if uniform:
                yield tuple(np.stack([np.asarray(bb[i]) for bb in buf])
                            for i in range(len(buf[0])))
            buf = []


def eval_model_type(snr_conditioned: str, model_type: str) -> str:
    """(snr_conditioned, model_type) -> the evaluation's branch name."""
    if snr_conditioned == "false":
        return model_type
    if snr_conditioned == "fixed":
        return f"{model_type}_fixed"
    if snr_conditioned == "true":
        return f"{model_type}_snr"
    raise ValueError(snr_conditioned)


def _enhancement_metrics(model, state: TrainState, data_module, mt: str, epoch: int, seed: int,
                         eval_batch_size: int) -> dict:
    """One validation's PESQ, SI-SDR and ESTOI (and, every
    ``DEEP_INFERENCE_EVERY_EPOCH`` epochs, the deep sweep's 27), enhanced
    with the EMA weights; {} when ``num_eval_files`` is 0 or an ``_snr``
    branch has no SNRNet."""
    cfg = model.cfg
    if cfg.num_eval_files == 0:
        return {}
    if mt.endswith("_snr") and model.snr_model is None:
        # the reference loads the SNR estimator's checkpoint at import
        # (model.py:25-30); here it must be given (--snr_ckpt)
        print("warning: snr_conditioned='true' but no snr_model injected; "
              "skipping speech-enhancement validation metrics")
        return {}
    metrics = {}
    coll = world_collectives()
    with ema_weights(state):
        if not is_main_rank():
            return coll.broadcast_object(None)
        try:
            pesq_v, si_sdr_v, estoi_v = evaluate_model(
                model, data_module, cfg.num_eval_files, model_type=mt, fixed_snr=cfg.fixed_snr,
                seed=dispatch_seed(seed, 2 * epoch), batch_size=eval_batch_size)
            metrics.update({"pesq": pesq_v, "si_sdr": si_sdr_v, "estoi": estoi_v})
            if (cfg.snr_conditioned != "fixed" and epoch % DEEP_INFERENCE_EVERY_EPOCH == 0
                    and epoch >= DEEP_INFERENCE_EVERY_EPOCH):
                vals = deep_evaluate_model(model, data_module, cfg.num_eval_files, model_type=mt,
                                           fixed_snr=cfg.fixed_snr,
                                           seed=dispatch_seed(seed, 2 * epoch + 1))
                n = len(SNR_GRID)
                for j, label in enumerate(DEEP_LABELS):
                    metrics[f"si_sdr_{label}"] = vals[j]
                    metrics[f"pesq_{label}"] = vals[n + j]
                    metrics[f"estoi_{label}"] = vals[2 * n + j]
        finally:
            model.drop_programs()
    return metrics if coll is None else coll.broadcast_object(metrics)


def train_score_model(model, data_module, max_epochs: int = 1, ckpt_dir: Optional[str] = None,
                      logger: Optional[MetricsLogger] = None, seed: int = 0,
                      log_every_n_steps: int = 10, resume: bool = False,
                      max_steps_per_epoch: Optional[int] = None, variables: Optional[dict] = None,
                      accum_steps: int = 1, eval_every_n_epochs: int = 1, chain_steps: int = 1,
                      tp_size: int = 1, eval_batch_size: int = 1,
                      use_mesh: bool = True) -> TrainState:
    """Train ``model`` (a ScoreModel) on ``data_module``'s batches; returns
    the final ``TrainState``.

    ``variables``: a state_dict to start the backbone from (default: its
    weights as constructed). ``seed`` seeds the loss's draws (a generator on
    the model's device) and the enhancement metrics' (epoch ``e``'s
    ``evaluate_model`` under ``dispatch_seed(seed, 2 e)``, its deep sweep
    under ``dispatch_seed(seed, 2 e + 1)``). ``accum_steps`` > 1 averages
    the gradients of that many consecutive batches into each update;
    ``chain_steps`` > 1 runs that many consecutive updates per call of the
    step (``max_steps_per_epoch`` and ``log_every_n_steps`` then count
    calls). ``eval_every_n_epochs`` runs validation and the checkpoint only
    every k-th epoch, and always on the last; ``eval_batch_size`` > 1
    enhances the validation files in bucketed batches. The checkpoint keys
    are epochs, and a resumed run goes on from the latest one's next epoch,
    so that keys keep increasing. ``use_mesh`` and ``tp_size``: the data
    (and model) mesh over the process group's ranks (``_maybe_mesh``).
    """
    cfg = model.cfg
    logger = logger or MetricsLogger()
    data_module.setup("fit")
    if variables is not None:
        model.backbone.load_state_dict(variables)
    mesh = _maybe_mesh(use_mesh, data_module.cfg.batch_size, tp_size, model.device.type)
    state = _train_state(model, model.backbone, mesh)
    train_step = make_train_step(model, preprocess=model.prepare_batch, accum_steps=accum_steps,
                                 chain_steps=chain_steps, mesh=mesh)
    valid_step = make_eval_step(model, preprocess=model.prepare_batch)
    generator = torch.Generator(model.device).manual_seed(seed)
    state.generator = generator
    mt = eval_model_type(cfg.snr_conditioned, cfg.model_type)

    ckpt_mgr, start_epoch = None, 0
    if ckpt_dir:
        ckpt_mgr = CheckpointManager(ckpt_dir, monitors=SCORE_MONITORS, hparams=model.hparams)
        if resume and ckpt_mgr.latest_step() is not None:
            ckpt_mgr.restore(state)
            start_epoch = ckpt_mgr.latest_step() + 1

    lead_axes = int(chain_steps > 1) + int(accum_steps > 1)
    warned_empty_epoch = False
    with _PreemptionGuard() as guard:
        for epoch in range(start_epoch, max_epochs):
            loader = data_module.train_dataloader()
            if accum_steps > 1:
                loader = _stack_groups(loader, accum_steps)
            if chain_steps > 1:
                loader = _stack_groups(loader, chain_steps)
            stepped = False
            for i, batch in enumerate(loader):
                if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                    break
                stepped = True
                state, metrics = train_step(state, shard_batch(mesh, batch, lead_axes), generator)
                if guard.stop():
                    return _preempt_exit(ckpt_mgr, state, epoch)
                if i % log_every_n_steps == 0:
                    logger.log(_log_record(epoch, metrics), step=state.step)
            if not stepped and not warned_empty_epoch:
                warned_empty_epoch = True
                print(f"warning: epoch {epoch} produced no training steps: the dataset yields "
                      f"fewer than accum_steps*chain_steps (= {accum_steps * chain_steps}) "
                      "batches per epoch")
            if guard.stop():  # SIGTERM while the batches were fetched
                return _preempt_exit(ckpt_mgr, state, epoch)

            if (epoch + 1) % eval_every_n_epochs != 0 and epoch != max_epochs - 1:
                continue  # off-cadence epoch: no validation, no save

            ev = eval_variables(state)
            val_losses = [float(valid_step(ev, batch, generator)["valid_loss"])
                          for batch in data_module.val_dataloader()]
            epoch_metrics = {"valid_loss": float(np.mean(val_losses))} if val_losses else {}
            epoch_metrics.update(_enhancement_metrics(model, state, data_module, mt, epoch, seed,
                                                      eval_batch_size))
            sanitized = {k: v for k, v in epoch_metrics.items() if np.isfinite(v)}
            logger.log({"epoch": epoch, **sanitized}, step=state.step)
            if ckpt_mgr is not None:
                ckpt_mgr.save(epoch, state, sanitized)
            if guard.stop():
                print(f"SIGTERM during validation: exiting after the epoch-{epoch} checkpoint "
                      "(resume with --resume)")
                return state

    if ckpt_mgr is not None:
        logger.log_artifact(ckpt_dir, name="score_model")
    return state


def train_snr_model(model, data_module, max_epochs: int = 1, ckpt_dir: Optional[str] = None,
                    logger: Optional[MetricsLogger] = None, seed: int = 0,
                    log_every_n_steps: int = 10, resume: bool = False,
                    max_steps_per_epoch: Optional[int] = None,
                    variables: Optional[dict] = None, use_mesh: bool = True) -> TrainState:
    """Train ``model`` (an SNRModel) on ``data_module``'s batches; returns the
    final ``TrainState`` of its SNRNet.

    ``variables``: a state_dict to start SNRNet from (default: its weights
    as constructed). ``seed`` seeds the loss's target draws (a generator on
    the model's device). Each epoch ends with ``valid_loss`` and
    ``snr_error`` averaged over ``val_dataloader()``'s ``(x, y, s, n)``
    batches, computed with the EMA in SNRNet's own parameters (the trained
    weights copied back after), and a checkpoint keyed by the epoch; a
    resumed run goes on from the latest one's next epoch. ``use_mesh``: a
    data mesh over the process group's ranks (``_maybe_mesh``), as
    ``train_score_model``."""
    logger = logger or MetricsLogger()
    data_module.setup("fit")
    if variables is not None:
        model.dnn.load_state_dict(variables)
    mesh = _maybe_mesh(use_mesh, data_module.cfg.batch_size, device_type=model.device.type)
    state = _train_state(model, model.dnn, mesh)
    train_step = make_train_step(model, preprocess=model.prepare_batch, mesh=mesh)
    generator = torch.Generator(model.device).manual_seed(seed)
    state.generator = generator

    ckpt_mgr, start_epoch = None, 0
    if ckpt_dir:
        ckpt_mgr = CheckpointManager(ckpt_dir, monitors=SNR_MONITORS, hparams=model.hparams)
        if resume and ckpt_mgr.latest_step() is not None:
            ckpt_mgr.restore(state)
            start_epoch = ckpt_mgr.latest_step() + 1

    with _PreemptionGuard() as guard:
        for epoch in range(start_epoch, max_epochs):
            for i, batch in enumerate(data_module.train_dataloader()):
                if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                    break
                state, metrics = train_step(state, shard_batch(mesh, batch), generator)
                if guard.stop():
                    return _preempt_exit(ckpt_mgr, state, epoch)
                if i % log_every_n_steps == 0:
                    logger.log({"epoch": epoch, "train_loss": metrics["train_loss"]},
                               step=state.step)
            if guard.stop():
                return _preempt_exit(ckpt_mgr, state, epoch)

            accum = {"valid_loss": [], "snr_error": []}
            with ema_weights(state), torch.no_grad(), float32_precision(model.device):
                for batch in data_module.val_dataloader():
                    m = model.valid_metrics(model.prepare_batch(batch))
                    for k in accum:
                        accum[k].append(float(m[k]))
            epoch_metrics = {k: float(np.mean(v)) for k, v in accum.items() if v}
            logger.log({"epoch": epoch, **epoch_metrics}, step=state.step)
            if ckpt_mgr is not None:
                ckpt_mgr.save(epoch, state, epoch_metrics)
            if guard.stop():
                print(f"SIGTERM during validation: exiting after the epoch-{epoch} checkpoint "
                      "(resume with --resume)")
                return state

    if ckpt_mgr is not None:
        logger.log_artifact(ckpt_dir, name="snr_model")
    return state
