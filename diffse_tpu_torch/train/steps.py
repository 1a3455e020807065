"""Train and eval steps (port of diffse_tpu/train/steps.py).

One optimizer step: ``prepare_batch`` -> ``loss_fn`` -> backward -> Adam ->
the EMA lerp, eagerly, op by op (the JAX package runs it as one XLA
program). The network's forward runs the hand kernels; their backward
recomputes the plain versions (``ops.cuda_kernels``' differentiable ops).
cuDNN's convolutions and CUDA's matmuls run in float32 through the step,
forward and backward, whatever the process-wide TF32 setting. The step's
parts are marked for the profiler ("train_step: forward", "... backward",
"... Adam + EMA"), and within the backward each op's recompute
(``cuda_kernels``).

``chain_steps`` runs that many updates in one call, and over a device mesh
(``parallel``) each rank takes its rows of the global batch: its draws are
the global batch's rows (``parallel.mesh.batch_shard``), its gradients are
reduced over the ranks once per update (``TrainState.apply_gradients``) and
the loss reported is the mean over the ranks. The backbone is not wrapped
in ``DistributedDataParallel``, whose ``module.`` prefix would change the
state_dict that checkpoints and the weight bridge read.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.profiler import record_function

from ..parallel.mesh import Collectives, batch_shard
from ..utils import float32_precision
from .state import TrainState


def _microbatches(batch, accum_steps: int):
    """``accum_steps`` batches from one with a leading microbatch axis."""
    if accum_steps == 1:
        return [batch]
    return [tuple(b[i] for b in batch) for i in range(accum_steps)]


def _check_layout(state: TrainState, mesh, state_sharding) -> None:
    if state.mesh is not mesh:
        raise ValueError("the state is laid out over another mesh than the step's: build it "
                         "with TrainState(module, mesh=mesh) or parallel.shard_state")
    if state_sharding is not None:
        from ..parallel.model_sharding import tree_shardings

        if tree_shardings(mesh, state.module) != dict(state_sharding):
            raise ValueError("state_sharding is not the layout of the state's mesh")


def make_train_step(model, preprocess: Optional[Callable] = None, accum_steps: int = 1,
                    chain_steps: int = 1, mesh=None, state_sharding=None) -> Callable:
    """The train step of ``model`` (a ScoreModel or SNRModel): ``step(state,
    batch, generator) -> (state, {"train_loss": loss})``, which updates
    ``state`` (a ``TrainState`` over ``model``'s network) in place and
    returns it.

    ``preprocess`` (e.g. ``model.prepare_batch``) runs first, inside the
    step; the EMA's decay is the state's. With ``accum_steps``
    > 1 the batch's arrays carry a leading microbatch axis ``(accum_steps,
    b, ...)``: each microbatch runs forward and backward in turn, drawing
    from ``generator`` one after the other, and the one update takes the
    average of their gradients; the loss is the average of theirs. The loss
    returned is a 0-d tensor on the model's device (nothing waits on it).

    ``chain_steps`` > 1 runs that many full updates per call: the batch's
    arrays carry an outer axis ``(chain_steps, [accum_steps,] b, ...)``,
    update ``c`` takes entry ``c`` and its draws from ``generator`` after
    update ``c - 1``'s, so the call equals that many single steps;
    ``"train_loss"`` is the last update's loss and ``"train_loss_mean"`` the
    mean of theirs.

    ``mesh`` (a ``parallel`` mesh; ``state`` laid out over it): ``batch`` is
    this rank's rows of the global batch (``parallel.shard_batch`` of it
    over ``"data"``, at the axis after the leading ones); the update is the
    one-device step's on the global batch. ``state_sharding``
    (``parallel.state_shardings(mesh, module)``), when given, must be the
    state's layout.
    """
    if state_sharding is not None and mesh is None:
        raise ValueError("state_sharding needs its mesh")
    loss_mean = Collectives().mean if mesh is not None else None

    def update(state: TrainState, batch, generator: torch.Generator):
        loss_sum = None
        with float32_precision(model.device), batch_shard(mesh):
            for mb in _microbatches(batch, accum_steps):
                with record_function("train_step: forward"):
                    if preprocess is not None:
                        mb = preprocess(mb)
                    loss = model.loss_fn(mb, generator, train=True)
                with record_function("train_step: backward"):
                    (loss / accum_steps).backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            with record_function("train_step: Adam + EMA"):
                state.apply_gradients()
        loss = loss_sum / accum_steps
        return loss if loss_mean is None else loss_mean(loss)

    def step(state: TrainState, batch, generator: torch.Generator):
        if mesh is not None or state.mesh is not None:
            _check_layout(state, mesh, state_sharding)
        if chain_steps == 1:
            return state, {"train_loss": update(state, batch, generator)}
        losses = [update(state, tuple(b[c] for b in batch), generator)
                  for c in range(chain_steps)]
        # "train_loss" stays the last update's, so that chained logging reads
        # like per-step logging at the same step count
        return state, {"train_loss": losses[-1], "train_loss_mean": torch.stack(losses).mean()}

    return step


def make_eval_step(model, preprocess: Optional[Callable] = None, mesh=None) -> Callable:
    """The validation loss: ``step(variables, batch, generator) ->
    {"valid_loss": loss}`` under ``torch.no_grad()``, the backbone in eval
    mode, with ``variables`` (``state.eval_variables``; None for the module's
    own weights). With ``mesh``, ``batch`` is this rank's rows of the
    global batch and the loss the global batch's (the mean over the ranks)."""
    loss_mean = Collectives().mean if mesh is not None else None

    @torch.no_grad()
    def step(variables: Optional[dict], batch, generator: torch.Generator):
        if preprocess is not None:
            batch = preprocess(batch)
        with float32_precision(model.device), batch_shard(mesh):
            loss = model.loss_fn(batch, generator, train=False, variables=variables)
        return {"valid_loss": loss if loss_mean is None else loss_mean(loss)}

    return step
