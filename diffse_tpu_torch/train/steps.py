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

``chain_steps`` and the device mesh (``mesh``, ``state_sharding``) are not
ported: the step raises on them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.profiler import record_function

from ..utils import float32_precision
from .state import TrainState


def _microbatches(batch, accum_steps: int):
    """``accum_steps`` batches from one with a leading microbatch axis."""
    if accum_steps == 1:
        return [batch]
    return [tuple(b[i] for b in batch) for i in range(accum_steps)]


def make_train_step(model, preprocess: Optional[Callable] = None, accum_steps: int = 1,
                    chain_steps: int = 1, mesh=None, state_sharding=None) -> Callable:
    """The train step of ``model`` (a ScoreModel): ``step(state, batch,
    generator) -> (state, {"train_loss": loss})``, which updates ``state`` (a
    ``TrainState`` over ``model.backbone``) in place and returns it.

    ``preprocess`` (e.g. ``model.prepare_batch``) runs first, inside the
    step; the EMA's decay is the state's. With ``accum_steps``
    > 1 the batch's arrays carry a leading microbatch axis ``(accum_steps,
    b, ...)``: each microbatch runs forward and backward in turn, drawing
    from ``generator`` one after the other, and the one update takes the
    average of their gradients; the loss is the average of theirs. The loss
    returned is a 0-d tensor on the model's device (nothing waits on it).
    """
    if chain_steps != 1:
        raise NotImplementedError("chain_steps is not ported (ROADMAP.md queue 1): one "
                                  "optimizer update per step")
    if mesh is not None or state_sharding is not None:
        raise NotImplementedError("the device mesh is not ported (ROADMAP.md queue 1): "
                                  "the step runs on one device")

    def step(state: TrainState, batch, generator: torch.Generator):
        loss_sum = None
        with float32_precision(model.device):
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
        return state, {"train_loss": loss_sum / accum_steps}

    return step


def make_eval_step(model, preprocess: Optional[Callable] = None) -> Callable:
    """The validation loss: ``step(variables, batch, generator) ->
    {"valid_loss": loss}`` under ``torch.no_grad()``, the backbone in eval
    mode, with ``variables`` (``state.eval_variables``; None for the module's
    own weights)."""

    @torch.no_grad()
    def step(variables: Optional[dict], batch, generator: torch.Generator):
        if preprocess is not None:
            batch = preprocess(batch)
        with float32_precision(model.device):
            loss = model.loss_fn(batch, generator, train=False, variables=variables)
        return {"valid_loss": loss}

    return step
