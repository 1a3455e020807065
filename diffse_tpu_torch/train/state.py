"""Training state: the module, Adam, the EMA shadow and the step count (port
of diffse_tpu/train/state.py).

The JAX package keeps parameters, EMA and optimizer state in one immutable
pytree that its jitted step returns anew; here they are the module's own
parameters, updated in place by ``torch.optim.Adam`` (betas 0.9/0.999, eps
1e-8: ``optax.adam``'s defaults and the same update), and an EMA shadow of
every parameter that requires grad (the frozen Fourier-feature ``W`` is
neither optimised nor averaged; it never changes in either package).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch


def ema_decay_schedule(decay: float, num_updates: int) -> np.float32:
    """torch_ema's warm-up with use_num_updates: ``min(decay, (1 + n) / (10 +
    n))``, in float32 as the JAX package computes it."""
    n = np.float32(num_updates)
    return np.minimum(np.float32(decay), (np.float32(1) + n) / (np.float32(10) + n))


class TrainState:
    """``module``'s trainable parameters with their Adam state and EMA shadow.

    Args:
        module: the network (a ScoreModel's backbone); its parameters are
            updated in place.
        lr: Adam's learning rate.
        ema_decay: the EMA's decay (warmed up by ``ema_decay_schedule``).
    """

    def __init__(self, module: torch.nn.Module, lr: float = 1e-4, ema_decay: float = 0.999):
        self.module = module
        self.ema_decay = ema_decay
        self.names = [name for name, p in module.named_parameters() if p.requires_grad]
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        # a copy of its own: clone keeps each parameter's strides (the fused
        # convs' weights live in HWIO memory)
        self.ema = [p.detach().clone() for p in self.params]
        self.step = 0

    def apply_gradients(self, grads: Optional[list] = None) -> None:
        """One update from the gradients in the parameters' ``.grad`` (or
        ``grads``, one per parameter of ``self.params``): Adam, then the EMA
        ``e * d + (1 - d) * p`` with ``d = ema_decay_schedule(ema_decay, step +
        1)`` on the new parameters, and the step count. The gradients are
        cleared after."""
        if grads is not None:
            for p, g in zip(self.params, grads):
                p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        decay = ema_decay_schedule(self.ema_decay, self.step + 1)
        with torch.no_grad():
            torch._foreach_mul_(self.ema, float(decay))
            torch._foreach_add_(self.ema, self.params, alpha=float(np.float32(1) - decay))
        self.step += 1

    def state_dict(self) -> dict:
        """Everything a checkpoint keeps: the step, the module's state_dict,
        the EMA by parameter name and Adam's state."""
        return {"step": self.step, "params": self.module.state_dict(),
                "ema": dict(zip(self.names, self.ema)), "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output, in place."""
        self.module.load_state_dict(state["params"])
        with torch.no_grad():
            for name, e in zip(self.names, self.ema):
                e.copy_(state["ema"][name])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def eval_variables(state: TrainState, no_ema: bool = False) -> dict:
    """The variables to evaluate with, by name (for ``ScoreModel.forward``'s
    ``variables``): the EMA weights in place of the trained ones by default,
    the module's own with ``no_ema``; buffers and frozen parameters as they
    are."""
    variables = dict(state.module.named_parameters())
    variables.update(state.module.named_buffers())
    if not no_ema:
        variables.update(zip(state.names, state.ema))
    return variables


def load_ema(state: TrainState) -> None:
    """Copy the EMA into the module's own parameters (to evaluate or serve a
    restored checkpoint, which is not trained further)."""
    with torch.no_grad():
        torch._foreach_copy_(state.params, state.ema)


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The EMA in the module's own parameters inside the block, the trained
    weights copied back bit for bit after it. Each copy advances the
    parameters' ``_version``, so a program captured on the EMA weights
    (``ScoreModel._params_key``) never replays on the trained ones."""
    with torch.no_grad():
        trained = [p.detach().clone() for p in state.params]
        torch._foreach_copy_(state.params, state.ema)
    try:
        yield state.module
    finally:
        with torch.no_grad():
            torch._foreach_copy_(state.params, trained)
