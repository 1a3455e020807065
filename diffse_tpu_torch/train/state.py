"""Training state: the module, Adam, the EMA shadow and the step count (port
of diffse_tpu/train/state.py).

The JAX package keeps parameters, EMA and optimizer state in one immutable
pytree that its jitted step returns anew; here they are the module's own
parameters, updated in place by ``torch.optim.Adam`` (betas 0.9/0.999, eps
1e-8: ``optax.adam``'s defaults and the same update), and an EMA shadow of
every parameter that requires grad (the frozen Fourier-feature ``W`` is
neither optimised nor averaged; it never changes in either package).

Over a device mesh (``parallel``) the state is laid out as the JAX package
lays it out: replicated over a 1-D ``"data"`` mesh, and over a ``(data,
model)`` mesh each rank keeping its shard of the sharded parameters'
training state (``parallel.model_sharding``). The module's parameters stay
whole on every rank; what Adam updates (``local``) is each one's local part,
a view of it. ``apply_gradients`` reduces the gradients over the mesh first.
Whatever leaves the state (``state_dict``, ``whole_ema``, ``eval_variables``,
``ema_weights``) is whole, gathered over ``"model"``: a collective that every
rank calls.
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
        mesh: the device mesh the state is laid out over (module docstring);
            None on one device.
    """

    def __init__(self, module: torch.nn.Module, lr: float = 1e-4, ema_decay: float = 0.999,
                 mesh=None):
        self.module = module
        self.lr = lr
        self.ema_decay = ema_decay
        self.names = [name for name, p in module.named_parameters() if p.requires_grad]
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.step = 0
        # the gradients of the last update, as reduced (a check's, when set)
        self.keep_gradients = False
        self.last_grads = None
        # the loss's generator, when set: checkpointed with the state, so
        # that a resumed run draws on where the interrupted one stopped
        self.generator: Optional[torch.Generator] = None
        self.shard(mesh)

    def shard(self, mesh) -> None:
        """Lay the state out over ``mesh`` (None: one device), keeping the
        step count, the weights, the EMA and Adam's state (the moments of a
        state that was stepped carry over whole)."""
        whole = self.state_dict() if hasattr(self, "optimizer") else None
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            from ..parallel.model_sharding import StateLayout

            self.layout = StateLayout(mesh, self.module, self.names, self.params)
        # what Adam updates: each parameter's local part (a view of it)
        self.local = [self._local(i, p.detach()) if self.layout else p
                      for i, p in enumerate(self.params)]
        self.optimizer = torch.optim.Adam(self.local, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        # a copy of its own: clone keeps each parameter's strides (the fused
        # convs' weights live in HWIO memory)
        self.ema = [t.detach().clone() for t in self.local]
        if whole is not None:
            self.load_state_dict(whole)

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return self.layout.local(i, t) if self.layout else t

    def _whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        return self.layout.whole(i, t) if self.layout else t

    def apply_gradients(self, grads: Optional[list] = None) -> None:
        """One update from the gradients in the parameters' ``.grad`` (or
        ``grads``, one per parameter of ``self.params``), over a mesh first
        reduced to their mean over the ranks (the local part's where
        sharded): Adam, then the EMA ``e * d + (1 - d) * p`` with ``d =
        ema_decay_schedule(ema_decay, step + 1)`` on the new parameters, the
        sharded parameters gathered whole again, and the step count. The
        gradients are cleared after."""
        if grads is None:
            grads = [p.grad for p in self.params]
        if self.layout is not None:
            grads = self.layout.reduce_gradients(grads)
        for t, g in zip(self.local, grads):
            t.grad = g
        if self.keep_gradients:
            self.last_grads = list(grads)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None
        decay = ema_decay_schedule(self.ema_decay, self.step + 1)
        with torch.no_grad():
            torch._foreach_mul_(self.ema, float(decay))
            torch._foreach_add_(self.ema, self.local, alpha=float(np.float32(1) - decay))
        if self.layout is not None:
            self.layout.gather_params()
        self.step += 1

    def whole_ema(self) -> list:
        """The EMA of every parameter of ``self.params``, whole."""
        return [self._whole(i, e) for i, e in enumerate(self.ema)]

    def state_dict(self) -> dict:
        """Everything a checkpoint keeps, whole whatever the layout: the
        step, the module's state_dict, the EMA by parameter name, Adam's
        state and, when the state has one, the generator's state."""
        opt = self.optimizer.state_dict()
        if self.layout is not None:
            opt["state"] = {i: {k: self._whole(i, v) if torch.is_tensor(v) and v.dim() else v
                                for k, v in st.items()} for i, st in opt["state"].items()}
        out = {"step": self.step, "params": self.module.state_dict(),
               "ema": dict(zip(self.names, self.whole_ema())), "opt_state": opt}
        if self.generator is not None:
            out["generator"] = self.generator.get_state()
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output (of any layout), in place, each
        rank keeping its part."""
        self.module.load_state_dict(state["params"])
        with torch.no_grad():
            for i, (name, e) in enumerate(zip(self.names, self.ema)):
                e.copy_(self._local(i, state["ema"][name].to(e.device)))
        opt = state["opt_state"]
        if self.layout is not None:
            opt = {**opt, "state": {
                int(i): {k: self._local(int(i), v).clone() if torch.is_tensor(v) and v.dim()
                         else v for k, v in st.items()} for i, st in opt["state"].items()}}
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
        if self.generator is not None and "generator" in state:
            self.generator.set_state(state["generator"].cpu())


def eval_variables(state: TrainState, no_ema: bool = False) -> dict:
    """The variables to evaluate with, by name (for ``ScoreModel.forward``'s
    ``variables``): the EMA weights in place of the trained ones by default,
    the module's own with ``no_ema``; buffers and frozen parameters as they
    are."""
    variables = dict(state.module.named_parameters())
    variables.update(state.module.named_buffers())
    if not no_ema:
        variables.update(zip(state.names, state.whole_ema()))
    return variables


def load_ema(state: TrainState) -> None:
    """Copy the EMA into the module's own parameters (to evaluate or serve a
    restored checkpoint, which is not trained further)."""
    with torch.no_grad():
        torch._foreach_copy_(state.params, state.whole_ema())


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """The EMA in the module's own parameters inside the block, the trained
    weights copied back bit for bit after it. Each copy advances the
    parameters' ``_version``, so a program captured on the EMA weights
    (``ScoreModel._params_key``) never replays on the trained ones."""
    with torch.no_grad():
        trained = [p.detach().clone() for p in state.params]
        torch._foreach_copy_(state.params, state.whole_ema())
    try:
        yield state.module
    finally:
        with torch.no_grad():
            torch._foreach_copy_(state.params, trained)
