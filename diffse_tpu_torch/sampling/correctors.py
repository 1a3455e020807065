"""Correctors for reverse-SDE sampling (port of
diffse_tpu/sampling/correctors.py: langevin, ald and none)."""

from __future__ import annotations

import abc

import torch

from ..parallel.sequence import current_frames
from ..registry import Registry
from ..utils import bc

CorrectorRegistry = Registry("Corrector")


class Corrector(abc.ABC):
    def __init__(self, sde, score_fn, snr: float, n_steps: int):
        self.sde = sde
        self.score_fn = score_fn
        self.snr = snr
        self.n_steps = n_steps

    @abc.abstractmethod
    def update_fn(self, noise, x, t, y, std):
        """One corrector update, drawing from ``noise``; ``std``: the SDE's
        marginal std at ``t`` (``[B]``). Returns (x, x_mean)."""


def _row_norms_mean(a: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of each row's 2-norm (0-d); on a frames shard
    each row's norm over every rank's frames."""
    seq = current_frames()
    if seq is None:
        return torch.linalg.vector_norm(a.reshape(a.shape[0], -1), dim=-1).mean()
    squares = torch.square(torch.abs(a.reshape(a.shape[0], -1))).sum(dim=-1, dtype=torch.float64)
    return torch.sqrt(seq.sum(squares)).float().mean()


@CorrectorRegistry.register("langevin")
class LangevinCorrector(Corrector):
    """Langevin dynamics with the step size set by the ratio of the noise's
    norm to the score's, each averaged over the batch (so the rows of a batch
    share one step size, as in the JAX package)."""

    def update_fn(self, noise, x, t, y, std):
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t, y)
            z = noise(x)
            ratio = self.snr * _row_norms_mean(z) / _row_norms_mean(grad)
            step_size = (ratio ** 2 * 2)[None]
            x_mean = x + bc(step_size, x) * grad
            x = x_mean + z * bc(torch.sqrt(step_size * 2), x)
        return x, x_mean


@CorrectorRegistry.register("ald")
class AnnealedLangevinDynamics(Corrector):
    """Annealed Langevin dynamics: step size (snr * std)^2 * 2 from the
    marginal std."""

    def update_fn(self, noise, x, t, y, std):
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t, y)
            z = noise(x)
            step_size = (self.snr * std) ** 2 * 2
            x_mean = x + bc(step_size, x) * grad
            x = x_mean + z * bc(torch.sqrt(step_size * 2), x)
        return x, x_mean


@CorrectorRegistry.register("none")
class NoneCorrector(Corrector):
    """An empty corrector that does nothing."""

    def __init__(self, *args, **kwargs):
        self.snr = 0
        self.n_steps = 0

    def update_fn(self, noise, x, t, y, std):
        return x, x
