"""Correctors for reverse-SDE sampling (port of
diffse_tpu/sampling/correctors.py: ald and none)."""

from __future__ import annotations

import abc

import torch

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
    def update_fn(self, noise, x, t, y):
        """One corrector update, drawing from ``noise``. Returns (x, x_mean)."""


@CorrectorRegistry.register("ald")
class AnnealedLangevinDynamics(Corrector):
    """Annealed Langevin dynamics: step size (snr * std)^2 * 2 from the
    marginal std."""

    def update_fn(self, noise, x, t, y):
        x_mean = x
        std = self.sde.marginal_prob(x, t, y)[1]
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

    def update_fn(self, noise, x, t, y):
        return x, x
