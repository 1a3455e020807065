"""Predictors for reverse-SDE sampling (port of
diffse_tpu/sampling/predictors.py: reverse_diffusion)."""

from __future__ import annotations

import abc

from ..registry import Registry
from ..utils import bc

PredictorRegistry = Registry("Predictor")


class Predictor(abc.ABC):
    #: score-function evaluations per update (for NFE accounting)
    nfe_per_step = 1

    def __init__(self, sde, score_fn):
        self.sde = sde
        self.rsde = sde.reverse(score_fn)
        self.score_fn = score_fn

    @abc.abstractmethod
    def update_fn(self, noise, x, t, y, stepsize):
        """One predictor update, drawing from ``noise``. Returns (x, x_mean)."""


@PredictorRegistry.register("reverse_diffusion")
class ReverseDiffusionPredictor(Predictor):
    def update_fn(self, noise, x, t, y, stepsize):
        f, g = self.rsde.discretize(x, t, y, stepsize)
        z = noise(x)
        x_mean = x - f
        return x_mean + bc(g, x) * z, x_mean
