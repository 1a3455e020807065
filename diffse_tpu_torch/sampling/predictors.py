"""Predictors for reverse-SDE sampling (port of
diffse_tpu/sampling/predictors.py: euler_maruyama, reverse_diffusion, heun,
exp_euler, exp_heun and none).

``update_fn(noise, x, t, y, stepsize, std)`` draws from ``noise`` (the
stochastic predictors only) and returns (x, x_mean). ``stepsize`` is a host
number or a float32 0-d tensor on x's device (``SDE.discretize``). ``std``
is ``(std(t), std(t_end))``, the SDE's marginal std at ``t`` and at the
step's end ``max(t - stepsize, T_FLOOR)`` (``[B]`` each), for the
predictors that read it (``uses_std``: the exponential ones), else None: the
sampler tabulates it at its grid once, since BBED's std is a 40-term series
of ~330 launches a call.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from ..registry import Registry
from ..utils import bc

PredictorRegistry = Registry("Predictor")


class Predictor(abc.ABC):
    #: score-function evaluations per update (for NFE accounting)
    nfe_per_step = 1
    #: whether update_fn reads the marginal std at the step's two ends
    uses_std = False

    def __init__(self, sde, score_fn, probability_flow: bool = False):
        self.sde = sde
        self.rsde = sde.reverse(score_fn, probability_flow=probability_flow)
        self.score_fn = score_fn

    @abc.abstractmethod
    def update_fn(self, noise, x, t, y, stepsize, std=None):
        """One predictor update. Returns (x, x_mean)."""

    def update_mean(self, noise, x, t, y, stepsize, std=None):
        """The denoised mean of one update, ``update_fn(...)[1]``;
        reverse_diffusion skips the noise draw it would discard."""
        return self.update_fn(noise, x, t, y, stepsize, std)[1]


@PredictorRegistry.register("euler_maruyama")
class EulerMaruyamaPredictor(Predictor):
    """Euler-Maruyama with dt = -1/N (the SDE's own N, not the grid's step)."""

    def update_fn(self, noise, x, t, y, stepsize=None, std=None):
        dt = -1.0 / self.rsde.N
        z = noise(x)
        f, g = self.rsde.sde(x, t, y)
        x_mean = x + f * dt
        sqrt_dt = float(np.sqrt(np.float32(-dt)))  # float32, as a host scalar
        return x_mean + bc(g, x) * sqrt_dt * z, x_mean


@PredictorRegistry.register("reverse_diffusion")
class ReverseDiffusionPredictor(Predictor):
    def update_fn(self, noise, x, t, y, stepsize, std=None):
        f, g = self.rsde.discretize(x, t, y, stepsize)
        z = noise(x)
        x_mean = x - f
        return x_mean + bc(g, x) * z, x_mean

    def update_mean(self, noise, x, t, y, stepsize, std=None):
        f, _ = self.rsde.discretize(x, t, y, stepsize)
        return x - f


@PredictorRegistry.register("heun")
class HeunPredictor(Predictor):
    """Second-order Heun on the probability-flow ODE (2 NFE a step, no
    draw). The correction is evaluated at ``max(t - h, T_FLOOR)``, and the
    step falls back to Euler where ``t - h`` reaches the floor (the last
    step integrates to 0); the choice is a ``torch.where`` on the device."""

    nfe_per_step = 2
    T_FLOOR = 1e-5

    def __init__(self, sde, score_fn, probability_flow: bool = True):
        # an ODE integrator: always the probability flow
        super().__init__(sde, score_fn, probability_flow=True)

    def update_fn(self, noise, x, t, y, stepsize, std=None):
        h = stepsize
        d1, _ = self.rsde.sde(x, t, y)
        x_euler = x - h * d1
        t2 = t - h
        d2, _ = self.rsde.sde(x_euler, torch.clamp_min(t2, self.T_FLOOR), y)
        x_heun = x - h * 0.5 * (d1 + d2)
        x_new = torch.where(bc(t2 > self.T_FLOOR, x), x_heun, x_euler)
        return x_new, x_new


class _ExponentialBase(Predictor):
    """The exponential probability-flow integrators in data-prediction form:
    Tweedie's mean ``m(t1) = x + std(t1)^2 score``, ``x0 = (m - beta y) /
    alpha``, and the closed-form flow step ``x(t2) = alpha(t2) x0 + beta(t2)
    y + (std(t2)/std(t1)) (x - m(t1))``. No draw."""

    T_FLOOR = 1e-5
    uses_std = True

    def __init__(self, sde, score_fn, probability_flow: bool = True):
        super().__init__(sde, score_fn, probability_flow=True)

    def _end(self, t, stepsize):
        return torch.clamp_min(t - stepsize, self.T_FLOOR)

    def _x0_estimate(self, x, t, y, std):
        """(x0_hat, x - m) from Tweedie's formula at (x, t)."""
        std = bc(std, x)
        alpha, beta = self.sde.mean_coeffs(t)
        mean_hat = x + std * std * self.score_fn(x, t, y)
        x0_hat = (mean_hat - bc(beta, x) * y) / bc(alpha, x)
        return x0_hat, x - mean_hat

    def _flow_step(self, x0_hat, noise1, t2, y, x, std, std2):
        alpha2, beta2 = self.sde.mean_coeffs(t2)
        ratio = std2 / std
        return bc(alpha2, x) * x0_hat + bc(beta2, x) * y + bc(ratio, x) * noise1


@PredictorRegistry.register("exp_euler")
class ExponentialEulerPredictor(_ExponentialBase):
    """First-order exponential data-prediction step (bridge DDIM)."""

    def update_fn(self, noise, x, t, y, stepsize, std=None):
        std1, std2 = std
        x0_hat, noise1 = self._x0_estimate(x, t, y, std1)
        x_new = self._flow_step(x0_hat, noise1, self._end(t, stepsize), y, x, std1, std2)
        return x_new, x_new


@PredictorRegistry.register("exp_heun")
class ExponentialHeunPredictor(_ExponentialBase):
    """Second-order exponential data-prediction step: the x0 estimate
    averaged with the one at the first-order point (bridge DPM-Solver-2)."""

    nfe_per_step = 2

    def update_fn(self, noise, x, t, y, stepsize, std=None):
        std1, std2 = std
        t2 = self._end(t, stepsize)
        x0_a, noise1 = self._x0_estimate(x, t, y, std1)
        x_pred = self._flow_step(x0_a, noise1, t2, y, x, std1, std2)
        x0_b, _ = self._x0_estimate(x_pred, t2, y, std2)
        x0_avg = 0.5 * (x0_a + x0_b)
        # the noise re-derived against the averaged mean, so that an exact
        # score still gives the exact flow
        alpha1, beta1 = self.sde.mean_coeffs(t)
        noise_avg = x - bc(alpha1, x) * x0_avg - bc(beta1, x) * y
        x_new = self._flow_step(x0_avg, noise_avg, t2, y, x, std1, std2)
        return x_new, x_new


@PredictorRegistry.register("none")
class NonePredictor(Predictor):
    """An empty predictor that does nothing."""

    def __init__(self, *args, **kwargs):
        pass

    def update_fn(self, noise, x, t, y, stepsize=None, std=None):
        return x, x
