"""Forward/reverse SDEs (port of diffse_tpu/sde/__init__.py: the base class,
ReverseSDE and BBED).

Methods take ``x: [B, ...]`` (complex spectrograms), ``t: [B]`` float32 and
the conditioning mean ``y``. Randomness comes from a ``noise`` callable
``noise(like) -> tensor``, by default :func:`diffse_tpu_torch.utils.randn_like`
over a ``torch.Generator``.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..registry import Registry

from ..ops.expi import expi

SDERegistry = Registry("SDE")

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


def _bc(t: torch.Tensor) -> torch.Tensor:
    """Broadcast a [B] time vector against [B, C, F, T] data."""
    return t[:, None, None, None]


@dataclasses.dataclass(frozen=True)
class SDE(abc.ABC):
    """SDE abstract base."""

    @property
    @abc.abstractmethod
    def T(self) -> float:
        """End time of the SDE (reverse-process starting point)."""

    @abc.abstractmethod
    def sde(self, x, t, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Drift f(x, t) ([B, ...]) and scalar diffusion g(t) ([B])."""

    @abc.abstractmethod
    def marginal_prob(self, x0, t, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean/std of the perturbation kernel p_t(x | x0, y)."""

    @abc.abstractmethod
    def _std(self, t) -> torch.Tensor:
        ...

    def prior_sampling(self, noise: NoiseFn, y: torch.Tensor):
        """x_T = y + z * std(T) with z = noise(y). Returns (x_T, z)."""
        t = torch.full((y.shape[0],), self.T, dtype=torch.float32, device=y.device)
        z = noise(y)
        return y + z * _bc(self._std(t)), z

    def discretize(self, x, t, y, stepsize):
        """Euler-Maruyama discretisation: f = drift*dt, G = g*sqrt(dt), with
        dt the float32 value of ``stepsize`` and sqrt(dt) the float32 root of
        that value, as host scalars (a tensor made from them would be a
        blocking copy to the card on every step)."""
        drift, diffusion = self.sde(x, t, y)
        dt = np.float32(stepsize)
        return drift * float(dt), diffusion * float(np.sqrt(dt))

    def reverse(self, score_fn: Callable) -> "ReverseSDE":
        return ReverseSDE(fwd=self, score_fn=score_fn)

    def replace(self, **kwargs) -> "SDE":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Reverse-time SDE built from a forward SDE and a score function (the
    probability-flow variant comes with the ODE sampler)."""

    fwd: SDE
    score_fn: Callable

    def discretize(self, x, t, y, stepsize):
        """Discretised reverse iteration rule: (f - G^2 score, G)."""
        f, g = self.fwd.discretize(x, t, y, stepsize)
        return f - _bc(g) ** 2 * self.score_fn(x, t, y), g


@SDERegistry.register("bbed")
@dataclasses.dataclass(frozen=True)
class BBED(SDE):
    """Brownian Bridge with Exploding Diffusion coefficient:

        dx = (y - x)/(Tc - t) dt + sqrt(theta) k^t dw,   Tc = 1
    """

    T_sampling: float = 0.999
    k: float = 2.6
    theta: float = 0.52
    N: int = 30

    Tc: float = 1.0

    @property
    def T(self) -> float:
        return self.T_sampling

    @property
    def logk(self) -> float:
        return math.log(self.k)

    def sde(self, x, t, y):
        drift = (y - x) / _bc(1.0 * self.Tc - t)
        diffusion = self.k ** t * math.sqrt(self.theta)
        return drift, diffusion

    def _mean(self, x0, t, y):
        time = _bc(t / self.Tc)
        return x0 * (1 - time) + y * time

    def _std(self, t):
        # Var(t) = theta (1-t) [ (k^{2t} - 1 + t) + 2 k^2 log k (1-t)
        #          (Ei(2(t-1) log k) - Ei(-2 log k)) ]
        logk = self.logk
        eilog = expi(torch.full((), -2.0 * logk, dtype=torch.float32, device=t.device))
        eis = expi(2.0 * (t - 1.0) * logk) - eilog
        h = 2.0 * self.k ** 2 * logk
        var = (self.k ** (2.0 * t) - 1.0 + t) + h * (1.0 - t) * eis
        var = var * (1.0 - t) * self.theta
        return torch.sqrt(var)

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)


__all__ = ["SDERegistry", "SDE", "ReverseSDE", "BBED"]
