"""Forward/reverse SDEs (port of diffse_tpu/sde/__init__.py: the base class,
ReverseSDE with the probability flow, OUVE, BBED and PROPOSED_1).

Methods take ``x: [B, ...]`` (complex spectrograms), ``t: [B]`` float32 and
the conditioning mean ``y``. Randomness comes from a ``noise`` callable
``noise(like) -> tensor``, by default :func:`diffse_tpu_torch.utils.randn_like`
over a ``torch.Generator``.
"""

from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..registry import Registry

from ..ops.expi import expi

SDERegistry = Registry("SDE")

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


def _bc(t: torch.Tensor) -> torch.Tensor:
    """Broadcast a [B] time vector against [B, C, F, T] data."""
    return t[:, None, None, None]


def _ei_at(value: float, device) -> torch.Tensor:
    """Ei of a constant, from a float32 0-d tensor filled on ``device`` (a
    tensor copied from the host would block the card)."""
    return expi(torch.full((), value, dtype=torch.float32, device=device))


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

    @staticmethod
    def add_argparse_args(parser):
        """The SDE's command-line flags (the JAX package's names and
        defaults); none for the base class."""
        return parser

    def prior_sampling(self, noise: NoiseFn, y: torch.Tensor):
        """x_T = y + z * std(T) with z = noise(y). Returns (x_T, z)."""
        t = torch.full((y.shape[0],), self.T, dtype=torch.float32, device=y.device)
        z = noise(y)
        return y + z * _bc(self._std(t)), z

    def discretize(self, x, t, y, stepsize: Union[float, torch.Tensor]):
        """Euler-Maruyama discretisation: f = drift*dt, G = g*sqrt(dt).

        ``stepsize`` is a host number or a float32 0-d tensor on x's device.
        A number becomes dt, its float32 value, and sqrt(dt), that value's
        float32 root, as host scalars (a tensor made from them would be a
        blocking copy to the card on every step); both give the bits of the
        same step as a device scalar."""
        drift, diffusion = self.sde(x, t, y)
        if torch.is_tensor(stepsize):
            return drift * stepsize, diffusion * torch.sqrt(stepsize)
        dt = np.float32(stepsize)
        return drift * float(dt), diffusion * float(np.sqrt(dt))

    def reverse(self, score_fn: Callable, probability_flow: bool = False) -> "ReverseSDE":
        """The reverse-time SDE (or, with ``probability_flow``, ODE) around
        ``score_fn(x, t, y) -> score``."""
        return ReverseSDE(fwd=self, score_fn=score_fn, probability_flow=probability_flow)

    # Every SDE here has an affine perturbation kernel
    #     p_t(x | x0, y) = N(alpha(t) x0 + beta(t) y, std(t)^2),
    # which the exponential predictors (sampling/predictors.py) step in
    # closed form.
    def mean_coeffs(self, t):
        """(alpha(t), beta(t)) with marginal mean = alpha x0 + beta y."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define mean_coeffs for the "
            "exponential integrators")

    def replace(self, **kwargs) -> "SDE":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Reverse-time SDE built from a forward SDE and a score function; with
    ``probability_flow`` the deterministic probability-flow ODE (half the
    score term, no diffusion)."""

    fwd: SDE
    score_fn: Callable
    probability_flow: bool = False

    @property
    def T(self) -> float:
        return self.fwd.T

    @property
    def N(self) -> int:
        return self.fwd.N

    def _scaled_score(self, g2, score):
        """g^2 * score, halved for the probability flow (a multiplication by
        one would only add a kernel launch)."""
        term = g2 * score
        return term * 0.5 if self.probability_flow else term

    def sde(self, x, t, y):
        parts = self.rsde_parts(x, t, y)
        return parts["total_drift"], parts["diffusion"]

    def rsde_parts(self, x, t, y):
        sde_drift, sde_diffusion = self.fwd.sde(x, t, y)
        score = self.score_fn(x, t, y)
        score_drift = -self._scaled_score(_bc(sde_diffusion) ** 2, score)
        diffusion = torch.zeros_like(sde_diffusion) if self.probability_flow else sde_diffusion
        return {
            "total_drift": sde_drift + score_drift,
            "diffusion": diffusion,
            "sde_drift": sde_drift,
            "sde_diffusion": sde_diffusion,
            "score_drift": score_drift,
            "score": score,
        }

    def discretize(self, x, t, y, stepsize):
        """Discretised reverse iteration rule: (f - G^2 score, G), or
        (f - G^2 score / 2, 0) for the probability flow."""
        f, g = self.fwd.discretize(x, t, y, stepsize)
        rev_f = f - self._scaled_score(_bc(g) ** 2, self.score_fn(x, t, y))
        return rev_f, (torch.zeros_like(g) if self.probability_flow else g)


@SDERegistry.register("ouve")
@dataclasses.dataclass(frozen=True)
class OUVESDE(SDE):
    """Ornstein-Uhlenbeck Variance-Exploding SDE:

        dx = theta (y - x) dt + sigma_min (sigma_max/sigma_min)^t
             * sqrt(2 log(sigma_max/sigma_min)) dw
    """

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000
    T_: float = 1.0

    @property
    def T(self) -> float:
        return self.T_

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def sde(self, x, t, y):
        drift = self.theta * (y - x)
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return drift, sigma * math.sqrt(2 * self.logsig)

    def _mean(self, x0, t, y):
        exp_interp = _bc(torch.exp(-self.theta * t))
        return exp_interp * x0 + (1 - exp_interp) * y

    def _std(self, t):
        sigma_min, theta, logsig = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (sigma_min ** 2 * torch.exp(-2 * theta * t)
             * (torch.exp(2 * (theta + logsig) * t) - 1) * logsig)
            / (theta + logsig))

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    def mean_coeffs(self, t):
        alpha = torch.exp(-self.theta * t)
        return alpha, 1.0 - alpha

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--sde-n", dest="N", type=int, default=1000,
                            help="The number of timesteps in the SDE discretization.")
        parser.add_argument("--theta", type=float, default=1.5,
                            help="The constant stiffness of the Ornstein-Uhlenbeck process.")
        parser.add_argument("--sigma-min", dest="sigma_min", type=float, default=0.05)
        parser.add_argument("--sigma-max", dest="sigma_max", type=float, default=0.5)
        return parser


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
        eis = expi(2.0 * (t - 1.0) * logk) - _ei_at(-2.0 * logk, t.device)
        h = 2.0 * self.k ** 2 * logk
        var = (self.k ** (2.0 * t) - 1.0 + t) + h * (1.0 - t) * eis
        var = var * (1.0 - t) * self.theta
        return torch.sqrt(var)

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    # the linear bridge mean x0 (1 - t/Tc) + y t/Tc
    def mean_coeffs(self, t):
        beta = t / self.Tc
        return 1.0 - beta, beta

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--sde-n", dest="N", type=int, default=30,
                            help="The number of timesteps in the SDE discretization.")
        parser.add_argument("--T_sampling", type=float, default=0.999,
                            help="The T so that t < T during sampling in the train step.")
        parser.add_argument("--k", type=float, default=2.6,
                            help="base factor for diffusion term")
        parser.add_argument("--theta", type=float, default=0.52,
                            help="root scale factor for diffusion term.")
        return parser


@SDERegistry.register("proposed_1")
@dataclasses.dataclass(frozen=True)
class PROPOSED_1(SDE):
    """BBED reparameterised by sigma_min/sigma_max, k = sigma_max/sigma_min,
    with the JAX package's (and its reference's) diffusion ``sigma_max * t``,
    not BBED's ``k^t``. At the defaults (sigma_min = sigma_max) the std is
    NaN there too: Ei(0) is -inf."""

    T_sampling: float = 0.99
    sigma_min: float = 1.0
    sigma_max: float = 1.0
    theta: float = 0.53
    N: int = 1000

    Tc: float = 1.0

    @property
    def T(self) -> float:
        return self.T_sampling

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    @property
    def ratio(self) -> float:
        return self.sigma_max / self.sigma_min

    def sde(self, x, t, y):
        drift = (y - x) / _bc(1.0 * self.Tc - t)
        sigma = self.sigma_max * t
        return drift, sigma * math.sqrt(self.theta)

    def _mean(self, x0, t, y):
        time = _bc(t / self.Tc)
        return x0 * (1 - time) + y * time

    def _std(self, t):
        logsig = self.logsig
        eis = expi(2.0 * (t - 1.0) * logsig) - _ei_at(-2.0 * logsig, t.device)
        h = 2.0 * self.sigma_max ** 2 * logsig
        var = self.sigma_min ** 2 * (self.ratio ** (2.0 * t) - 1.0 + t) + h * (1.0 - t) * eis
        var = var * (1.0 - t) * self.theta
        return torch.sqrt(var)

    def marginal_prob(self, x0, t, y):
        return self._mean(x0, t, y), self._std(t)

    def mean_coeffs(self, t):
        beta = t / self.Tc
        return 1.0 - beta, beta

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--sde-n", dest="N", type=int, default=1000)
        parser.add_argument("--T_sampling", type=float, default=0.99)
        parser.add_argument("--sigma-min", dest="sigma_min", type=float, default=1.0)
        parser.add_argument("--sigma-max", dest="sigma_max", type=float, default=1.0)
        parser.add_argument("--theta", type=float, default=0.53)
        return parser


__all__ = ["SDERegistry", "SDE", "ReverseSDE", "OUVESDE", "BBED", "PROPOSED_1"]
