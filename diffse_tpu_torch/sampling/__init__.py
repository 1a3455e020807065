"""Reverse-SDE and probability-flow ODE samplers (port of
diffse_tpu/sampling/__init__.py: ``timesteps_space``, ``get_pc_sampler``
and ``get_ode_sampler``).

The JAX package runs the N predictor-corrector steps as one ``lax.scan``
over a carried counter, computing each step's time and step size in closed
form in float32 on the device. Here they are a plain Python loop over the
same float32 arithmetic, made once for the whole grid on the device when the
sampler is built (elementwise, so each entry is what the step's own
computation gives): the times, the step sizes (the last step integrates
``t_last`` down to 0), the marginal std at each time for the corrector and,
for the exponential predictors, at each step's end. Draw order: the prior
first, then for each step the corrector's draws and then the predictor's,
all through one ``noise(like)`` callable.

Nothing in the loop waits on the device, and the corrector's ``snr`` is a
float32 device scalar, the JAX program's traced ``snr``, so that a captured
sampler (``capture.Program``) serves every ``snr``.

The ODE sampler integrates the probability flow with the device RK45 of
``sampling/ode.py``, whose number of steps depends on the data.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .correctors import CorrectorRegistry
from .ode import RK45, RK45State
from .predictors import PredictorRegistry, ReverseDiffusionPredictor

__all__ = ["PredictorRegistry", "CorrectorRegistry", "get_pc_sampler", "get_ode_sampler",
           "ODESampler", "timesteps_space"]

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


def timesteps_space(sde_t: float, sde_n: int, eps: float,
                    timestep_type: Optional[str] = "linear") -> np.ndarray:
    """Time grid from T down to eps, float32.

    ``"linear"``: ``np.linspace(T, eps, N)``. ``"bridge_geom"``: geometric
    spacing in ``1 - t`` (steps cluster at the bridge's singular end t -> 1).
    ``"logit"``: uniform spacing in ``log(t / (1 - t))`` (steps cluster at
    both ends). Any other name falls through to the linear grid, as in the
    JAX package.
    """
    if timestep_type in ("bridge_geom", "logit"):
        if sde_n < 2 or not (0.0 < eps < sde_t < 1.0):
            raise ValueError(
                f"{timestep_type} grid needs N>=2 and 0 < eps < T < 1; "
                f"got T={sde_t}, eps={eps}, N={sde_n}")
        if timestep_type == "bridge_geom":
            u = np.geomspace(1.0 - sde_t, 1.0 - eps, sde_n)
            return (1.0 - u).astype(np.float32)
        u = np.linspace(np.log(sde_t / (1.0 - sde_t)), np.log(eps / (1.0 - eps)), sde_n)
        return (1.0 / (1.0 + np.exp(-u))).astype(np.float32)
    return np.linspace(sde_t, eps, sde_n, dtype=np.float32)


def step_grid(timesteps: np.ndarray, timestep_type: Optional[str], device):
    """The float32 time and step size of each step, ``[N]`` each on
    ``device``, in the JAX package's closed forms (``t_of`` / ``step_of``):
    linear ``t0 - i * delta``; bridge_geom ``1 - (1 - t0) exp(i log r)``
    with step ``(1 - t_i)(r - 1)``; logit ``sigmoid(lu0 + i du)`` with step
    ``t_i - t_{i+1}``. The last step is ``t_last``."""
    n = len(timesteps)
    t0, t_last = float(timesteps[0]), float(timesteps[-1])
    i = torch.arange(n, dtype=torch.float32, device=device)
    if timestep_type == "bridge_geom" and n > 1:
        r = float(((1.0 - t_last) / (1.0 - t0)) ** (1.0 / (n - 1)))
        times = 1.0 - (1.0 - t0) * torch.exp(i * float(np.log(r)))
        steps = (1.0 - times) * (r - 1.0)
    elif timestep_type == "logit" and n > 1:
        lu0 = float(np.log(t0 / (1.0 - t0)))
        du = float((np.log(t_last / (1.0 - t_last)) - lu0) / (n - 1))
        times = torch.sigmoid(lu0 + i * du)
        steps = times - torch.sigmoid(lu0 + (i + 1.0) * du)
    else:
        delta = float(timesteps[0] - timesteps[1]) if n > 1 else t0
        times = t0 - i * delta
        steps = torch.full((n,), delta, dtype=torch.float32, device=device)
    return times, torch.where(i < n - 1, steps, t_last)


def get_pc_sampler(predictor_name: str, corrector_name: str, sde, score_fn: Callable,
                   Y: torch.Tensor, noise: NoiseFn, Y_prior: Optional[torch.Tensor] = None,
                   denoise: bool = True, eps: float = 3e-2, snr: float = 0.1,
                   corrector_steps: int = 1, probability_flow: bool = False,
                   intermediate: bool = False, timestep_type: Optional[str] = "linear"):
    """Create a predictor-corrector sampler.

    Args:
        sde: forward SDE (its ``N`` gives the number of reverse steps).
        score_fn: ``(x, t, y) -> score``.
        Y: conditioning spectrogram ``[B, C, F, T]``.
        noise: ``noise(like) -> tensor`` shaped like ``like``.
        Y_prior: the prior's mean (Y when None).
        snr: the corrector's signal-to-noise ratio, a Python float or a
            float32 0-d tensor on Y's device.

    Returns ``sampler() -> (sample, nfe)``: the last step's denoised mean
    (its ``x`` with ``denoise=False``); with ``intermediate=True`` the
    trajectory of those, stacked on a leading axis of length N.
    """
    if not torch.is_tensor(snr):
        snr = torch.full((), float(snr), dtype=torch.float32, device=Y.device)
    predictor = PredictorRegistry.get_by_name(predictor_name)(
        sde, score_fn, probability_flow=probability_flow)
    corrector = CorrectorRegistry.get_by_name(corrector_name)(
        sde, score_fn, snr=snr, n_steps=corrector_steps)
    timesteps = timesteps_space(sde.T, sde.N, eps, timestep_type)
    n_steps = len(timesteps)
    times, steps = step_grid(timesteps, timestep_type, Y.device)
    stds = sde._std(times)
    if predictor.uses_std:
        ends = sde._std(torch.clamp_min(times - steps, predictor.T_FLOOR))
    y_prior = Y if Y_prior is None else Y_prior
    batch = Y.shape[0]

    def pc_sampler():
        x, _ = sde.prior_sampling(noise, y_prior)
        x_mean, trajectory = x, []
        for i in range(n_steps):
            vec_t = times[i].expand(batch)
            std = stds[i].expand(batch)
            x, x_mean = corrector.update_fn(noise, x, vec_t, Y, std=std)
            pred_std = (std, ends[i].expand(batch)) if predictor.uses_std else None
            x, x_mean = predictor.update_fn(noise, x, vec_t, Y, steps[i], pred_std)
            if intermediate:
                trajectory.append(x_mean if denoise else x)
        nfe = n_steps * (corrector.n_steps + predictor.nfe_per_step)
        if intermediate:
            return torch.stack(trajectory), nfe
        return (x_mean if denoise else x), nfe

    return pc_sampler


class ODESampler:
    """The probability-flow ODE sampler: the prior draw, RK45 from T down to
    eps on the flow ``f - g^2 score / 2``, and the denoising
    reverse_diffusion step at eps with step 0.03, whose draw is taken and
    discarded (as the JAX package takes its key). Draws: the prior's, then
    the denoising step's.

    ``start``, ``attempt`` and ``finish`` are the phases a caller may run
    (or capture) apart, with any number of attempts once ``done``;
    ``sampler() -> (sample, nfev)`` runs them all, reading ``done`` on the
    host after each attempt.
    """

    def __init__(self, sde, score_fn: Callable, y: torch.Tensor, noise: NoiseFn,
                 Y_prior: Optional[torch.Tensor] = None, denoise: bool = True,
                 rtol: float = 1e-5, atol: float = 1e-5, eps: float = 3e-2):
        self.sde, self.y, self.noise = sde, y, noise
        self.y_prior = y if Y_prior is None else Y_prior
        self.denoise, self.eps = denoise, eps
        self.predictor = ReverseDiffusionPredictor(sde, score_fn)
        rsde = sde.reverse(score_fn, probability_flow=True)
        batch = y.shape[0]

        def ode_func(t, x):
            return rsde.sde(x, t.expand(batch), y)[0]

        self.solver = RK45(ode_func, (sde.T, eps), rtol=rtol, atol=atol)

    def start(self) -> RK45State:
        x, _ = self.sde.prior_sampling(self.noise, self.y_prior)
        return self.solver.start(x)

    def attempt(self, state: RK45State) -> RK45State:
        return self.solver.attempt(state)

    def done(self, state: RK45State) -> torch.Tensor:
        return self.solver.done(state)

    def finish(self, state: RK45State) -> torch.Tensor:
        x = state.y
        if self.denoise:
            vec_eps = torch.full((x.shape[0],), self.eps, dtype=torch.float32, device=x.device)
            x = self.predictor.update_fn(self.noise, x, vec_eps, self.y, 0.03)[1]
        return x

    def __call__(self):
        state = self.start()
        while not bool(self.done(state)):
            state = self.attempt(state)
        return self.finish(state), state.nfev


def get_ode_sampler(sde, score_fn: Callable, y: torch.Tensor, noise: NoiseFn,
                    Y_prior: Optional[torch.Tensor] = None, denoise: bool = True,
                    rtol: float = 1e-5, atol: float = 1e-5, eps: float = 3e-2) -> ODESampler:
    """The probability-flow ODE sampler (``ODESampler``); ``sampler() ->
    (sample, nfev)``, nfev a 0-d int32 tensor."""
    return ODESampler(sde, score_fn, y, noise, Y_prior=Y_prior, denoise=denoise, rtol=rtol,
                      atol=atol, eps=eps)
