"""Predictor-corrector reverse-SDE sampler (port of
diffse_tpu/sampling/__init__.py: ``timesteps_space`` on the linear grid and
``get_pc_sampler``).

The JAX package runs the N steps as one ``lax.scan`` over a carried counter;
here they are a plain Python loop computing the same float32 times
``t_i = t0 - i * delta`` (the last step integrates ``t_last`` down to 0).
Draw order: the prior first, then for each step the corrector's draw and then
the predictor's, all through one ``noise(like)`` callable.

Nothing in the loop waits on the device: the times are host floats, the
corrector's marginal std is computed for the whole grid in one vectorised
call when the sampler is built (elementwise float32, so each entry is what
the step's own call computed), and the corrector's ``snr`` is a float32
device scalar, the JAX program's traced ``snr``, so that a captured sampler
(``capture.Program``) serves every ``snr``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .correctors import CorrectorRegistry
from .predictors import PredictorRegistry

__all__ = ["PredictorRegistry", "CorrectorRegistry", "get_pc_sampler", "timesteps_space"]


def timesteps_space(sde_t: float, sde_n: int, eps: float,
                    timestep_type: str = "linear") -> np.ndarray:
    """Linear time grid from T down to eps, float32."""
    if timestep_type not in (None, "linear"):
        raise NotImplementedError(f"timestep_type {timestep_type!r} is not ported yet")
    return np.linspace(sde_t, eps, sde_n, dtype=np.float32)


def get_pc_sampler(predictor_name: str, corrector_name: str, sde, score_fn: Callable,
                   Y: torch.Tensor, noise: Callable[[torch.Tensor], torch.Tensor],
                   eps: float = 3e-2, snr: float = 0.1, corrector_steps: int = 1):
    """Create a predictor-corrector sampler that returns the denoised mean of
    the last step.

    Args:
        sde: forward SDE (its ``N`` gives the number of reverse steps).
        score_fn: ``(x, t, y) -> score``.
        Y: conditioning spectrogram ``[B, C, F, T]``.
        noise: ``noise(like) -> tensor`` shaped like ``like``.
        snr: the corrector's signal-to-noise ratio, a Python float or a
            float32 0-d tensor on Y's device.

    Returns ``sampler() -> (sample, nfe)``.
    """
    if not torch.is_tensor(snr):
        snr = torch.full((), float(snr), dtype=torch.float32, device=Y.device)
    predictor = PredictorRegistry.get_by_name(predictor_name)(sde, score_fn)
    corrector = CorrectorRegistry.get_by_name(corrector_name)(
        sde, score_fn, snr=snr, n_steps=corrector_steps)
    timesteps = timesteps_space(sde.T, sde.N, eps)
    n_steps = len(timesteps)
    t0 = timesteps[0]
    t_last = float(timesteps[-1])
    delta = timesteps[0] - timesteps[1] if n_steps > 1 else timesteps[0]
    times = [float(t0 - np.float32(i) * delta) for i in range(n_steps)]  # float32 maths
    delta = float(delta)
    batch = Y.shape[0]
    # the corrector's marginal std at each step's time (the same float32
    # times, made on the device: t0 - i * delta)
    stds = sde._std(float(t0) - torch.arange(n_steps, dtype=torch.float32,
                                             device=Y.device) * delta)

    def pc_sampler():
        x, _ = sde.prior_sampling(noise, Y)
        x_mean = x
        for i, t in enumerate(times):
            stepsize = delta if i < n_steps - 1 else t_last
            vec_t = torch.full((batch,), t, dtype=torch.float32, device=Y.device)
            x, x_mean = corrector.update_fn(noise, x, vec_t, Y, std=stds[i].expand(batch))
            x, x_mean = predictor.update_fn(noise, x, vec_t, Y, stepsize)
        nfe = n_steps * (corrector.n_steps + predictor.nfe_per_step)
        return x_mean, nfe

    return pc_sampler
