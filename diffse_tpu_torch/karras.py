"""The Karras t_30 grid and the paper's SNR relations (port of the
module-level helpers of diffse_tpu/models/score_model.py): the SNR estimate
as a diffusion time for the -5 dB training set, the normalisation-factor
correction (paper Eq. 12) and the snap of an estimate to the grid.

Plain arithmetic on numbers, numpy arrays or tensors alike, importing no
model code: ``ScoreModel`` snaps with it before its captured program, and
so does an exported artifact's loader (``serving/export.py``) before its
program.
"""

from __future__ import annotations

import numpy as np


def karras_t(n, N=30, rho=7.0, eps=0.001, T=1.0):
    """t_n of the Karras grid for integer n in [1, N]."""
    return (eps ** (1 / rho) + (n - 1) / (N - 1) * (T ** (1 / rho) - eps ** (1 / rho))) ** rho


# Karras rho=7 timestep grid with N=30, eps=0.001, T=1, and in float32 as the
# JAX package snaps to it (``jnp.asarray(t_30)``).
t_30 = karras_t(np.arange(1, 30 + 1))
T_30_F32 = t_30.astype(np.float32)


def calculate_snr_direct(s, n, fixed_snr):
    """(n/s) / (10^0.25 * fixed_snr): an SNR estimate as a diffusion time for
    the -5 dB training dataset."""
    snr = n / s
    return snr / (10**0.25 * fixed_snr)


def calculate_normfac_direct(s, n, fixed_snr):
    """Normalisation-factor correction, paper Eq. 12 constants."""
    return (2.040166) * (0.240253 + 0.759747 * fixed_snr**2) ** 0.5 / ((1 + (n / s) ** 2) ** 0.5)


def snap_to_karras_grid(est_snr: float, fixed_snr: float):
    """The SNR estimate -> ``(t_hat, normfac)``: the diffusion time snapped to
    the nearest point of the float32 t_30 grid (first on a tie) and the
    normalisation-factor correction at that time. Host float32 scalars (a
    Python float ``fixed_snr`` is weakly typed), with the JAX package's
    operations in its order, so that card and CPU snap alike."""
    one = np.float32(1)
    t_ = calculate_snr_direct(one, np.float32(est_snr), fixed_snr)
    t_hat = T_30_F32[int(np.argmin(np.abs(T_30_F32 - t_)))]
    normfac = calculate_normfac_direct(one, 10**0.25 * fixed_snr * t_hat, fixed_snr)
    return t_hat, np.float32(normfac)
