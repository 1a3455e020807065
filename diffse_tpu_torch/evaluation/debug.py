"""Debug / inspection harness (port of diffse_tpu/evaluation/debug.py).

Working replacements for the reference's manual debug paths
(sgmse/model.py:638-1011: enhance_debug / prior_tests2 / get_prior, which
reference an undefined ``self.preemp`` and crash):

  - :func:`get_prior`: draw x_T from the prior, run one score evaluation,
    and return the reconstruction pieces (mean prediction, score, residual)
    as numpy arrays;
  - :func:`prior_panel`: save the 3x3 diagnostic spectrogram figure the
    reference's prior_tests2 plots (model.py:900-955). matplotlib is
    imported only there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..transforms import pad_spec, spec_fwd
from ..utils import generator_noise
from .inference import NoiseFn, _wave


@torch.no_grad()
def get_prior(model, y_wav, x_wav, generator: Optional[torch.Generator] = None, T: float = 1.0,
              noise: Optional[NoiseFn] = None) -> dict:
    """Prior-sampling diagnostics (model.py:959-1011) of ``y_wav`` / ``x_wav``
    (``[1, samples]``): numpy ``[F, T]`` complex spectrograms ``mean_pred``,
    ``clean``, ``noisy``, ``residual``, ``z``, ``score``, ``noise`` and
    ``x_T``. The prior's draw comes from ``noise`` when given, else from
    ``generator`` (on the model's device; seed 0 when None)."""
    if noise is None:
        if generator is None:
            generator = torch.Generator(model.device).manual_seed(0)
        noise = generator_noise(generator)
    y_wav, x_wav = _wave(y_wav, model.device), _wave(x_wav, model.device)

    norm_factor = torch.max(torch.abs(y_wav))
    y = y_wav / norm_factor
    x = x_wav / norm_factor

    Y = pad_spec(spec_fwd(model._stft(y), model.spec_cfg)[:, None])
    X = pad_spec(spec_fwd(model._stft(x), model.spec_cfg)[:, None])
    Ns = Y - X

    sde = model.sde.replace(**({"T_sampling": T} if hasattr(model.sde, "T_sampling")
                               else {"T_": T}))
    Yt, z = sde.prior_sampling(noise, Y)
    vec_t = torch.full((Y.shape[0],), T, dtype=torch.float32, device=Y.device)

    grad = model.forward(Yt, vec_t, Y)
    std = sde._std(vec_t)[:, None, None, None]

    mp = Yt + grad * std ** 2
    z_n = z / std
    res = z_n + grad

    def sq(a):
        return a[0, 0].cpu().numpy()

    return {"mean_pred": sq(mp), "clean": sq(X), "noisy": sq(Y), "residual": sq(res),
            "z": sq(z_n), "score": sq(grad), "noise": sq(Ns), "x_T": sq(Yt)}


def prior_panel(model, y_wav, x_wav, out_path: str = "prior_debug.png",
                generator: Optional[torch.Generator] = None, T: float = 1.0,
                noise: Optional[NoiseFn] = None) -> str:
    """Save the 3x3 diagnostic panel (model.py:900-955); returns out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = get_prior(model, y_wav, x_wav, generator=generator, T=T, noise=noise)

    def db(a):
        return 20 * np.log10(np.abs(a) + 1e-9)

    panels = [
        ("Clean", d["clean"]),
        ("environmental noise", d["noise"]),
        ("noisy mixture", d["noisy"]),
        ("predicted score", d["score"]),
        ("yT = y + z*sigma(T)", d["x_T"]),
        ("mean = yT + score*sigma(T)^2", d["mean_pred"]),
        ("score + z/sigma(T)", d["residual"]),
        ("recon mean - noisy", d["mean_pred"] - d["noisy"]),
        ("z/sigma(T)", d["z"]),
    ]
    fig, axs = plt.subplots(3, 3, figsize=(10, 9), sharex=True, sharey=True)
    for ax, (title, a) in zip(axs.ravel(), panels):
        im = ax.imshow(db(a), aspect="auto", vmin=-30, vmax=30, origin="lower", cmap="magma")
        ax.set_title(title, fontsize=8)
    fig.colorbar(im, ax=axs.ravel().tolist(), shrink=0.5)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
