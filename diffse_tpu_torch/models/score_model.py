"""ScoreModel: score parameterisation and speech enhancement (port of
diffse_tpu/models/score_model.py).

Ported branches of ``enhance`` (``snr_conditioned="false"``):

  - ``bbed_pc`` (``model_type="bbed"``): the 30-step predictor-corrector
    sampler, reverse_diffusion + ald, 60 network forwards;
  - ``sebridge_v2``: one network forward with the consistency c_skip/c_out.

The SNR-conditioned branches, the ODE sampler and training are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..sampling import get_pc_sampler
from ..sde import SDERegistry
from ..transforms import (
    SpecTransformConfig,
    StftConfig,
    hann_window,
    istft,
    pad_spec,
    spec_back,
    spec_fwd,
    stft,
    width_bucket,
)
from ..utils import randn_like
from . import ncsnpp  # noqa: F401  (registers the "ncsnpp" backbone)
from .shared import BackboneRegistry

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class ScoreModelConfig:
    """The fields of diffse_tpu's ScoreModelConfig that inference reads, with
    the same names and defaults (training's fields come with training)."""

    backbone: str = "ncsnpp"
    sde: str = "ouve"
    model_type: str = "sebridge"  # bbed | sebridge_v2 ported
    snr_conditioned: str = "false"  # false ported
    t_eps: float = 3e-2
    sigma_max: float = 0.5
    n_fft: int = 510
    hop_length: int = 128
    window: str = "hann"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5
    transform_type: str = "exponent"


class ScoreModel:
    """Score / consistency model for speech enhancement.

    Args:
        config: hyperparameters.
        backbone_kwargs: keywords of the backbone (e.g. NCSNpp's nf, ch_mult).
        sde_kwargs: keywords of the SDE.
        device: where the backbone's weights live and enhancement runs.
        generator: CPU generator for the backbone's initial weights.
    """

    def __init__(self, config: ScoreModelConfig, backbone_kwargs: Optional[dict] = None,
                 sde_kwargs: Optional[dict] = None, device="cpu",
                 generator: Optional[torch.Generator] = None):
        if config.window != "hann":
            raise NotImplementedError(f"window {config.window!r} is not ported yet")
        self.cfg = config
        self.device = torch.device(device)
        backbone_cls = BackboneRegistry.get_by_name(config.backbone)
        self.backbone = backbone_cls(**(backbone_kwargs or {}), generator=generator)
        self.backbone = self.backbone.to(self.device).eval()
        self.sde = SDERegistry.get_by_name(config.sde)(**(sde_kwargs or {}))
        self.stft_cfg = StftConfig(n_fft=config.n_fft, hop_length=config.hop_length,
                                   window=config.window)
        self.spec_cfg = SpecTransformConfig(
            transform_type=config.transform_type, spec_factor=config.spec_factor,
            spec_abs_exponent=config.spec_abs_exponent)
        self._window = hann_window(config.n_fft, device=self.device)

    # ------------------------------------------------------------ transforms
    def _stft(self, sig: torch.Tensor) -> torch.Tensor:
        return stft(sig, self._window, self.stft_cfg.n_fft, self.stft_cfg.hop_length)

    def to_audio(self, spec: torch.Tensor) -> torch.Tensor:
        return istft(spec_back(spec, self.spec_cfg), self._window, self.stft_cfg.n_fft,
                     self.stft_cfg.hop_length)

    # --------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Score (bbed) or consistency output (sebridge_v2).

        Args:
            x: complex ``[B, 1, F, T]`` diffusion state.
            t: ``[B]`` float32 times.
            y: complex ``[B, 1, F, T]`` conditioner.
        """
        cfg = self.cfg
        if cfg.snr_conditioned != "false":
            raise NotImplementedError(f"snr_conditioned={cfg.snr_conditioned!r} is not ported yet")
        raw = self.backbone(torch.cat([x, y], dim=1), t)
        if cfg.model_type == "bbed":
            return -raw
        if cfg.model_type == "sebridge_v2":
            eps, sigma_data = 0.001, 0.5
            tb = t[:, None, None, None]
            c_skip = sigma_data ** 2 / ((tb - eps) ** 2 + sigma_data ** 2)
            c_out = (sigma_data * (tb - eps)) / ((sigma_data ** 2 + tb ** 2) ** 0.5)
            return c_skip * x + c_out * raw
        raise ValueError(f"Unsupported model_type={cfg.model_type}")

    # --------------------------------------------------------------- enhance
    def _branch(self) -> str:
        cfg = self.cfg
        if cfg.snr_conditioned != "false":
            raise NotImplementedError(f"snr_conditioned={cfg.snr_conditioned!r} is not ported yet")
        if cfg.model_type == "bbed":
            return "bbed_pc"
        if cfg.model_type == "sebridge_v2":
            return "sebridge_v2"
        raise NotImplementedError(f"enhance for model_type={cfg.model_type!r} is not ported yet")

    @torch.no_grad()
    def enhance(self, x, y, generator: Optional[torch.Generator] = None,
                noise: Optional[NoiseFn] = None, predictor: str = "reverse_diffusion",
                corrector: str = "ald", N: int = 30, corrector_steps: int = 1,
                snr: float = 0.5, timeit: bool = False):
        """Enhance the noisy waveform ``y`` ([1, samples]).

        ``x`` (the clean waveform) is accepted for the JAX signature; the
        ported branches do not read it. Noise comes from ``noise(like)`` when
        given (tests feed the JAX package's draws through it), otherwise from
        ``generator`` (a generator on ``self.device``; seed 0 when None).

        Returns the enhanced waveform as a numpy array of ``samples``; with
        ``timeit=True`` a tuple ``(x_hat, nfe, rtf)``.
        """
        del x
        start = time.time()
        branch = self._branch()
        if not torch.is_tensor(y):
            y = torch.from_numpy(np.asarray(y, dtype=np.float32))
        t_orig = y.shape[-1]
        # Frames padded to a multiple of 64 on the host, as the JAX package
        # does: the U-Net downsamples six times.
        _, pad_samples = width_bucket(t_orig, self.cfg.hop_length)
        if t_orig < pad_samples:
            y = F.pad(y, (0, pad_samples - t_orig))
        elif t_orig > pad_samples:
            y = y[..., :pad_samples]
        y = y.to(self.device, torch.float32)

        if noise is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            noise = lambda like: randn_like(like, generator)  # noqa: E731

        norm_factor = torch.max(torch.abs(y))
        Y = pad_spec(spec_fwd(self._stft(y / norm_factor), self.spec_cfg)[:, None])

        if branch == "bbed_pc":
            sampler = get_pc_sampler(
                predictor, corrector, sde=self.sde.replace(N=N), score_fn=self.forward,
                Y=Y, noise=noise, eps=self.cfg.t_eps, snr=snr,
                corrector_steps=corrector_steps)
            sample, nfe = sampler()
        else:  # sebridge_v2
            vec_t = torch.full((Y.shape[0],), 0.999, dtype=torch.float32, device=self.device)
            z = noise(Y) * self.cfg.sigma_max * 0.999
            sample = self.forward(Y + z, vec_t, Y)
            nfe = 1

        x_hat = self.to_audio(sample[:, 0]) * norm_factor
        x_hat = x_hat[0, :t_orig].cpu().numpy()
        if x_hat.shape[-1] < t_orig:
            # frames % 64 == 0 bucket: the iSTFT yields up to hop-1 samples
            # fewer than the input; zero-pad back to its length.
            x_hat = np.pad(x_hat, (0, t_orig - x_hat.shape[-1]))
        if timeit:
            return x_hat, nfe, (time.time() - start) / (len(x_hat) / 16000)
        return x_hat
