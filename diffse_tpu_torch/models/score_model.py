"""ScoreModel: score parameterisation and speech enhancement (port of
diffse_tpu/models/score_model.py).

Ported branches of ``enhance``:

  - ``bbed_pc`` (``model_type="bbed"``): the 30-step predictor-corrector
    sampler, reverse_diffusion + ald, 60 network forwards;
  - ``sebridge`` and ``sebridge_v2``: one network forward with the
    consistency c_skip/c_out, from ``Y`` or from ``Y + Z``;
  - ``sebridge_v3_snr`` (``snr_conditioned="true"``), the paper's single-NFE
    mode: SNRNet estimates the SNR from the noisy waveform (or the caller
    gives it, ``oracle``), the estimate is snapped to the Karras t_30 grid,
    the normalisation factor is corrected (paper Eq. 12), then one forward;
  - ``sebridge_v2_snr``: one forward of the SNR-conditioned NCSN++ with the
    noise level taken from the clean reference.

The ODE sampler and training are not ported yet.
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
from . import ncsnpp  # noqa: F401  (registers the "ncsnpp" and "ncsnpp_snr" backbones)
from .shared import BackboneRegistry
from .snr_model import snr_from_normalized_wav

NoiseFn = Callable[[torch.Tensor], torch.Tensor]


def _as_wave(a) -> torch.Tensor:
    """A waveform as a float32 tensor (numpy arrays are converted)."""
    if torch.is_tensor(a):
        return a.float()
    return torch.from_numpy(np.asarray(a, dtype=np.float32))

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


def noise_mag(s, s_hat, mode: str = "mean"):
    """Noise magnitude between two specs."""
    if mode == "mean":
        return torch.abs(torch.mean(torch.sqrt(torch.square(torch.abs(s - s_hat)))))
    if mode == "max":
        return torch.max(torch.abs(s - s_hat))
    return torch.zeros((), device=s.device)


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


@dataclasses.dataclass
class ScoreModelConfig:
    """The fields of diffse_tpu's ScoreModelConfig that inference reads, with
    the same names and defaults (training's fields come with training)."""

    backbone: str = "ncsnpp"
    sde: str = "ouve"
    model_type: str = "sebridge"  # bbed | sebridge | sebridge_v2 | sebridge_v3
    snr_conditioned: str = "false"  # false | true ("fixed" is not for inference)
    fixed_snr: float = 1.0
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
        device: where the backbone's (and SNRNet's) weights live and
            enhancement runs.
        generator: CPU generator for the backbone's initial weights.
        snr_model: the SNRNet (``models.snrnet``) that ``snr_conditioned="true"``
            estimates the SNR with, moved to ``device``; needed unless every
            call is ``oracle``.
    """

    def __init__(self, config: ScoreModelConfig, backbone_kwargs: Optional[dict] = None,
                 sde_kwargs: Optional[dict] = None, device="cpu",
                 generator: Optional[torch.Generator] = None,
                 snr_model: Optional[torch.nn.Module] = None):
        if config.window != "hann":
            raise NotImplementedError(f"window {config.window!r} is not ported yet")
        self.cfg = config
        self.device = torch.device(device)
        backbone_cls = BackboneRegistry.get_by_name(config.backbone)
        self.backbone = backbone_cls(**(backbone_kwargs or {}), generator=generator)
        self.backbone = self.backbone.to(self.device).eval()
        self.backbone_takes_noise_cond = getattr(self.backbone, "snr_conditioning", False)
        self.snr_model = None if snr_model is None else snr_model.to(self.device).eval()
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
    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                s: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Score (bbed) or consistency output (the sebridge family).

        Args:
            x: complex ``[B, 1, F, T]`` diffusion state.
            t: ``[B]`` float32 times.
            y: complex ``[B, 1, F, T]`` conditioner.
            s: ``[B]`` noise conditioning of ``ncsnpp_snr`` (``t`` when None).
        """
        cfg = self.cfg
        if cfg.snr_conditioned == "fixed":
            raise NotImplementedError("snr_conditioned='fixed' is a training mode; "
                                      "it comes with training")
        consistency = {("false", "sebridge"), ("false", "sebridge_v2"),
                       ("true", "sebridge_v2"), ("true", "sebridge_v3")}
        key = (cfg.snr_conditioned, cfg.model_type)
        if key != ("false", "bbed") and key not in consistency:
            raise ValueError(f"Unsupported (snr_conditioned={cfg.snr_conditioned}, "
                             f"model_type={cfg.model_type})")
        dnn_input = torch.cat([x, y], dim=1)
        if self.backbone_takes_noise_cond:
            raw = self.backbone(dnn_input, t, s if s is not None else t)
        else:
            raw = self.backbone(dnn_input, t)
        if key == ("false", "bbed"):
            return -raw
        eps, sigma_data = 0.001, 0.5
        tb = t[:, None, None, None]
        c_skip = sigma_data ** 2 / ((tb - eps) ** 2 + sigma_data ** 2)
        c_out = (sigma_data * (tb - eps)) / ((sigma_data ** 2 + tb ** 2) ** 0.5)
        return c_skip * x + c_out * raw

    # --------------------------------------------------------------- enhance
    @torch.no_grad()
    def estimate_snr(self, y_wav) -> torch.Tensor:
        """SNR estimate ``[B]`` (amplitude ratio) of the noisy waveforms
        ``[B, samples]`` by SNRNet, each row normalised by its max-abs."""
        if self.snr_model is None:
            raise ValueError("snr_conditioned='true' requires an snr_model")
        y_wav = _as_wave(y_wav).to(self.device)
        y_n = y_wav / torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
        return snr_from_normalized_wav(self.snr_model, y_n, self._window,
                                       self.stft_cfg.n_fft, self.stft_cfg.hop_length)

    def _branch(self) -> str:
        cfg = self.cfg
        if cfg.snr_conditioned == "false":
            if cfg.model_type == "bbed":
                return "bbed_pc"
            if cfg.model_type in ("sebridge", "sebridge_v2"):
                return cfg.model_type
            raise ValueError(f"unsupported model_type {cfg.model_type}")
        if cfg.snr_conditioned == "fixed":
            raise NotImplementedError(
                "snr fixed is only for experiment purpose, not real inference.")
        if cfg.snr_conditioned == "true":
            branch = f"{cfg.model_type}_snr"
            if branch not in ("sebridge_v2_snr", "sebridge_v3_snr"):
                raise ValueError(f"unknown enhance branch {branch}")
            return branch
        raise ValueError(f"unknown snr_conditioned {cfg.snr_conditioned}")

    @torch.no_grad()
    def enhance(self, x, y, generator: Optional[torch.Generator] = None,
                noise: Optional[NoiseFn] = None, predictor: str = "reverse_diffusion",
                corrector: str = "ald", N: int = 30, corrector_steps: int = 1,
                snr: float = 0.5, timeit: bool = False, oracle: bool = False,
                clean_rms: float = 1.0, noise_rms: float = 1.0):
        """Enhance the noisy waveform ``y`` ([1, samples]).

        ``x`` is the clean waveform; of the ported branches only
        ``sebridge_v2_snr`` reads it (pass ``y`` twice where there is none).
        With ``snr_conditioned="true"`` the SNR comes from SNRNet on the
        unpadded ``y``, or is ``noise_rms / clean_rms`` with ``oracle``.
        Noise comes from ``noise(like)`` when given (tests feed the JAX
        package's draws through it), otherwise from ``generator`` (a
        generator on ``self.device``; seed 0 when None).

        Returns the enhanced waveform as a numpy array of ``samples``; with
        ``timeit=True`` a tuple ``(x_hat, nfe, rtf)``.
        """
        start = time.time()
        cfg = self.cfg
        branch = self._branch()
        x, y = _as_wave(x), _as_wave(y)
        t_orig = y.shape[-1]

        est_snr = 1.0
        if cfg.snr_conditioned == "true":
            est_snr = (np.float32(noise_rms / clean_rms) if oracle
                       else self.estimate_snr(y)[0].item())

        # Frames padded to a multiple of 64 on the host, as the JAX package
        # does: the U-Net downsamples six times.
        _, pad_samples = width_bucket(t_orig, cfg.hop_length)
        if t_orig < pad_samples:
            x = F.pad(x, (0, pad_samples - t_orig))
            y = F.pad(y, (0, pad_samples - t_orig))
        elif t_orig > pad_samples:
            x = x[..., :pad_samples]
            y = y[..., :pad_samples]
        y = y.to(self.device, torch.float32)

        if noise is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            noise = lambda like: randn_like(like, generator)  # noqa: E731

        norm_factor = torch.max(torch.abs(y))
        t_hat = None
        if branch.endswith("_snr"):
            t_hat, normfac = snap_to_karras_grid(est_snr, cfg.fixed_snr)
            norm_factor = norm_factor * float(normfac)
        Y = pad_spec(spec_fwd(self._stft(y / norm_factor), self.spec_cfg)[:, None])
        batch = Y.shape[0]

        def full(value):
            return torch.full((batch,), 1.0, dtype=torch.float32, device=self.device) * value

        if branch == "bbed_pc":
            sampler = get_pc_sampler(
                predictor, corrector, sde=self.sde.replace(N=N), score_fn=self.forward,
                Y=Y, noise=noise, eps=cfg.t_eps, snr=snr,
                corrector_steps=corrector_steps)
            sample, nfe = sampler()
        elif branch == "sebridge":
            sample = self.forward(Y, full(0.999), Y)
            nfe = 1
        elif branch == "sebridge_v2":
            z = noise(Y) * cfg.sigma_max * 0.999
            sample = self.forward(Y + z, full(0.999), Y)
            nfe = 1
        elif branch == "sebridge_v2_snr":
            x = x.to(self.device, torch.float32)
            X = pad_spec(spec_fwd(self._stft(x / norm_factor), self.spec_cfg)[:, None])
            z_mag = noise_mag(X, Y, mode="max") * cfg.sigma_max
            z = noise(Y) * z_mag * 0.999
            sample = self.forward(Y + z, full(0.999), Y, s=full(z_mag) * 0.999)
            nfe = 1
        else:  # sebridge_v3_snr
            z = noise(Y) * cfg.sigma_max * float(t_hat)
            sample = self.forward(Y + z, full(float(t_hat)), Y)
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
