"""SNRModel: inference around the SNR-estimator CNN (port of the inference
part of diffse_tpu/models/snr_model.py; training's ``loss_fn`` and
``valid_metrics`` come with training).

The data contract is transform_type='none': the specs fed to SNRNet are raw,
uncompressed STFTs. ``snr_from_normalized_wav`` is the one estimation path;
``ScoreModel.estimate_snr`` (per-row normalisation) and
``SNRModel.estimate_from_wav`` (batch normalisation) differ only in how they
normalise the waveform first, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..transforms import StftConfig, get_window, pad_spec_16, stft
from ..utils import model_device
from .snrnet import SNRNet


@dataclasses.dataclass
class SNRModelConfig:
    """The fields of diffse_tpu's SNRModelConfig that inference reads, with
    the same names and defaults (training's fields come with training)."""

    n_fft: int = 510
    hop_length: int = 128
    window: str = "hann"


def complex_to_2ch(y: torch.Tensor) -> torch.Tensor:
    """``[B, 1, F, T]`` complex -> ``[B, 2, F, T]`` real."""
    return torch.cat([y.real, y.imag], dim=1)


def snr_from_normalized_wav(net: torch.nn.Module, y_n: torch.Tensor, window: torch.Tensor,
                            n_fft: int, hop_length: int) -> torch.Tensor:
    """Normalised waveforms ``[B, samples]`` -> amplitude-ratio SNR ``[B]``:
    raw STFT, two real channels, time padded to 16, SNRNet, ``g / (1 - g)``."""
    spec = stft(y_n, window, n_fft, hop_length)
    est_gt = net(pad_spec_16(complex_to_2ch(spec[:, None])))[:, 0]
    return est_gt / (1 - est_gt)


class SNRModel:
    """SNR estimator wrapper.

    Args:
        config: hyperparameters.
        device: where SNRNet's weights live and estimation runs: the card
            unless given (``"cpu"`` for the CPU); raises without a CUDA device.
        dnn: an SNRNet to use (moved to ``device``); a fresh one when None.
    """

    _complex_to_2ch = staticmethod(complex_to_2ch)

    def __init__(self, config: SNRModelConfig = SNRModelConfig(), device="cuda",
                 dnn: Optional[SNRNet] = None):
        self.cfg = config
        self.device = model_device(device)
        self.dnn = (dnn if dnn is not None else SNRNet()).to(self.device).eval()
        self.stft_cfg = StftConfig(n_fft=config.n_fft, hop_length=config.hop_length,
                                   window=config.window)
        self._window = get_window(config.window, config.n_fft, device=self.device)

    @torch.no_grad()
    def forward(self, y_spec2ch: torch.Tensor) -> torch.Tensor:
        """y_spec2ch: ``[B, 2, F, T]`` real/imag channels -> ``[B, 1]`` g_hat."""
        return self.dnn(y_spec2ch)

    @torch.no_grad()
    def estimate_from_wav(self, y_wav: torch.Tensor) -> torch.Tensor:
        """Waveform ``[B, samples]`` -> estimated amplitude-ratio SNR ``[B]``,
        normalised by the max-abs of the whole batch as the JAX package does."""
        y_wav = torch.as_tensor(y_wav, dtype=torch.float32).to(self.device)
        return snr_from_normalized_wav(self.dnn, y_wav / torch.max(torch.abs(y_wav)),
                                       self._window, self.stft_cfg.n_fft,
                                       self.stft_cfg.hop_length)
