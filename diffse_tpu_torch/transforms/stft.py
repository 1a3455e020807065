"""STFT / iSTFT (port of diffse_tpu/transforms/stft.py).

The JAX package reproduces ``torch.stft`` semantics by hand; here they are
``torch.stft``/``torch.istft`` themselves: center=True with reflect padding,
a periodic Hann window of length n_fft, one-sided (n_fft//2 + 1 bins).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT parameters (defaults: n_fft 510, hop 128, Hann -> 256 bins)."""

    n_fft: int = 510
    hop_length: int = 128
    window: str = "hann"

    @property
    def num_freq_bins(self) -> int:
        return self.n_fft // 2 + 1


def hann_window(window_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, computed in float64 and rounded to float32 (as
    the JAX package builds it)."""
    return torch.hann_window(window_length, periodic=True, dtype=torch.float64,
                             device=device).float()


def stft(sig: torch.Tensor, window: torch.Tensor, n_fft: int = 510,
         hop_length: int = 128) -> torch.Tensor:
    """Real ``[..., L]`` -> complex64 ``[..., n_fft//2 + 1, 1 + L//hop]``."""
    shape = sig.shape[:-1]
    spec = torch.stft(sig.reshape(-1, sig.shape[-1]), n_fft=n_fft,
                      hop_length=hop_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.reshape(shape + spec.shape[-2:])


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int = 510,
          hop_length: int = 128) -> torch.Tensor:
    """Complex ``[..., F, T]`` -> real ``[..., hop * (T - 1)]``."""
    shape = spec.shape[:-2]
    out = torch.istft(spec.reshape((-1,) + spec.shape[-2:]), n_fft=n_fft,
                      hop_length=hop_length, window=window, center=True)
    return out.reshape(shape + out.shape[-1:])
