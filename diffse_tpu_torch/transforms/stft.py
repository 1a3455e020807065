"""STFT / iSTFT (port of diffse_tpu/transforms/stft.py).

The JAX package reproduces ``torch.stft`` semantics by hand; here the STFT
is ``torch.stft`` itself and the iSTFT ``torch.istft``'s own operations:
center=True with reflect padding, a periodic Hann window (or its square
root, "sqrthann") of length n_fft, one-sided (n_fft//2 + 1 bins).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def _hann(window_length: int) -> np.ndarray:
    n = np.arange(window_length)
    return np.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length), dtype=np.float32)


def hann_window(window_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, ``0.5 - 0.5 cos(2 pi n / N)`` in float64 numpy
    rounded to float32: the JAX package's window, bit for bit
    (``torch.hann_window`` rounds a few elements the other way)."""
    return torch.from_numpy(_hann(window_length)).to(device)


def sqrthann_window(window_length: int, device=None) -> torch.Tensor:
    """Square root of the periodic Hann window, numpy's float32 root, as the
    JAX package takes it (torch's CPU root rounds a few the other way)."""
    return torch.from_numpy(np.sqrt(_hann(window_length))).to(device)


def get_window(window_type: str, window_length: int, device=None) -> torch.Tensor:
    """The analysis/synthesis window by name: "hann" or "sqrthann"."""
    if window_type == "sqrthann":
        return sqrthann_window(window_length, device=device)
    if window_type == "hann":
        return hann_window(window_length, device=device)
    raise NotImplementedError(f"Window type {window_type} not implemented!")


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
    """Complex ``[..., F, T]`` -> real ``[..., hop * (T - 1)]``.

    ``torch.istft``'s operations (center=True): per-frame inverse real FFT,
    window, overlap-add, division by the overlap-added squared window, the
    centre padding trimmed; so the same bits. ``torch.istft`` reads the
    smallest envelope value back to the host to check that it is not zero,
    which blocks the host and cannot be captured in a CUDA graph; here the
    device checks it (``torch._assert_async``)."""
    shape = spec.shape[:-2]
    spec = spec.reshape((-1,) + spec.shape[-2:])
    frames = spec.shape[-1]
    length = n_fft + hop_length * (frames - 1)
    y = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    y = torch.ops.aten.unfold_backward(y, [y.shape[0], length], 1, n_fft, hop_length)
    envelope = torch.ops.aten.unfold_backward(window.pow(2).expand(1, frames, n_fft),
                                              [1, length], 1, n_fft, hop_length)
    start, end = n_fft // 2, length - n_fft // 2
    envelope = envelope[:, start:end]
    torch._assert_async(envelope.abs().min() >= 1e-11,
                        "istft: the window's overlap-add envelope has a zero")
    out = y[:, start:end] / envelope
    return out.reshape(shape + out.shape[-1:])
