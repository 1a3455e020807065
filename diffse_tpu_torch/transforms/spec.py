"""Spectrogram compression transforms and padding helpers (port of
diffse_tpu/transforms/spec.py)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SpecTransformConfig:
    transform_type: str = "exponent"  # "exponent" | "log" | "none"
    spec_factor: float = 0.15
    spec_abs_exponent: float = 0.5


def _polar(mag: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """New magnitude with the phase of ``spec``, as ``mag * spec/|spec|``
    (0/0 guarded), the same formulation as the JAX package."""
    abs_spec = torch.abs(spec)
    safe = torch.where(abs_spec == 0, torch.ones_like(abs_spec), abs_spec)
    return (mag / safe) * spec


def spec_fwd(spec: torch.Tensor, cfg: SpecTransformConfig = SpecTransformConfig()) -> torch.Tensor:
    """Forward (compression) transform: |c|^e * exp(i angle(c)) * factor."""
    if cfg.transform_type == "exponent":
        if cfg.spec_abs_exponent != 1:
            spec = _polar(torch.abs(spec) ** cfg.spec_abs_exponent, spec)
        spec = spec * cfg.spec_factor
    elif cfg.transform_type == "log":
        spec = _polar(torch.log1p(torch.abs(spec)), spec) * cfg.spec_factor
    elif cfg.transform_type != "none":
        raise ValueError(f"Unknown transform_type {cfg.transform_type}")
    return spec


def spec_back(spec: torch.Tensor, cfg: SpecTransformConfig = SpecTransformConfig()) -> torch.Tensor:
    """Inverse (expansion) transform of :func:`spec_fwd`."""
    if cfg.transform_type == "exponent":
        spec = spec / cfg.spec_factor
        if cfg.spec_abs_exponent != 1:
            spec = _polar(torch.abs(spec) ** (1 / cfg.spec_abs_exponent), spec)
    elif cfg.transform_type == "log":
        spec = spec / cfg.spec_factor
        spec = _polar(torch.expm1(torch.abs(spec)), spec)
    elif cfg.transform_type != "none":
        raise ValueError(f"Unknown transform_type {cfg.transform_type}")
    return spec


def _pad_time_axis(y: torch.Tensor, multiple: int) -> torch.Tensor:
    num_pad = (multiple - y.shape[-1] % multiple) % multiple
    if num_pad == 0:
        return y
    return F.pad(y, (0, num_pad))


def pad_spec(y: torch.Tensor) -> torch.Tensor:
    """Zero-pad the time (last) axis to a multiple of 64: the NCSN++ U-Net
    downsamples six times."""
    return _pad_time_axis(y, 64)


def pad_spec_16(y: torch.Tensor) -> torch.Tensor:
    """Zero-pad the time (last) axis to a multiple of 16: SNRNet's input
    contract (16-frame clusters)."""
    return _pad_time_axis(y, 16)


def width_bucket(t_orig: int, hop_length: int):
    """Frames padded up to a multiple of 64 and the bucket's exact sample
    count: ``(t_pad_frames, pad_samples)``, the JAX package's host pad
    contract (``pad_samples`` can be up to hop-1 shorter than ``t_orig``)."""
    frames = 1 + t_orig // hop_length
    t_pad = frames + (64 - frames % 64) % 64
    return t_pad, (t_pad - 1) * hop_length
