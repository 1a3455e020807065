from .stft import StftConfig, hann_window, istft, stft
from .spec import (
    SpecTransformConfig,
    pad_spec,
    pad_spec_16,
    spec_back,
    spec_fwd,
    width_bucket,
)

__all__ = [
    "StftConfig",
    "hann_window",
    "stft",
    "istft",
    "SpecTransformConfig",
    "spec_fwd",
    "spec_back",
    "pad_spec",
    "pad_spec_16",
    "width_bucket",
]
