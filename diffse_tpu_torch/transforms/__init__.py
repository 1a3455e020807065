from .stft import StftConfig, get_window, hann_window, istft, sqrthann_window, stft
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
    "sqrthann_window",
    "get_window",
    "stft",
    "istft",
    "SpecTransformConfig",
    "spec_fwd",
    "spec_back",
    "pad_spec",
    "pad_spec_16",
    "width_bucket",
]
