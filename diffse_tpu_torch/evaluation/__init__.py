"""The evaluation package (port of diffse_tpu/evaluation): the metrics
(numpy/scipy copies: SI-SDR, energy ratios, STOI/ESTOI, native wideband
PESQ), the eval harness (``spec_sample``, ``eval_enhance_file``,
``evaluate_model``), bucketed batches (``batch_eval``), the 9-SNR sweep
(``deep_inference``), the debug panel (``debug``) and the streaming
engines. The names exported are the JAX package's, plus the port's own
harness and streaming entry points."""

from .inference import BRANCHES, eval_enhance_file, evaluate_model, spec_sample
from .metrics import (
    HAS_PESQ,
    active_rms,
    calculate_normfac,
    calculate_snr,
    energy_ratios,
    estoi,
    hp_filter,
    mean_conf_int,
    mean_std,
    pesq_wb,
    print_mean_std,
    si_sdr,
    si_sdr_components,
    snr_dB,
    stoi,
)
from .streaming import enhance_streamed, enhance_streamed_packed, enhance_streamed_spec

__all__ = [
    "si_sdr",
    "si_sdr_components",
    "energy_ratios",
    "mean_conf_int",
    "mean_std",
    "print_mean_std",
    "hp_filter",
    "snr_dB",
    "active_rms",
    "calculate_snr",
    "calculate_normfac",
    "stoi",
    "estoi",
    "pesq_wb",
    "HAS_PESQ",
    "BRANCHES",
    "spec_sample",
    "eval_enhance_file",
    "evaluate_model",
    "enhance_streamed",
    "enhance_streamed_spec",
    "enhance_streamed_packed",
]
