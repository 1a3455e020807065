"""Evaluation-time enhancement and streaming (port of diffse_tpu/evaluation:
``inference.py``'s ``spec_sample``, ``_eval_fn`` and ``eval_enhance_file``,
and ``streaming.py``; ``evaluate_model`` and the metrics come with the
evaluation package)."""

from .inference import BRANCHES, eval_enhance_file, spec_sample
from .streaming import enhance_streamed, enhance_streamed_packed, enhance_streamed_spec

__all__ = [
    "BRANCHES",
    "spec_sample",
    "eval_enhance_file",
    "enhance_streamed",
    "enhance_streamed_spec",
    "enhance_streamed_packed",
]
