"""Small shared helpers (the model device, random sampling, broadcasting,
device timing, float32 precision)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def model_device(device="cuda") -> torch.device:
    """The device a model's weights live and run on: the card unless the
    caller names another. Asking for CUDA on a machine without a CUDA device
    raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by default; "
                           "pass device=\"cpu\" to run on the CPU")
    return device


def randn_like(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard normal noise shaped like ``x``, drawn from ``generator``.

    For complex dtypes this is CN(0, 1), torch's complex ``randn``: real and
    imaginary parts each have variance 1/2 (so E|z|^2 = 1), as
    ``diffse_tpu.utils.randn_like`` reproduces on the JAX side."""
    return torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=generator)


def bc(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a`` with trailing singleton axes added to broadcast against ``x``."""
    return a.reshape(a.shape + (1,) * (x.ndim - a.ndim))


def queued_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn`` in ms on the current CUDA device:
    ``reps`` calls enqueued behind a sleep on the card, so that they run back
    to back whatever the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than the host takes to enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def float32_precision(device):
    """Run cuDNN convolutions and CUDA matmuls in full float32 (no TF32) inside
    the block when ``device`` is a CUDA device, whatever the process-wide
    setting (cuDNN's default allows TF32), and restore that setting after.
    On other devices it changes nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
