"""Small shared helpers (the model device, host-to-device copies, random
sampling, broadcasting, device timing, float32 precision, bfloat16
arithmetic)."""

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


def forbid_capture(device: torch.device, what: str) -> None:
    """Raise when the current stream of CUDA ``device`` is being captured into
    a CUDA graph: ``what`` is state that outlives the call (a cache, a
    counter), and made inside a capture it would live in the graph's private
    memory pool. Such state is made by the warm-up before a capture
    (``capture.Program``)."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} would be created inside a CUDA graph capture; "
                           "run the program once before capturing it")


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` without blocking the host: a CPU tensor goes to a
    CUDA device from pinned memory by a non-blocking copy (a copy from
    pageable memory synchronises the stream)."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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


def trunk_dtype(dtype) -> torch.dtype:
    """The network's compute dtype from the JAX package's ``dtype`` keyword:
    None, "float32" or "f32" for float32; "bf16" or "bfloat16" for bfloat16
    (a torch dtype is taken as it is)."""
    if dtype in (None, "float32", "f32", torch.float32):
        return torch.float32
    if dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {dtype!r}: float32 or bf16")


def round_once(fn, *tensors: torch.Tensor) -> torch.Tensor:
    """``fn(*tensors)`` (a convolution or a matrix product) in the tensors'
    dtype, its products summed in float32 and the result rounded to that
    dtype once, as XLA computes a bfloat16 convolution or dot. On the card
    cuDNN and cuBLAS run bfloat16 that way; on the CPU ``fn`` runs in float32
    on the bfloat16 values (exact products) and the result is rounded, since
    torch's CPU bfloat16 convolution rounds otherwise. Float32 tensors go
    through ``fn`` as they are."""
    dtype = tensors[0].dtype
    if dtype == torch.float32 or tensors[0].device.type != "cpu":
        return fn(*tensors)
    return fn(*(t.float() for t in tensors)).to(dtype)
