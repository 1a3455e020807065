"""Ops: exponential integral, FIR resampling, the fused bias + LeakyReLU and
the hand-written CUDA kernels."""
