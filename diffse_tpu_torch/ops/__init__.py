"""Ops: exponential integral, FIR resampling and the hand-written CUDA kernels."""
