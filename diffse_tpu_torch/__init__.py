"""PyTorch/CUDA port of diffse_tpu for NVIDIA Hopper.

Same subpackage layout and module names as ``diffse_tpu`` (the JAX package,
which stays the reference). Importing this package imports no JAX.
"""
