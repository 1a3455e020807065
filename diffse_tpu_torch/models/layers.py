"""NCSN++ layers as torch ``nn.Module``s (port of diffse_tpu/models/layers.py).

Feature maps are NCHW tensors kept in ``channels_last`` memory, so that the
NHWC view the CUDA kernels take (``x.permute(0, 2, 3, 1)``) is contiguous and
free. Parameter names and shapes follow the reference torch NCSN++ (conv
weights OIHW, Linear ``[out, in]``, GroupNorm ``weight``/``bias``, NIN ``W``
``[in, units]``), so that the converter's state_dict loads with strict=True.

Every GroupNorm runs through a hand-written kernel on the card
(ops/cuda_kernels.py): the plain blocks' two GroupNorm -> SiLU -> conv3x3
chains through ``groupnorm_silu_conv3x3`` (with the conditioning bias and the
1/sqrt(2) residual in its epilogue), the resampling blocks' and the attention
blocks' GroupNorms through ``groupnorm_silu``. The remaining convolutions
(stem, 1x1 shortcuts, Combine, the resampling blocks' convs, output layer) and
the attention einsums are plain PyTorch, as the JAX package leaves them to XLA.

The bf16 trunk (``NCSNpp(dtype="bf16")``) keeps the parameters in float32 and
computes where the JAX package's bf16 path does (diffse_tpu/models/layers.py):
activations cross memory in bfloat16; convs and the blocks' dense layers take
bf16 operands, sum in float32 and round once, then add their bias in bf16
(``conv``, ``dense``, as flax's ``nn.Conv``/``nn.Dense`` with ``dtype``);
GroupNorm statistics, the attention's norm, q/k/v and softmax stay float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_kernels import groupnorm_silu, groupnorm_silu_conv3x3
from ..ops.fir import downsample_2d, upsample_2d
from ..utils import round_once


# The repo's NCSN++ configuration: FIR [1,3,3,1] resampling, residual sums
# rescaled by 1/sqrt(2), last convs of each block initialised at scale 0.
FIR_KERNEL = (1, 3, 3, 1)
SKIP_COEF = 1.0 / math.sqrt(2.0)


def num_groups_for(channels: int) -> int:
    """GroupNorm(min(C//4, 32)), the NCSN++ convention."""
    return min(channels // 4, 32)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (a free view for channels_last maps)."""
    return x.permute(0, 2, 3, 1).contiguous()


def from_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


def default_init_(weight: torch.Tensor, scale: float = 1.0,
                  generator: Optional[torch.Generator] = None) -> None:
    """DDPM initializer: variance_scaling(scale, fan_avg, uniform); scale=0 is
    clamped to 1e-10 so final convs start near zero."""
    scale = 1e-10 if scale == 0 else scale
    if weight.ndim == 2:  # Linear [out, in]
        fan_out, fan_in = weight.shape
    else:  # Conv [out, in, kh, kw]
        rf = weight[0, 0].numel()
        fan_out, fan_in = weight.shape[0] * rf, weight.shape[1] * rf
    bound = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def ddpm_conv(in_ch: int, out_ch: int, kernel: int, init_scale: float = 1.0,
              generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
    default_init_(conv.weight, init_scale, generator)
    nn.init.zeros_(conv.bias)
    return conv


def ddpm_dense(in_dim: int, out_dim: int,
               generator: Optional[torch.Generator] = None) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    default_init_(lin.weight, 1.0, generator)
    nn.init.zeros_(lin.bias)
    return lin


def conv(module: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``module(x)`` computed in ``dtype``, as flax's ``nn.Conv(dtype=...)``
    does: x and the weight cast to ``dtype``, the conv rounded to it once,
    then the bias (cast to ``dtype``) added in ``dtype``. Float32 is the
    module's own call."""
    if dtype == torch.float32:
        return module(x)
    y = round_once(lambda a, w: F.conv2d(a, w, stride=module.stride, padding=module.padding),
                   x.to(dtype), module.weight.to(dtype))
    return y + module.bias.to(dtype)[None, :, None, None]


def dense(module: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``module(x)`` computed in ``dtype``, as flax's ``nn.Dense(dtype=...)``
    does (see ``conv``)."""
    if dtype == torch.float32:
        return module(x)
    y = round_once(lambda a, w: a @ w.t(), x.to(dtype), module.weight.to(dtype))
    return y + module.bias.to(dtype)


def residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``(x + h) / sqrt(2)`` in x's dtype. The JAX package divides by the
    Python float sqrt(2), a weakly typed scalar that takes the array's dtype:
    in bfloat16 the divisor is bf16(sqrt(2)) = 1.4140625, and so it is here."""
    return (x + h) / float(torch.tensor(math.sqrt(2.0), dtype=x.dtype))


def hwio_memory_(conv: nn.Conv2d) -> nn.Conv2d:
    """Store a conv's OIHW weight in HWIO memory order, so that ``conv_hwio``
    is a free view. The shape and the state_dict stay OIHW; ``.to()``,
    ``load_state_dict`` and ``deepcopy`` keep the strides."""
    w = conv.weight.detach().permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    conv.weight = nn.Parameter(w, requires_grad=conv.weight.requires_grad)
    return conv


def conv_hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's OIHW weight as the contiguous HWIO array the kernel takes: a
    view for weights in HWIO memory (``hwio_memory_``), otherwise a copy."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()


class GroupNorm(nn.Module):
    """GroupNorm's parameters (``weight``, ``bias``) with the NCSN++ group
    count and eps 1e-6; calling it runs GroupNorm (+SiLU) through
    ``groupnorm_silu`` (float32 statistics as E[x^2] - mu^2), output in x's
    dtype or ``out_dtype``."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups_for(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, apply_silu: bool = True,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out = groupnorm_silu(to_nhwc(x), self.weight, self.bias, self.num_groups,
                             self.eps, apply_silu, out_dtype)
        return from_nhwc(out)


class NIN(nn.Module):
    """Network-in-network 1x1 channel mixing: ``x @ W + b`` over channels."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.zeros(num_units))
        # flax variance_scaling on an [in, units] kernel: fan_in=in, fan_out=units
        default_init_(self.W.data.T, init_scale, generator)

    def forward_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.W + self.b


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the (log) noise level; the frozen ``W``
    gives a ``2 * embedding_size`` output."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = torch.randn(embedding_size, generator=generator) * scale
        self.W = nn.Parameter(w, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
    """Combine the input pyramid into the trunk: ``Conv_0(x) + y`` (sum), in
    the trunk's dtype (y's)."""

    def __init__(self, dim1: int, dim2: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = ddpm_conv(dim1, dim2, 1, generator=generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return conv(self.Conv_0, x, y.dtype) + y


class AttnBlockpp(nn.Module):
    """Dense spatial self-attention over HW tokens:
    ``(x + NIN_3(softmax(q k^T / sqrt(C)) v)) / sqrt(2)``. For a bfloat16 x
    the norm, q, k, v and softmax are float32; the attended map is rounded
    to bf16 before ``NIN_3`` (float32 maths on it) and after, and the
    residual sum is bf16, as in the JAX package."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels)
        self.NIN_0 = NIN(channels, channels, generator=generator)
        self.NIN_1 = NIN(channels, channels, generator=generator)
        self.NIN_2 = NIN(channels, channels, generator=generator)
        self.NIN_3 = NIN(channels, channels, init_scale=0.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = to_nhwc(self.GroupNorm_0(x, apply_silu=False, out_dtype=torch.float32))
        h = h.reshape(b, hh * ww, c)
        q, k, v = self.NIN_0.forward_nhwc(h), self.NIN_1.forward_nhwc(h), self.NIN_2.forward_nhwc(h)
        w = torch.bmm(q, k.transpose(1, 2)) * (int(c) ** (-0.5))
        w = torch.softmax(w, dim=-1)
        h = torch.bmm(w, v).to(x.dtype).float()
        h = self.NIN_3.forward_nhwc(h).to(x.dtype).reshape(b, hh, ww, c)
        return from_nhwc(residual(to_nhwc(x), h))


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN-style residual block with in-block FIR up/down-sampling.

    Plain blocks run both GroupNorm -> SiLU -> conv3x3 chains as one kernel
    each: the first with bias ``Conv_0.bias + Dense_0(SiLU(temb))`` (plus
    ``Dense_1(SiLU(semb))`` in the SNR-conditioned variant), the second with
    the residual ``(x' + h) / sqrt(2)`` in its epilogue. Up/down blocks run
    GroupNorm+SiLU, FIR resampling, then the conv (the resampling sits between
    norm and conv, so they cannot be fused), with the embeddings added after
    ``Conv_0``.

    ``dtype`` is the block's compute dtype: its input is cast to it, and in
    bfloat16 the whole block runs in it (the dense layers too, whose output
    goes into the fused chain's float32 bias)."""

    def __init__(self, in_ch: int, out_ch: Optional[int], temb_dim: int, up: bool = False,
                 down: bool = False, semb_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.out_ch = out_ch
        self.compute_dtype = dtype
        self.up, self.down = up, down
        self.GroupNorm_0 = GroupNorm(in_ch)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3, generator=generator)
        self.Dense_0 = ddpm_dense(temb_dim, out_ch, generator)
        self.Dense_1 = ddpm_dense(semb_dim, out_ch, generator) if semb_dim else None
        self.GroupNorm_1 = GroupNorm(out_ch)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=0.0, generator=generator)
        if in_ch != out_ch or up or down:
            self.Conv_2 = ddpm_conv(in_ch, out_ch, 1, generator=generator)
        else:
            self.Conv_2 = None
        if not (up or down):  # both convs run inside the fused kernel
            hwio_memory_(self.Conv_0)
            hwio_memory_(self.Conv_1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                semb: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        x = x.to(dtype)
        batch = x.shape[0]
        temb_bias = dense(self.Dense_0, F.silu(temb), dtype)
        semb_bias = dense(self.Dense_1, F.silu(semb), dtype) if self.Dense_1 is not None else None
        if not (self.up or self.down):
            x_nhwc = to_nhwc(x)
            bias0 = self.Conv_0.bias[None, :] + temb_bias.float()
            if semb_bias is not None:
                bias0 = bias0 + semb_bias.float()
            bias0 = bias0.contiguous()
            h = groupnorm_silu_conv3x3(
                x_nhwc, self.GroupNorm_0.weight, self.GroupNorm_0.bias,
                conv_hwio(self.Conv_0), bias0,
                self.GroupNorm_0.num_groups, self.GroupNorm_0.eps)
            skip = (to_nhwc(conv(self.Conv_2, x, dtype)) if self.Conv_2 is not None
                    else x_nhwc)
            bias1 = self.Conv_1.bias[None, :].expand(batch, self.out_ch)
            out = groupnorm_silu_conv3x3(
                h, self.GroupNorm_1.weight, self.GroupNorm_1.bias, conv_hwio(self.Conv_1),
                bias1, self.GroupNorm_1.num_groups, self.GroupNorm_1.eps,
                skip=skip, skip_coef=SKIP_COEF)
            return from_nhwc(out)

        h = self.GroupNorm_0(x)
        resample = upsample_2d if self.up else downsample_2d
        h = resample(h, FIR_KERNEL, factor=2)
        x = resample(x, FIR_KERNEL, factor=2)
        h = conv(self.Conv_0, h, dtype) + temb_bias[:, :, None, None]
        if semb_bias is not None:
            h = h + semb_bias[:, :, None, None]
        h = conv(self.Conv_1, self.GroupNorm_1(h), dtype)
        return residual(conv(self.Conv_2, x, dtype), h)
