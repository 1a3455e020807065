"""Legacy NCSNv1/v2 layer library (port of diffse_tpu/models/layers_legacy.py):
the RefineNet-style CRP/RCU/MSF/Refine blocks and their conditional forms,
the pooling and upsampling convs, and the pre-"pp" AttnBlock and
ResnetBlockDDPM, as plain torch modules over NCHW maps.

No backbone of the repo uses these; they complete the model layer.
Submodules carry the JAX package's names (``conv_0``, ``1_1_conv``,
``adapt_0``, ``msf``, ``crp``, ``output_convs``, ``GroupNorm_0``, ``NIN_0``...)
so that a flax tree maps onto them by its paths
(``convert.flax_tree_state_dict``). Each module takes its input channel
counts, which flax infers from the input.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import NIN, KeepMask, ddpm_conv, ddpm_dense, dropout, num_groups_for
from .shared import lecun_normal_


def ncsn_conv(in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1, bias: bool = True,
              dilation: int = 1, init_scale: float = 1.0,
              generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    """A SAME conv with the NCSNv1/v2 initialisation: lecun-normal scaled by
    ``init_scale`` (1e-10 when 0)."""
    init_scale = 1e-10 if init_scale == 0 else init_scale
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=dilation * (kernel - 1) // 2,
                     dilation=dilation, bias=bias)
    lecun_normal_(conv.weight, in_ch * kernel * kernel, generator)
    with torch.no_grad():
        conv.weight.mul_(init_scale)
        if bias:
            conv.bias.zero_()
    return conv


def _pool5(x: torch.Tensor, maxpool: bool) -> torch.Tensor:
    """5x5 stride-1 SAME pooling; the mean counts the zero padding, as flax's
    ``avg_pool`` does."""
    if maxpool:
        return F.max_pool2d(x, 5, stride=1, padding=2)
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize(..., "bilinear")``'s weights along one axis
    (``[in, out]``): a triangle kernel at half-pixel centres, widened by the
    scale when shrinking (antialiasing), each column normalised."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def bilinear_resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """An NCHW map resized to ``shape`` as ``jax.image.resize`` (bilinear)
    resizes it."""
    wh = torch.from_numpy(_resize_weights(x.shape[2], shape[0])).to(x)
    ww = torch.from_numpy(_resize_weights(x.shape[3], shape[1])).to(x)
    return torch.einsum("bchw,hi,wj->bcij", x, wh, ww)


class CRPBlock(nn.Module):
    """Chained residual pooling."""

    def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
                 maxpool: bool = True):
        super().__init__()
        self.act, self.maxpool, self.n_stages = act, maxpool, n_stages
        for i in range(n_stages):
            setattr(self, f"conv_{i}", ncsn_conv(features, features, bias=False))

    def forward(self, x):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"conv_{i}")(_pool5(path, self.maxpool))
            x = path + x
        return x


class CondCRPBlock(nn.Module):
    """Conditional chained residual pooling (mean pooling after each
    class-conditional norm)."""

    def __init__(self, features: int, n_stages: int, num_classes: int, normalizer,
                 act: Callable = F.relu):
        super().__init__()
        self.act, self.n_stages = act, n_stages
        for i in range(n_stages):
            setattr(self, f"norm_{i}", normalizer(features, num_classes=num_classes))
            setattr(self, f"conv_{i}", ncsn_conv(features, features, bias=False))

    def forward(self, x, y):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            path = getattr(self, f"norm_{i}")(path, y)
            path = getattr(self, f"conv_{i}")(_pool5(path, maxpool=False))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv unit: ``n_blocks`` residual stacks of ``n_stages``
    act -> conv."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, act: Callable = F.relu):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"{i + 1}_{j + 1}_conv", ncsn_conv(features, features, bias=False))

    def forward(self, x):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class CondRCUBlock(nn.Module):
    """Conditional residual conv unit: norm -> act -> conv stages."""

    def __init__(self, features: int, n_blocks: int, n_stages: int, num_classes: int,
                 normalizer, act: Callable = F.relu):
        super().__init__()
        self.act, self.n_blocks, self.n_stages = act, n_blocks, n_stages
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"{i + 1}_{j + 1}_norm",
                                normalizer(features, num_classes=num_classes))
                self.add_module(f"{i + 1}_{j + 1}_conv", ncsn_conv(features, features, bias=False))

    def forward(self, x, y):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
                x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: each input through its conv, resized bilinearly to
    ``shape``, summed."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.n = len(in_planes)
        for i, c in enumerate(in_planes):
            setattr(self, f"conv_{i}", ncsn_conv(c, features, bias=True))

    def forward(self, xs, shape):
        sums = 0
        for i, xi in enumerate(xs):
            sums = sums + bilinear_resize(getattr(self, f"conv_{i}")(xi), shape)
        return sums


class CondMSFBlock(nn.Module):
    """Conditional multi-scale fusion (a class-conditional norm before each
    conv)."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer):
        super().__init__()
        for i, c in enumerate(in_planes):
            setattr(self, f"norm_{i}", normalizer(c, num_classes=num_classes))
            setattr(self, f"conv_{i}", ncsn_conv(c, features, bias=True))

    def forward(self, xs, y, shape):
        sums = 0
        for i, xi in enumerate(xs):
            h = getattr(self, f"conv_{i}")(getattr(self, f"norm_{i}")(xi, y))
            sums = sums + bilinear_resize(h, shape)
        return sums


class RefineBlock(nn.Module):
    """RefineNet block: RCU adapters -> MSF (several inputs) -> CRP ->
    output RCU."""

    def __init__(self, in_planes: Sequence[int], features: int, act: Callable = F.relu,
                 start: bool = False, end: bool = False, maxpool: bool = True):
        super().__init__()
        self.n = len(in_planes)
        for i, c in enumerate(in_planes):
            setattr(self, f"adapt_{i}", RCUBlock(c, 2, 2, act))
        self.msf = MSFBlock(in_planes, features) if self.n > 1 else None
        self.crp = CRPBlock(features, 2, act, maxpool=maxpool)
        self.output_convs = RCUBlock(features, 3 if end else 1, 2, act)

    def forward(self, xs, output_shape):
        hs = [getattr(self, f"adapt_{i}")(xi) for i, xi in enumerate(xs)]
        h = self.msf(hs, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
    """Conditional RefineNet block."""

    def __init__(self, in_planes: Sequence[int], features: int, num_classes: int, normalizer,
                 act: Callable = F.relu, start: bool = False, end: bool = False):
        super().__init__()
        self.n = len(in_planes)
        for i, c in enumerate(in_planes):
            setattr(self, f"adapt_{i}", CondRCUBlock(c, 2, 2, num_classes, normalizer, act))
        self.msf = (CondMSFBlock(in_planes, features, num_classes, normalizer)
                    if self.n > 1 else None)
        self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act)
        self.output_convs = CondRCUBlock(features, 3 if end else 1, 2, num_classes, normalizer,
                                         act)

    def forward(self, xs, y, output_shape):
        hs = [getattr(self, f"adapt_{i}")(xi, y) for i, xi in enumerate(xs)]
        h = self.msf(hs, y, output_shape) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h, y), y)


def _mean_pool2(h: torch.Tensor) -> torch.Tensor:
    """2x2 mean, summed in the JAX package's order."""
    return (h[:, :, ::2, ::2] + h[:, :, 1::2, ::2] + h[:, :, ::2, 1::2]
            + h[:, :, 1::2, 1::2]) / 4.0


class ConvMeanPool(nn.Module):
    """Conv, then a 2x2 mean pool (with ``adjust_padding`` the input padded
    by one row and column at the top and left first)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, biases: bool = True,
                 adjust_padding: bool = False):
        super().__init__()
        self.adjust_padding = adjust_padding
        self.conv = ncsn_conv(in_ch, features, kernel, bias=biases)

    def forward(self, x):
        if self.adjust_padding:
            x = F.pad(x, (1, 0, 1, 0))
        return _mean_pool2(self.conv(x))


class MeanPoolConv(nn.Module):
    """A 2x2 mean pool, then conv."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, biases: bool = True):
        super().__init__()
        self.conv = ncsn_conv(in_ch, features, kernel, bias=biases)

    def forward(self, x):
        return self.conv(_mean_pool2(x))


class UpsampleConv(nn.Module):
    """2x upsample, then conv. The JAX package pixel-shuffles four copies of
    the input, which repeats each value over its 2x2 cell: a nearest-neighbour
    upsample."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, biases: bool = True):
        super().__init__()
        self.conv = ncsn_conv(in_ch, features, kernel, bias=biases)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(num_groups_for(channels), channels, eps=1e-6)


class AttnBlock(nn.Module):
    """Pre-pp self-attention over all positions: ``x + NIN_3(softmax(q k^T /
    sqrt(C)) v)``, plain PyTorch."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = _group_norm(channels)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=0.0)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.NIN_0.forward_nhwc(h), self.NIN_1.forward_nhwc(h), self.NIN_2.forward_nhwc(h)
        w = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (int(c) ** (-0.5)), dim=-1)
        h = self.NIN_3.forward_nhwc(torch.bmm(w, v))
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class ResnetBlockDDPM(nn.Module):
    """Pre-pp DDPM residual block: GroupNorm -> act -> conv (+ ``Dense_0(act(temb))``)
    -> GroupNorm -> act -> dropout -> conv, plus the input (through ``NIN_0``,
    or the 3x3 ``Conv_2`` with ``conv_shortcut``, where the channels change).
    Plain PyTorch; dropout in training takes ``keep_mask`` (``layers.dropout``)."""

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, conv_shortcut: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.act, self.dropout = act, dropout
        self.GroupNorm_0 = _group_norm(in_ch)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3)
        self.Dense_0 = ddpm_dense(temb_dim, out_ch) if temb_dim else None
        self.GroupNorm_1 = _group_norm(out_ch)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=1e-10)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = ddpm_conv(in_ch, out_ch, 3)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x, temb=None, keep_mask: Optional[KeepMask] = None):
        h = self.Conv_0(self.act(self.GroupNorm_0(x)))
        if temb is not None and self.Dense_0 is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.act(self.GroupNorm_1(h))
        if self.training and self.dropout > 0:
            h = dropout(h, self.dropout, keep_mask)
        h = self.Conv_1(h)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        elif self.NIN_0 is not None:
            x = self.NIN_0.forward_nhwc(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + h
