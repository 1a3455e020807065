"""Shared backbone utilities (port of diffse_tpu/models/shared.py): the
backbone registry, the time embeddings and the complex-valued wrappers that
DCUNet builds on.

Feature maps are NCHW; a complex layer takes a complex tensor and runs two
real layers ``re`` and ``im`` by the complex multiplication rule
``F(a + ib) = (re(a) - im(b)) + i(re(b) + im(a))``. Parameter names follow
the JAX package's modules (flax ``kernel`` -> torch ``weight``, laid out as
torch lays it), so that ``convert.dcunet_state_dict_from_jax`` maps a flax
tree by its paths.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.convt import conv_transpose2d, output_padding_for, stuffed_conv2d
from ..parallel.sequence import current_frames, split_bounds
from ..registry import Registry

BackboneRegistry = Registry("Backbone")


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default kernel initialiser: a normal of variance 1/fan_in,
    truncated at two standard deviations (and rescaled for the cut)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator] = None) -> nn.Linear:
    """flax's ``nn.Dense`` at its defaults: lecun-normal weight, zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    lecun_normal_(lin.weight, in_dim, generator)
    nn.init.zeros_(lin.bias)
    return lin


class GaussianFourierProjection(nn.Module):
    """Gaussian random features of the time: ``[sin(2 pi t W), cos(2 pi t
    W)]`` over ``embed_dim // 2`` frozen frequencies W ~ N(0, scale^2), or
    ``exp(2 pi i t W)`` over ``embed_dim`` of them with ``complex_valued``;
    complex output either way (the JAX package embeds the time as complex64,
    whose imaginary part is zero)."""

    def __init__(self, embed_dim: int, scale: float = 16.0, complex_valued: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.complex_valued = complex_valued
        n = embed_dim if complex_valued else embed_dim // 2
        self.W = nn.Parameter(torch.randn(n, generator=generator) * scale, requires_grad=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t_proj = t.float()[:, None] * self.W[None, :] * 2 * math.pi
        if self.complex_valued:
            return torch.complex(torch.cos(t_proj), torch.sin(t_proj))
        emb = torch.cat([torch.sin(t_proj), torch.cos(t_proj)], dim=-1)
        return torch.complex(emb, torch.zeros_like(emb))


class DiffusionStepEmbedding(nn.Module):
    """DiffWave's diffusion-step embedding: ``[sin(t f), cos(t f)]`` over
    ``embed_dim // 2`` frequencies f = 10^(4 k / (n - 1)), or ``exp(i t f)``
    over ``embed_dim`` of them with ``complex_valued``; complex output."""

    def __init__(self, embed_dim: int, complex_valued: bool = False):
        super().__init__()
        self.complex_valued = complex_valued
        self.n = embed_dim if complex_valued else embed_dim // 2

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        n = self.n
        fac = torch.pow(10.0, 4 * torch.arange(n, device=t.device) / (n - 1)).float()
        inner = t.float()[:, None] * fac[None, :]
        if self.complex_valued:
            return torch.complex(torch.cos(inner), torch.sin(inner))
        emb = torch.cat([torch.sin(inner), torch.cos(inner)], dim=-1)
        return torch.complex(emb, torch.zeros_like(emb))


class ComplexLinear(nn.Module):
    """A complex linear layer from two real ones (``re``, ``im``); with
    ``complex_valued=False`` one real layer ``lin``."""

    def __init__(self, in_dim: int, out_dim: int, complex_valued: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.complex_valued = complex_valued
        if complex_valued:
            self.re = dense(in_dim, out_dim, generator)
            self.im = dense(in_dim, out_dim, generator)
        else:
            self.lin = dense(in_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.complex_valued:
            return self.lin(x)
        a, b = x.real, x.imag
        return torch.complex(self.re(a) - self.im(b), self.re(b) + self.im(a))


class FeatureMapDense(nn.Module):
    """A (complex) linear layer whose output is broadcast over a feature
    map: ``[B, C] -> [B, C, 1, 1]``."""

    def __init__(self, in_dim: int, out_dim: int, complex_valued: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ComplexLinear_0 = ComplexLinear(in_dim, out_dim, complex_valued, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ComplexLinear_0(x)[:, :, None, None]


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, Sequence) else (v, v)


class ComplexConv2d(nn.Module):
    """A complex conv from two real convs ``re`` and ``im`` (torch's
    ``nn.Conv2d``, their biases optional), run as one real conv: the real and
    imaginary parts stacked on the batch, the two weights on the output
    channels.

    On a frames shard (``parallel.sequence.current_frames``) ``forward``
    takes the column bounds over the ranks of the whole map of which x is
    this rank's part (``bounds``) and computes this rank's part of the whole
    output, split by ``out_bounds``: output column ``o`` reads the input
    columns ``o * s - p`` through ``o * s - p + d * (k - 1)`` along the
    frames (stride s, padding p, dilation d, kernel k), so the rank's first
    output column lies on the global stride grid; those columns come from
    the ranks holding them (``FramesShard.columns``), zeros past the global
    edges, where the explicit padding applies, and the conv runs unpadded
    along the frames."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0),
                 dilation=(1, 1), bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding, self.dilation = _pair(stride), _pair(padding), _pair(dilation)
        self.re = nn.Conv2d(in_ch, out_ch, (kh, kw), self.stride, self.padding, self.dilation,
                            bias=bias)
        self.im = nn.Conv2d(in_ch, out_ch, (kh, kw), self.stride, self.padding, self.dilation,
                            bias=bias)
        for conv in (self.re, self.im):
            lecun_normal_(conv.weight, in_ch * kh * kw, generator)
            if bias:
                nn.init.zeros_(conv.bias)

    def out_width(self, width: int) -> int:
        """The output's frames from an input ``width`` frames wide."""
        k, s, p, d = self.re.kernel_size[1], self.stride[1], self.padding[1], self.dilation[1]
        return (width + 2 * p - d * (k - 1) - 1) // s + 1

    def out_bounds(self, bounds: tuple) -> tuple:
        """The output's split over the ranks from the input's ``bounds``."""
        return split_bounds(self.out_width(bounds[-1]), len(bounds) - 1)

    def forward(self, x: torch.Tensor, bounds: Optional[tuple] = None) -> torch.Tensor:
        batch, out_ch = x.shape[0], self.re.out_channels
        bias = None if self.re.bias is None else torch.cat([self.re.bias, self.im.bias])
        xs, padding = torch.cat([x.real, x.imag]), self.padding
        if bounds is not None:
            k, s, p, d = (self.re.kernel_size[1], self.stride[1], self.padding[1],
                          self.dilation[1])
            out = self.out_bounds(bounds)
            spans = [(o0 * s - p, (o1 - 1) * s - p + d * (k - 1) + 1)
                     for o0, o1 in zip(out, out[1:])]
            xs, padding = current_frames().columns(xs, bounds, spans, dim=3), (padding[0], 0)
        y = F.conv2d(xs, torch.cat([self.re.weight, self.im.weight]), bias, self.stride,
                     padding, self.dilation)
        re_a, im_a = y[:batch, :out_ch], y[:batch, out_ch:]
        re_b, im_b = y[batch:, :out_ch], y[batch:, out_ch:]
        return torch.complex(re_a - im_b, re_b + im_a)


class ComplexConvTranspose2d(nn.Module):
    """A complex transposed conv with torch's output-size semantics
    (``ops.convt``): weights ``w_re``, ``w_im`` ``[Cin, Cout, kh, kw]``,
    optional biases ``b_re``, ``b_im``; run as one real transposed conv, as
    ``ComplexConv2d``. ``forward(x, output_size)`` picks the output padding
    that gives ``output_size``.

    On a frames shard, as ``ComplexConv2d`` (``bounds``: the input's split;
    the output split by ``split_bounds`` of its width): the forward conv on
    the zero-stuffed input (``ops.convt``) reads, for output column ``o``,
    stuffed columns ``o - lo`` through ``o - lo + d * (k - 1)`` (``lo = d *
    (k - 1) - p``, the stuffed map's padding before), so a rank's part of
    the output reads the input columns from ``ceil((o0 - lo) / s)`` through
    ``floor((o1 - 1 - lo + d * (k - 1)) / s)``; it stuffs those, pads them
    so that its first output column is ``o0`` (the output padding reaches
    only the rank at the global right edge) and runs the same forward
    conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.output_padding, self.dilation = _pair(output_padding), _pair(dilation)
        kh, kw = self.kernel_size
        self.w_re = nn.Parameter(torch.empty(in_ch, out_ch, kh, kw))
        self.w_im = nn.Parameter(torch.empty(in_ch, out_ch, kh, kw))
        for w in (self.w_re, self.w_im):
            lecun_normal_(w, in_ch * kh * kw, generator)
        if bias:
            self.b_re = nn.Parameter(torch.zeros(out_ch))
            self.b_im = nn.Parameter(torch.zeros(out_ch))
        else:
            self.b_re = self.b_im = None

    def forward(self, x: torch.Tensor, output_size=None,
                bounds: Optional[tuple] = None) -> torch.Tensor:
        size = x.shape[2:] if bounds is None else (x.shape[2], bounds[-1])
        op = self.output_padding
        if output_size is not None:
            op = output_padding_for(size, output_size, self.kernel_size, self.stride,
                                    self.padding, self.dilation)
        batch, out_ch = x.shape[0], self.w_re.shape[1]
        xs, w = torch.cat([x.real, x.imag]), torch.cat([self.w_re, self.w_im], 1)
        if bounds is None:
            y = conv_transpose2d(xs, w, self.stride, self.padding, op, self.dilation)
        else:
            y = self._frames_forward(xs, w, bounds, op)
        re_a, im_a = y[:batch, :out_ch], y[:batch, out_ch:]
        re_b, im_b = y[batch:, :out_ch], y[batch:, out_ch:]
        re, im = re_a - im_b, re_b + im_a
        if self.b_re is not None:
            re = re + self.b_re[None, :, None, None]
            im = im + self.b_im[None, :, None, None]
        return torch.complex(re, im)

    def out_width(self, width: int, output_padding: int) -> int:
        """The output's frames from an input ``width`` frames wide."""
        k, s, p, d = self.kernel_size[1], self.stride[1], self.padding[1], self.dilation[1]
        return (width - 1) * s - 2 * p + d * (k - 1) + 1 + output_padding

    def _frames_forward(self, xs: torch.Tensor, w: torch.Tensor, bounds: tuple,
                        op) -> torch.Tensor:
        """This rank's part of the transposed conv of the real map ``xs``
        split at ``bounds`` (the class's docstring)."""
        seq = current_frames()
        (kh, k), (s, p, d) = self.kernel_size, (self.stride[1], self.padding[1],
                                                self.dilation[1])
        width, reach = bounds[-1], d * (k - 1)
        lo = reach - p
        out = split_bounds(self.out_width(width, op[1]), seq.count)
        spans = [(max(0, -(-(o0 - lo) // s)), min(width, (o1 - 1 - lo + reach) // s + 1))
                 for o0, o1 in zip(out, out[1:])]
        (a, b), o0, o1 = spans[seq.index], out[seq.index], out[seq.index + 1]
        if b <= a:
            raise ValueError(f"output columns [{o0}, {o1}) read no input column")
        xs = seq.columns(xs, bounds, spans, dim=3)
        left = a * s - (o0 - lo)
        right = (o1 - o0 + reach) - left - ((b - a - 1) * s + 1)
        lo_h = self.dilation[0] * (kh - 1) - self.padding[0]
        return stuffed_conv2d(xs, w, self.stride, (lo_h, lo_h + op[0]), (left, right),
                              self.dilation)
