"""DCUNet: the complex-valued U-Net backbone (port of
diffse_tpu/models/dcunet.py).

Four architectures (DCUNet-10/16/20, DilDCUNet-v2); complex convolutions and
transposed convolutions by the ``(f1(a) - f2(b)) + i(f1(b) + f2(a))`` rule,
each one real cuDNN call (``models/shared.py``); per-block (optionally
complex) time embeddings; real/imaginary-separate BatchNorm ("bN") or the
2x2-whitening ComplexBatchNorm ("CbN"). Maps are complex NCHW.

Contract: input complex ``[B, 2, F, T]`` (x_t and y as complex channels) with
``(F - 1)`` divisible by the encoder's frequency-stride product (8 for
DilDCUNet-v2: ``n_fft 512``, where the repo's default 510 raises) and
``(T - 1)`` padded or trimmed to the time-stride product.

Module and parameter names follow the JAX package's (``encoder_0.conv.re``,
``decoder_1.deconv.w_re``, ``embed_global_0``, ``output_layer``...), with
torch's layouts, so that ``convert.dcunet_state_dict_from_jax`` maps a flax
tree by its paths. The "bN" running statistics are buffers that update as
flax's ``BatchNorm`` updates them (``OnReImBatchNorm``); "CbN" normalises by
the batch's statistics in training and in evaluation alike, so a batch of
several requests is normalised across them, as in the JAX package.

Frames-parallel (``ScoreModel.enhance(seq_mesh=)``; the JAX package lets
GSPMD partition it): inside a frames shard every level is split unevenly
over the ranks (``parallel.sequence.split_bounds``), each complex conv and
transposed conv computing this rank's part of its output from the input
columns it reaches (``models/shared.py``); the input's pad or trim and the
output's crop happen at the global right edge; "bN" in evaluation is local
to each column; "CbN" whitens by the whole map's moments, all-reduced; the
time embedding and the skip concatenations are local.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import batch_mean
from ..parallel.sequence import current_frames, split_bounds
from ..utils import float32_precision
from .shared import (BackboneRegistry, ComplexConv2d, ComplexConvTranspose2d, ComplexLinear,
                     DiffusionStepEmbedding, GaussianFourierProjection)


def get_activation(name: str):
    if name == "silu":
        return F.silu
    if name == "relu":
        return F.relu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    raise NotImplementedError(f"Unknown activation: {name}")


def on_reim(fn, x: torch.Tensor) -> torch.Tensor:
    """A real function applied to the real and imaginary parts apart."""
    return torch.complex(fn(x.real), fn(x.imag))


def unet_decoder_args(encoders, *, skip_connections):
    """Decoder arguments derived from the encoder's."""
    decoder_args = []
    for enc_in, enc_out, k, s, p, d in reversed(encoders):
        skip_in = enc_out if (skip_connections and decoder_args) else 0
        decoder_args.append((enc_out + skip_in, enc_in, k, s, p, d))
    return tuple(decoder_args)


def make_unet_encoder_decoder_args(encoder_args, decoder_args):
    encoder_args = tuple(
        (in_ch, out_ch, tuple(k), tuple(s),
         tuple(n // 2 for n in k) if p == "auto" else tuple(p), tuple(d))
        for in_ch, out_ch, k, s, p, d in encoder_args)
    if decoder_args == "auto":
        decoder_args = unet_decoder_args(encoder_args, skip_connections=True)
    else:
        decoder_args = tuple(
            (in_ch, out_ch, tuple(k), tuple(s),
             tuple(n // 2 for n in k) if p == "auto" else p, tuple(d), op)
            for in_ch, out_ch, k, s, p, d, op in decoder_args)
    return encoder_args, decoder_args


DCUNET_ARCHITECTURES = {
    "DCUNet-10": make_unet_encoder_decoder_args(
        ((1, 32, (7, 5), (2, 2), "auto", (1, 1)),
         (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1))),
        "auto"),
    "DCUNet-16": make_unet_encoder_decoder_args(
        ((1, 32, (7, 5), (2, 2), "auto", (1, 1)),
         (32, 32, (7, 5), (2, 1), "auto", (1, 1)),
         (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1))),
        "auto"),
    "DCUNet-20": make_unet_encoder_decoder_args(
        ((1, 32, (7, 1), (1, 1), "auto", (1, 1)),
         (32, 32, (1, 7), (1, 1), "auto", (1, 1)),
         (32, 64, (7, 5), (2, 2), "auto", (1, 1)),
         (64, 64, (7, 5), (2, 1), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 1), "auto", (1, 1)),
         (64, 64, (5, 3), (2, 2), "auto", (1, 1)),
         (64, 90, (5, 3), (2, 1), "auto", (1, 1))),
        "auto"),
    # the architecture of the SGMSE / Interspeech paper
    "DilDCUNet-v2": make_unet_encoder_decoder_args(
        ((1, 32, (4, 4), (1, 1), "auto", (1, 1)),
         (32, 32, (4, 4), (1, 1), "auto", (1, 1)),
         (32, 32, (4, 4), (1, 1), "auto", (1, 1)),
         (32, 64, (4, 4), (2, 1), "auto", (2, 1)),
         (64, 128, (4, 4), (2, 2), "auto", (4, 1)),
         (128, 256, (4, 4), (2, 2), "auto", (8, 1))),
        "auto"),
}


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over a real NCHW
    map: in training, normalised by the batch's mean and (biased, E[x^2] -
    mu^2) variance, and the running statistics updated as ``0.9 * running +
    0.1 * batch`` (torch's ``BatchNorm2d`` would fold in the unbiased
    variance); in evaluation, normalised by the running statistics.
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, as flax computes it.
    The statistics are buffers with no update count. In a data-parallel step
    the batch's statistics are the global batch's (``parallel.mesh.batch_mean``),
    as GSPMD computes them for flax, so every rank keeps the same running
    statistics."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = batch_mean(x, (0, 2, 3))
            var = torch.clamp(batch_mean(x * x, (0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]


class OnReImBatchNorm(nn.Module):
    """"bN": one ``BatchNorm`` on the real part (``re``), one on the
    imaginary part (``im``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.re = BatchNorm(channels)
        self.im = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.complex(self.re(x.real), self.im(x.imag))


class ComplexBatchNorm(nn.Module):
    """"CbN": complex batch norm with 2x2 covariance whitening, always by the
    batch's statistics (the reference's ``track_running_stats=False``), the
    global batch's in a data-parallel step; on a frames shard the whole
    map's (``_frames_moments``), never the shard's own.
    ``Wri`` is kept as flax keeps it, drawn on [0, 1.8) and shifted by -0.9
    where it is used."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.Wrr = nn.Parameter(torch.ones(channels))
        self.Wri = nn.Parameter(torch.rand(channels, generator=generator) * 1.8)
        self.Wii = nn.Parameter(torch.ones(channels))
        self.Br = nn.Parameter(torch.zeros(channels))
        self.Bi = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(p):
            return p[None, :, None, None]

        wri = self.Wri - 0.9
        axes = (0, 2, 3)
        xr, xi = x.real, x.imag
        seq = current_frames()
        if seq is not None:
            mr, mi, vrr, vri, vii = _frames_moments(seq, xr, xi, axes)
            xr, xi = xr - mr, xi - mi
            vrr, vii = vrr + self.eps, vii + self.eps
        else:
            xr = xr - batch_mean(xr, axes, keepdim=True)
            xi = xi - batch_mean(xi, axes, keepdim=True)
            vrr = batch_mean(xr * xr, axes, keepdim=True) + self.eps
            vri = batch_mean(xr * xi, axes, keepdim=True)
            vii = batch_mean(xi * xi, axes, keepdim=True) + self.eps
        # the inverse matrix square root of [[vrr, vri], [vri, vii]]
        tau = vrr + vii
        delta = vrr * vii - vri * vri
        s = torch.sqrt(delta)
        t = torch.sqrt(tau + 2 * s)
        rst = 1.0 / (s * t)
        urr = (s + vii) * rst
        uii = (s + vrr) * rst
        uri = -vri * rst
        zrr = c(self.Wrr) * urr + c(wri) * uri
        zri = c(self.Wrr) * uri + c(wri) * uii
        zir = c(wri) * urr + c(self.Wii) * uri
        zii = c(wri) * uri + c(self.Wii) * uii
        yr = zrr * xr + zri * xi + c(self.Br)
        yi = zir * xr + zii * xi + c(self.Bi)
        return torch.complex(yr, yi)


def _frames_moments(seq, xr: torch.Tensor, xi: torch.Tensor, axes) -> tuple:
    """The whole map's means of ``xr`` and ``xi`` and their covariances
    ``(vrr, vri, vii)`` over ``axes``, of which each rank holds its frames:
    the five sums and the count of each rank, all-reduced in float64, then
    divided by the count (the covariances as E[ab] - E[a]E[b], exact enough
    in float64); float32 ``[1, C, 1, 1]`` each."""
    a, b = xr.double(), xi.double()
    count = torch.full_like(a.sum(axes), a.numel() / a.shape[1])
    sums = seq.sum(torch.stack([a.sum(axes), b.sum(axes), (a * a).sum(axes),
                                (a * b).sum(axes), (b * b).sum(axes), count]))
    sr, si, srr, sri, sii = sums[:5] / sums[5]
    moments = (sr, si, srr - sr * sr, sri - sr * si, sii - si * si)
    return tuple(m.float()[None, :, None, None] for m in moments)


def _norm(norm_type: str, channels: int, generator):
    if norm_type == "CbN":
        return ComplexBatchNorm(channels, generator=generator)
    if norm_type == "bN":
        return OnReImBatchNorm(channels)
    raise NotImplementedError(f"Unknown norm type: {norm_type}")


class TembLayer(nn.Module):
    """A block's time-embedding projection: ``temb_layers - 1`` complex
    linear layers (``lin_i``) with the activation, then ``fmd`` to the
    block's channels, the activation, broadcast over the map."""

    def __init__(self, embed_dim: int, out_ch: int, temb_layers: int, temb_activation: str,
                 generator=None):
        super().__init__()
        self.act = get_activation(temb_activation)
        self.n_lin = max(0, temb_layers - 1)
        for i in range(self.n_lin):
            setattr(self, f"lin_{i}", ComplexLinear(embed_dim, embed_dim, generator=generator))
        self.fmd = ComplexLinear(embed_dim, out_ch, generator=generator)

    def forward(self, t_embed: torch.Tensor) -> torch.Tensor:
        h = t_embed
        for i in range(self.n_lin):
            h = on_reim(self.act, getattr(self, f"lin_{i}")(h))
        return on_reim(self.act, self.fmd(h)[:, :, None, None])


class DCUNetComplexEncoderBlock(nn.Module):
    """Complex conv -> (+ time embedding) -> norm -> activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride, padding, dilation,
                 norm_type: str = "bN", activation: str = "leaky_relu",
                 embed_dim: Optional[int] = None, temb_layers: int = 1,
                 temb_activation: str = "silu", generator=None):
        super().__init__()
        self.conv = ComplexConv2d(in_ch, out_ch, kernel_size, stride, padding, dilation,
                                  bias=norm_type is None, generator=generator)
        self.embed_layer = (TembLayer(embed_dim, out_ch, temb_layers, temb_activation,
                                      generator) if embed_dim is not None else None)
        self.norm = _norm(norm_type, out_ch, generator)
        self.act = get_activation(activation)

    def forward(self, x, t_embed=None, bounds=None):
        """``bounds``: on a frames shard, x's split over the ranks."""
        y = self.conv(x, bounds)
        if self.embed_layer is not None and t_embed is not None:
            y = y + self.embed_layer(t_embed)
        return on_reim(self.act, self.norm(y))


class DCUNetComplexDecoderBlock(nn.Module):
    """Complex transposed conv (to the skip's size) -> (+ time embedding) ->
    norm -> activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride, padding, dilation,
                 norm_type: str = "bN", activation: str = "leaky_relu",
                 embed_dim: Optional[int] = None, temb_layers: int = 1,
                 temb_activation: str = "silu", generator=None):
        super().__init__()
        self.deconv = ComplexConvTranspose2d(in_ch, out_ch, kernel_size, stride, padding,
                                             dilation=dilation, bias=norm_type is None,
                                             generator=generator)
        self.embed_layer = (TembLayer(embed_dim, out_ch, temb_layers, temb_activation,
                                      generator) if embed_dim is not None else None)
        self.norm = _norm(norm_type, out_ch, generator)
        self.act = get_activation(activation)

    def forward(self, x, t_embed=None, output_size=None, bounds=None):
        """``bounds``: on a frames shard, x's split over the ranks."""
        y = self.deconv(x, output_size=output_size, bounds=bounds)
        if self.embed_layer is not None and t_embed is not None:
            y = y + self.embed_layer(t_embed)
        return on_reim(self.act, self.norm(y))


@BackboneRegistry.register("dcunet")
class DCUNet(nn.Module):
    """Complex U-Net score backbone: ``(x complex [B, 2, F, T], t [B]) ->
    complex [B, 1, F, T]``.

    The keywords and their defaults are the JAX package's ``DCUNet`` fields;
    the command line's defaults (``add_argparse_args``) differ from them
    (``dcunet_activation`` leaky_relu, ``dcunet_temb_layers_global`` 1), as
    in the JAX package. ``dcunet_mask_bound`` other than "none" raises."""

    # enhance(seq_mesh=) splits its frames over the ranks (the module docstring)
    frames_parallel = True

    def __init__(self, dcunet_architecture: str = "DilDCUNet-v2",
                 dcunet_time_embedding: str = "gfp", dcunet_temb_layers_global: int = 2,
                 dcunet_temb_layers_local: int = 1, dcunet_temb_activation: str = "silu",
                 dcunet_time_embedding_complex: bool = False, dcunet_fix_length: str = "pad",
                 dcunet_mask_bound: str = "none", dcunet_norm_type: str = "bN",
                 dcunet_activation: str = "relu", embed_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dcunet_mask_bound != "none":
            raise NotImplementedError("sorry, mask bounding not implemented at the moment")
        g = generator
        self.fix_length_mode = dcunet_fix_length if dcunet_fix_length != "none" else None
        time_embedding = dcunet_time_embedding if dcunet_time_embedding != "none" else None
        self.time_embedding = time_embedding
        self.temb_act = get_activation(dcunet_temb_activation)
        self.temb_layers_global = dcunet_temb_layers_global

        conf_encoders, conf_decoders = DCUNET_ARCHITECTURES[dcunet_architecture]
        _unused, *rest = conf_encoders[0]
        encoders_args = ((2, *rest), *conf_encoders[1:])  # complex channels (x_t, y)
        self.n_encoders = len(encoders_args)
        self.stride_prod = np.prod([s for _, _, _, s, _, _ in encoders_args], axis=0)

        if time_embedding == "gfp":
            self.gfp = GaussianFourierProjection(embed_dim,
                                                 complex_valued=dcunet_time_embedding_complex,
                                                 generator=g)
        elif time_embedding == "ds":
            self.ds = DiffusionStepEmbedding(embed_dim,
                                             complex_valued=dcunet_time_embedding_complex)
        if time_embedding is not None:
            for i in range(dcunet_temb_layers_global):
                setattr(self, f"embed_global_{i}", ComplexLinear(embed_dim, embed_dim,
                                                                 generator=g))

        common = dict(norm_type=dcunet_norm_type, activation=dcunet_activation,
                      temb_layers=dcunet_temb_layers_local,
                      temb_activation=dcunet_temb_activation,
                      embed_dim=embed_dim if time_embedding is not None else None, generator=g)
        for i, (in_ch, out_ch, k, s, p, d) in enumerate(encoders_args):
            setattr(self, f"encoder_{i}",
                    DCUNetComplexEncoderBlock(in_ch, out_ch, k, s, p, d, **common))
        for i, dec_args in enumerate(conf_decoders[:-1]):
            in_ch, out_ch, k, s, p, d = dec_args[:6]
            setattr(self, f"decoder_{i}",
                    DCUNetComplexDecoderBlock(in_ch, out_ch, k, s, p, d, **common))
        in_ch, out_ch, k, s, p, d = conf_decoders[-1][:6]
        self.output_layer = ComplexConvTranspose2d(in_ch, out_ch, k, s, p, dilation=d,
                                                   bias=True, generator=g)

    @staticmethod
    def add_argparse_args(parser):
        parser.add_argument("--dcunet-architecture", type=str, default="DilDCUNet-v2",
                            choices=list(DCUNET_ARCHITECTURES.keys()))
        parser.add_argument("--dcunet-time-embedding", type=str,
                            choices=("gfp", "ds", "none"), default="gfp")
        parser.add_argument("--dcunet-temb-layers-global", type=int, default=1)
        parser.add_argument("--dcunet-temb-layers-local", type=int, default=1)
        parser.add_argument("--dcunet-temb-activation", type=str, default="silu")
        parser.add_argument("--dcunet-time-embedding-complex", action="store_true")
        parser.add_argument("--dcunet-fix-length", type=str, default="pad",
                            choices=("pad", "trim", "none"))
        parser.add_argument("--dcunet-mask-bound", type=str,
                            choices=("tanh", "sigmoid", "none"), default="none")
        parser.add_argument("--dcunet-norm-type", type=str, choices=("bN", "CbN"),
                            default="bN")
        parser.add_argument("--dcunet-activation", type=str,
                            choices=("leaky_relu", "relu", "silu"), default="leaky_relu")
        return parser

    def forward(self, spec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Args:
            spec: complex ``[B, 2, F, T]`` (x_t, y) pair.
            t: ``[B]`` diffusion time.

        Returns complex ``[B, 1, F, T]``. On the card its cuDNN convolutions
        and matmuls run in float32, without TF32, whatever the process-wide
        setting.
        """
        with float32_precision(spec.device):
            return self._forward(spec, t)

    def _forward(self, spec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # on a frames shard: each map's split over the ranks, the input's in
        # the equal parts that enhance hands out
        seq = current_frames()
        spec_bounds = None if seq is None else split_bounds(spec.shape[3] * seq.count,
                                                            seq.count)
        x, x_bounds = self._fix_input_dims(spec, spec_bounds)

        t_embed = None
        if self.time_embedding is not None:
            t_embed = (self.gfp if self.time_embedding == "gfp" else self.ds)(t)
            for i in range(self.temb_layers_global):
                t_embed = on_reim(self.temb_act, getattr(self, f"embed_global_{i}")(t_embed))

        def size(t, bounds):  # a map's whole (F, T)
            return t.shape[2:] if bounds is None else (t.shape[2], bounds[-1])

        enc_outs = []
        h, bounds = x, x_bounds
        for i in range(self.n_encoders):
            encoder = getattr(self, f"encoder_{i}")
            h = encoder(h, t_embed, bounds)
            bounds = None if bounds is None else encoder.conv.out_bounds(bounds)
            enc_outs.append((h, bounds))
        for i, (enc_out, enc_bounds) in enumerate(reversed(enc_outs[:-1])):
            h = getattr(self, f"decoder_{i}")(h, t_embed, output_size=size(enc_out, enc_bounds),
                                              bounds=bounds)
            h, bounds = torch.cat([h, enc_out], dim=1), enc_bounds
        out = self.output_layer(h, output_size=size(x, x_bounds), bounds=bounds)
        if spec_bounds is None:
            return self._fix_output_dims(out, spec)
        # cropped (or zero-padded) at the global right edge, in enhance's parts
        return seq.columns(out, split_bounds(x_bounds[-1], seq.count),
                           list(zip(spec_bounds, spec_bounds[1:])), dim=3)

    def _fix_input_dims(self, x: torch.Tensor, bounds: Optional[tuple] = None):
        """Pad or trim the time so that ``(T - 1)`` divides the time-stride
        product; ``(F - 1)`` must divide the frequency-stride product. On a
        frames shard (x's split over the ranks: ``bounds``) the whole map's
        T counts, and the rank at the global right edge pads or trims.
        Returns x and its bounds."""
        freq_prod, time_prod = int(self.stride_prod[0]), int(self.stride_prod[1])
        width = x.shape[3] if bounds is None else bounds[-1]
        if (x.shape[2] - 1) % freq_prod:
            shape = (x.shape[0], x.shape[2], width, x.shape[1])  # as the JAX package's NHWC
            raise TypeError(
                f"Input shape must be [batch, freq + 1, time + 1, ch] with freq "
                f"divisible by {freq_prod}, got {shape} instead")
        time_remainder = (width - 1) % time_prod
        if time_remainder:
            if self.fix_length_mode is None:
                raise TypeError(
                    f"Input time dim must satisfy (T - 1) %% {time_prod} == 0, got "
                    f"{(*x.shape[:3], width)}. Set fix_length to 'pad' or 'trim'.")
            if self.fix_length_mode == "pad":
                change = time_prod - time_remainder
            elif self.fix_length_mode == "trim":
                change = -time_remainder
            else:
                raise ValueError(f"Unknown fix_length mode '{self.fix_length_mode}'")
            seq = current_frames()
            if bounds is None or seq.index == seq.count - 1:
                x = F.pad(x, (0, change)) if change > 0 else x[:, :, :, : x.shape[3] + change]
            if bounds is not None:
                bounds = (*bounds[:-1], bounds[-1] + change)
        return x, bounds

    @staticmethod
    def _fix_output_dims(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Crop or zero-pad the output's time back to the input's."""
        inp_len, out_len = x.shape[3], out.shape[3]
        if out_len >= inp_len:
            return out[:, :, :, :inp_len]
        return F.pad(out, (0, inp_len - out_len))
