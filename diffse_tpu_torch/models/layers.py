"""NCSN++ layers as torch ``nn.Module``s (port of diffse_tpu/models/layers.py).

Feature maps are NCHW tensors kept in ``channels_last`` memory, so that the
NHWC view the CUDA kernels take (``x.permute(0, 2, 3, 1)``) is contiguous and
free. Parameter names and shapes follow the reference torch NCSN++ (conv
weights OIHW, Linear ``[out, in]``, GroupNorm ``weight``/``bias``, NIN ``W``
``[in, units]``), so that the converter's state_dict loads with strict=True.

With the SiLU nonlinearity every GroupNorm runs through a hand-written
kernel on the card (ops/cuda_kernels.py): the plain residual blocks' two
GroupNorm -> SiLU -> conv3x3 chains (BigGAN-style and DDPM-style) through
``groupnorm_silu_conv3x3`` (with the conditioning bias and the residual in
its epilogue), the resampling blocks' and the attention blocks' GroupNorms
through ``groupnorm_silu``; both through their differentiable ops
(``groupnorm_silu_conv3x3_op``, ``groupnorm_silu_op``), so that training runs
the same kernels forward. With dropout in training a block's second chain is
``groupnorm_silu``, the dropout (flax's: ``h / keep`` where the caller's keep
mask keeps), then its conv. Other nonlinearities run the blocks' chains in
plain PyTorch, as the JAX package gates its kernels to SiLU. The remaining
convolutions (stem, shortcuts, Combine, the up/down layers' convs, output
layer) and the attention einsums are plain PyTorch, as the JAX package
leaves them to XLA.

The bf16 trunk (``NCSNpp(dtype="bf16")``) keeps the parameters in float32 and
computes where the JAX package's bf16 path does (diffse_tpu/models/layers.py):
activations cross memory in bfloat16; convs and the blocks' dense layers take
bf16 operands, sum in float32 and round once, then add their bias in bf16
(``conv``, ``dense``, as flax's ``nn.Conv``/``nn.Dense`` with ``dtype``;
the bf16 copies of their parameters are cast once, ``cast_params``, and in
training on every call, so that the gradient reaches the float32
parameters); GroupNorm statistics, the attention's norm, q/k/v and softmax
stay float32. A program exported with the bf16 trunk (``serving/export.py``)
takes those copies and the packed conv weights as inputs: inside
``given_weights`` the blocks read them from the given store by their names
in the backbone, in place of their caches.

Inside a frames shard (``parallel.sequence.constrain_frames``: one
utterance's frames split over ranks) the layers of the paper's configuration
compute this rank's columns of the whole map's result: each GroupNorm's
statistics are the shards' group sums, summed over the ranks
(``gn_group_sums``, then ``gn_fold_ab``) and handed to the kernels as their
affine (``ab=``); each 3x3 conv and FIR resample reads its neighbours' edge
columns (``FramesShard.halo``); the attention attends over every rank's
frames.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_kernels import (CONV_BK_BF16, gn_fold_ab, gn_group_sums,
                                groupnorm_silu_conv3x3_op, groupnorm_silu_op, needs_grad,
                                pack_conv_weight_bf16, weight_casts)
from ..ops.fir import (conv_downsample_2d, downsample_2d, naive_downsample_2d,
                       naive_upsample_2d, upsample_2d, upsample_conv_2d)
from ..parallel.sequence import current_frames
from ..utils import forbid_capture, round_once

# keep_mask(shape, keep, device) -> bool tensor: where dropout keeps a value
KeepMask = Callable[[Tuple[int, ...], float, torch.device], torch.Tensor]


# The repo's NCSN++ configuration: FIR [1,3,3,1] resampling, residual sums
# rescaled by 1/sqrt(2), last convs of each block initialised at scale 0.
FIR_KERNEL = (1, 3, 3, 1)
SKIP_COEF = 1.0 / math.sqrt(2.0)


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The NCSN++ nonlinearity by name: elu, relu, lrelu (slope 0.2) or
    swish (SiLU)."""
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal positional embedding ``[sin(t f), cos(t f)]`` of the
    ``[B]`` timesteps over ``embedding_dim // 2`` geometric frequencies f
    (zero-padded to an odd ``embedding_dim``), float32."""
    if timesteps.ndim != 1:
        raise ValueError("get_timestep_embedding takes [B] timesteps")
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


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
              generator: Optional[torch.Generator] = None, stride: int = 1,
              padding: Optional[int] = None) -> nn.Conv2d:
    """A conv with the DDPM initialisation; SAME padding unless given."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=kernel // 2 if padding is None else padding)
    default_init_(conv.weight, init_scale, generator)
    nn.init.zeros_(conv.bias)
    return conv


def ddpm_dense(in_dim: int, out_dim: int,
               generator: Optional[torch.Generator] = None) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    default_init_(lin.weight, 1.0, generator)
    nn.init.zeros_(lin.bias)
    return lin


class _GivenWeights:
    """The store of ``given_weights``: tensors by ``"<module name>.<what>"``,
    the module's name in the backbone."""

    def __init__(self, backbone: nn.Module, store: dict, record: bool):
        self.names = {id(m): name for name, m in backbone.named_modules()}
        self.store, self.record = store, record

    def get(self, module: nn.Module, what: str, make: Callable[[], torch.Tensor]):
        key = f"{self.names[id(module)]}.{what}"
        if key not in self.store:
            if not self.record:
                raise KeyError(f"{key}: not among the given weights")
            self.store[key] = make()
        return self.store[key]


_given = threading.local()


@contextlib.contextmanager
def given_weights(backbone: nn.Module, store: dict, record: bool = False):
    """Within the block (on this thread), ``backbone``'s bf16 casts
    (``cast_params``) and packed conv weights (``packed_weight``) are the
    tensors of ``store``, by ``"<module name>.cast_weight"``,
    ``".cast_bias"`` and ``".<conv name>.packed"``, not the modules' caches:
    the inputs of an exported program. With ``record``, each one missing is
    made as the cache would make it (from the weight the module holds then,
    e.g. through ``torch.func.functional_call``) and put in ``store``."""
    saved = getattr(_given, "store", None)
    _given.store = _GivenWeights(backbone, store, record)
    try:
        yield
    finally:
        _given.store = saved


def cast_params(module: nn.Module, dtype: torch.dtype):
    """``module``'s weight and bias cast to ``dtype``, cast once and again
    only when either moves or changes: the copies are kept on the module
    (a plain attribute, not in the state_dict) keyed on each parameter's
    device, ``data_ptr()`` and ``_version``, with the parameters themselves
    held so that no other tensor takes their addresses while the key
    stands. Each cast is counted in ``cuda_kernels.weight_casts`` under the
    module's kind ("conv" or "dense"), on any device. Inside
    ``given_weights`` the copies are the given ones.

    Where autograd records (grad enabled and a parameter requiring grad), the
    casts are made anew on each call, neither cached nor counted: a copy
    made without ``detach()`` carries the gradient back to the float32
    parameter, and one step's graph must not outlive it."""
    w, b = module.weight, module.bias
    if needs_grad(w, b):
        return w.to(dtype), b.to(dtype)
    kind = "conv" if isinstance(module, nn.Conv2d) else "dense"
    given = getattr(_given, "store", None)
    if given is not None:
        def cast_weight():
            weight_casts[kind] += 1
            return w.detach().to(dtype)

        return (given.get(module, "cast_weight", cast_weight),
                given.get(module, "cast_bias", lambda: b.detach().to(dtype)))
    key = (dtype, w.device, w.data_ptr(), w._version, b.data_ptr(), b._version)
    cached = getattr(module, "_cast", None)
    if cached is None or cached[0] != key:
        forbid_capture(w.device, "a cast weight")
        cached = (key, (w.detach(), b.detach()), w.detach().to(dtype), b.detach().to(dtype))
        module._cast = cached
        weight_casts[kind] += 1
    return cached[2], cached[3]


def conv(module: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``module(x)`` computed in ``dtype``, as flax's ``nn.Conv(dtype=...)``
    does: x and the weight cast to ``dtype``, the conv rounded to it once,
    then the bias (cast to ``dtype``) added in ``dtype``. Float32 is the
    module's own call; the cast weight and bias are kept (``cast_params``).
    On a frames shard a conv wider than one column reads its neighbours'
    columns (zeros past the global edges, its SAME padding there) and pads
    none along the frames."""
    padding = module.padding
    seq = current_frames()
    if seq is not None and module.kernel_size[1] > 1:
        if module.stride != (1, 1) or module.padding[1] != module.kernel_size[1] // 2:
            raise NotImplementedError("a frames shard takes stride-1 SAME convs only")
        x = seq.halo(x, 3, padding[1], padding[1])
        padding = (padding[0], 0)
        if dtype == torch.float32:
            return F.conv2d(x, module.weight, module.bias, padding=padding)
    elif dtype == torch.float32:
        return module(x)
    weight, bias = cast_params(module, dtype)
    y = round_once(lambda a, w: F.conv2d(a, w, stride=module.stride, padding=padding),
                   x.to(dtype), weight)
    return y + bias[None, :, None, None]


def dense(module: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``module(x)`` computed in ``dtype``, as flax's ``nn.Dense(dtype=...)``
    does (see ``conv``)."""
    if dtype == torch.float32:
        return module(x)
    weight, bias = cast_params(module, dtype)
    y = round_once(lambda a, w: a @ w.t(), x.to(dtype), weight)
    return y + bias


# sqrt(2) rounded to each floating dtype, as a Python float: made once, so
# that a forward reads no tensor back to the host
_SQRT2 = {dtype: float(torch.tensor(math.sqrt(2.0), dtype=dtype))
          for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.float64)}


def _sqrt2(dtype: torch.dtype) -> float:
    """sqrt(2) rounded to ``dtype``, as a Python float."""
    return _SQRT2[dtype]


def residual(x: torch.Tensor, h: torch.Tensor, rescale: bool = True) -> torch.Tensor:
    """``(x + h) / sqrt(2)`` in x's dtype (``x + h`` without ``rescale``). The
    JAX package divides by the Python float sqrt(2), a weakly typed scalar that
    takes the array's dtype: in bfloat16 the divisor is bf16(sqrt(2)) =
    1.4140625, and so it is here."""
    if not rescale:
        return x + h
    return (x + h) / _sqrt2(x.dtype)


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


def frames_affine(seq, x: torch.Tensor, gn: "GroupNorm"):
    """The GroupNorm affine ``(a, b)`` of the whole map of which NHWC ``x``
    holds a frames shard's columns (``seq``): the shard's group sums
    (``gn_group_sums``) summed over the ranks in float64, folded over every
    rank's positions (``gn_fold_ab``)."""
    sums = seq.sum(gn_group_sums(x, gn.num_groups))
    b, h, w, c = x.shape
    return gn_fold_ab(sums, h * w * seq.count, gn.weight, gn.bias, gn.eps, x.dtype)


def gn_silu_conv(x: torch.Tensor, gn: "GroupNorm", conv: nn.Conv2d, bias: torch.Tensor,
                 skip: Optional[torch.Tensor] = None, skip_coef: float = 1.0,
                 w_packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``groupnorm_silu_conv3x3_op`` of NHWC ``x`` with ``gn``'s parameters
    and ``conv``'s weight. On a frames shard: with the whole map's affine
    (``frames_affine``), on x extended by one column of each neighbour (none
    past the global edges, where the kernel's own padding zero-pads the
    activated map, as on one device) and ``skip`` by as many zeros, the
    extension's output columns dropped."""
    seq = current_frames()
    if seq is None:
        return groupnorm_silu_conv3x3_op(x, gn.weight, gn.bias, conv_hwio(conv), bias,
                                         gn.num_groups, gn.eps, skip=skip,
                                         skip_coef=skip_coef, w_packed=w_packed)
    ab = frames_affine(seq, x, gn)
    x, left, right = seq.halo(x, 2, 1, 1, zero_edges=False)
    if skip is not None:
        skip = F.pad(skip, (0, 0, left, right))
    out = groupnorm_silu_conv3x3_op(x.contiguous(), gn.weight, gn.bias, conv_hwio(conv), bias,
                                    gn.num_groups, gn.eps, skip=skip, skip_coef=skip_coef,
                                    w_packed=w_packed, ab=ab)
    return out[:, :, left: out.shape[2] - right].contiguous()


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
        x = to_nhwc(x)
        seq = current_frames()
        ab = None if seq is None else frames_affine(seq, x, self)
        out = groupnorm_silu_op(x, self.weight, self.bias, self.num_groups, self.eps,
                                apply_silu, out_dtype, ab=ab)
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
    """Combine the input pyramid into the trunk: ``Conv_0(x) + y`` (``sum``)
    or ``[Conv_0(x), y]`` along the channels (``cat``), in the trunk's dtype
    (y's)."""

    def __init__(self, dim1: int, dim2: int, method: str = "sum",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if method not in ("sum", "cat"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = ddpm_conv(dim1, dim2, 1, generator=generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = conv(self.Conv_0, x, y.dtype)
        if self.method == "cat":
            return torch.cat([h, y], dim=1)
        return h + y


class AttnBlockpp(nn.Module):
    """Dense spatial self-attention over HW tokens:
    ``x + NIN_3(softmax(q k^T / sqrt(C)) v)``, divided by sqrt(2) with
    ``skip_rescale``. For a bfloat16 x the norm, q, k, v and softmax are
    float32; the attended map is rounded to bf16 before ``NIN_3`` (float32
    maths on it) and after, and the residual sum is bf16, as in the JAX
    package. On a frames shard the keys and values are those of every
    rank's frames (the normalised map gathered), the queries this rank's."""

    def __init__(self, channels: int, skip_rescale: bool = True, init_scale: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(channels)
        self.NIN_0 = NIN(channels, channels, generator=generator)
        self.NIN_1 = NIN(channels, channels, generator=generator)
        self.NIN_2 = NIN(channels, channels, generator=generator)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = to_nhwc(self.GroupNorm_0(x, apply_silu=False, out_dtype=torch.float32))
        seq = current_frames()
        whole = h if seq is None else seq.gather(h, dim=2)
        h, whole = h.reshape(b, hh * ww, c), whole.reshape(b, -1, c)
        q, k, v = (self.NIN_0.forward_nhwc(h), self.NIN_1.forward_nhwc(whole),
                   self.NIN_2.forward_nhwc(whole))
        w = torch.bmm(q, k.transpose(1, 2)) * (int(c) ** (-0.5))
        w = torch.softmax(w, dim=-1)
        h = torch.bmm(w, v).to(x.dtype).float()
        h = self.NIN_3.forward_nhwc(h).to(x.dtype).reshape(b, hh, ww, c)
        return from_nhwc(residual(to_nhwc(x), h, self.skip_rescale))


class FirConv2d(nn.Module):
    """Conv2d with fused FIR up/down-sampling (the StyleGAN2 layer): the
    reference's ``up_or_down_sampling.Conv2d``, ``weight`` OIHW and ``bias``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, up: bool = False,
                 down: bool = False, resample_kernel=FIR_KERNEL, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if up and down:
            raise ValueError("FirConv2d: up or down, not both")
        if kernel < 1 or kernel % 2 != 1:
            raise ValueError(f"FirConv2d: odd kernel size needed, got {kernel}")
        self.up, self.down = up, down
        self.resample_kernel = tuple(resample_kernel)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        default_init_(self.weight, 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = upsample_conv_2d(x, self.weight, k=self.resample_kernel)
        elif self.down:
            x = conv_downsample_2d(x, self.weight, k=self.resample_kernel)
        else:
            x = F.conv2d(x, self.weight, padding=self.weight.shape[-1] // 2)
        if self.bias is not None:
            x = x + self.bias[None, :, None, None]
        return x


class Upsample(nn.Module):
    """2x upsample: nearest neighbour (then ``Conv_0``, a 3x3 conv, with
    ``with_conv``), or FIR (fused with the conv ``Conv2d_0`` with
    ``with_conv``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel=FIR_KERNEL,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and not fir:
            self.Conv_0 = ddpm_conv(in_ch, out_ch, 3, generator=generator)
        elif with_conv:
            self.Conv2d_0 = FirConv2d(in_ch, out_ch, 3, up=True, resample_kernel=fir_kernel,
                                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            h = naive_upsample_2d(x, factor=2)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return upsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


class Downsample(nn.Module):
    """2x downsample: a 3x3 stride-2 conv ``Conv_0`` on the map padded by one
    row and column at the bottom and right (``with_conv``), or a 2x2 mean;
    or FIR (fused with the conv ``Conv2d_0`` with ``with_conv``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel=FIR_KERNEL,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)
        if with_conv and not fir:
            self.Conv_0 = ddpm_conv(in_ch, out_ch, 3, stride=2, padding=0, generator=generator)
        elif with_conv:
            self.Conv2d_0 = FirConv2d(in_ch, out_ch, 3, down=True, resample_kernel=fir_kernel,
                                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            if self.with_conv:
                return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
            return naive_downsample_2d(x, factor=2)
        if not self.with_conv:
            return downsample_2d(x, self.fir_kernel, factor=2)
        return self.Conv2d_0(x)


def dropout(h: torch.Tensor, rate: float, keep_mask: KeepMask) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training: ``h / keep`` where the mask keeps,
    0 elsewhere (keep = 1 - rate), the mask ``keep_mask(shape, keep,
    device)``."""
    if keep_mask is None:
        raise ValueError(f"dropout={rate} in training needs keep masks (ScoreModel.loss_fn "
                         "draws them from its generator; a direct call passes keep_mask=)")
    keep = 1.0 - rate
    mask = keep_mask(tuple(h.shape), keep, h.device)
    return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def generator_keep_mask(generator: Optional[torch.Generator]) -> KeepMask:
    """Keep masks drawn from ``generator``: Bernoulli(keep), as flax draws
    them (a uniform draw below ``keep``)."""
    def keep_mask(shape, keep, device):
        return torch.rand(shape, generator=generator, device=device) < keep
    return keep_mask


class _ResnetBlock(nn.Module):
    """What the two residual block types share: the nonlinearity, the dense
    conditioning layers, dropout and the residual sum.

    With the ``swish`` nonlinearity a block computes GroupNorm -> SiLU ->
    conv3x3 through the fused ``groupnorm_silu_conv3x3`` kernel, the first
    with the conditioning in its per-batch bias; with dropout active (in
    training, rate > 0) the second chain runs ``groupnorm_silu``, the
    dropout, then ``Conv_1``. Other nonlinearities run the plain chain
    (``F.group_norm``, the activation, the convs), as the JAX package gates
    its kernels to SiLU."""

    def _init_common(self, in_ch: int, out_ch: int, temb_dim: Optional[int],
                     semb_dim: Optional[int], act: str, dropout: float, skip_rescale: bool,
                     init_scale: float, generator: Optional[torch.Generator]):
        self.act = get_act(act)
        self.fused = act == "swish"
        self.dropout = dropout
        self.skip_rescale = skip_rescale
        self.skip_coef = SKIP_COEF if skip_rescale else 1.0
        self.out_ch = out_ch
        self.GroupNorm_0 = GroupNorm(in_ch)
        self.Conv_0 = ddpm_conv(in_ch, out_ch, 3, generator=generator)
        self.Dense_0 = ddpm_dense(temb_dim, out_ch, generator) if temb_dim else None
        self.Dense_1 = ddpm_dense(semb_dim, out_ch, generator) if semb_dim else None
        self.GroupNorm_1 = GroupNorm(out_ch)
        self.Conv_1 = ddpm_conv(out_ch, out_ch, 3, init_scale=init_scale, generator=generator)

    def _dense_biases(self, temb, semb, dtype):
        """``Dense_0(act(temb))`` and ``Dense_1(act(semb))``, None where the
        embedding or the layer is absent."""
        temb_bias = (dense(self.Dense_0, self.act(temb), dtype)
                     if self.Dense_0 is not None and temb is not None else None)
        semb_bias = (dense(self.Dense_1, self.act(semb), dtype)
                     if self.Dense_1 is not None and semb is not None else None)
        return temb_bias, semb_bias

    def _fused_bias0(self, batch, temb_bias, semb_bias):
        """``Conv_0``'s bias plus the conditioning, float32 ``[B, out_ch]``."""
        bias0 = self.Conv_0.bias[None, :]
        for extra in (temb_bias, semb_bias):
            if extra is not None:
                bias0 = bias0 + extra.float()
        if bias0.shape[0] != batch:
            return bias0.expand(batch, self.out_ch)
        return bias0.contiguous()

    def _plain_gn_act(self, gn: "GroupNorm", x: torch.Tensor) -> torch.Tensor:
        return self.act(F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps))

    def _dropping(self) -> bool:
        return self.training and self.dropout > 0

    def _second_chain(self, h, skip, keep_mask, dtype):
        """``Conv_1(dropout(act(GroupNorm_1(h))))`` and the residual with
        ``skip``, for maps h (NCHW) and skip (NCHW) in ``dtype``."""
        if self.fused:
            h = self.GroupNorm_1(h)
        else:
            h = self._plain_gn_act(self.GroupNorm_1, h)
        if self._dropping():
            h = dropout(h, self.dropout, keep_mask)
        h = conv(self.Conv_1, h, dtype)
        return residual(skip, h, self.skip_rescale)


class ResnetBlockDDPMpp(_ResnetBlock):
    """DDPM-style residual block: GroupNorm -> act -> ``Conv_0`` (+
    ``Dense_0(act(temb))`` [+ ``Dense_1(act(semb))``]) -> GroupNorm -> act
    -> dropout -> ``Conv_1``, plus the input (through ``NIN_0``, or the 3x3
    ``Conv_2`` with ``conv_shortcut``, where the channels change), the sum
    divided by sqrt(2) with ``skip_rescale``.

    The JAX package's block has no compute dtype: its maps are float32
    whatever the trunk's, and so they are here (the input is cast to
    float32). With ``swish``, outside dropout, the two chains are one fused
    kernel each, the second with the shortcut as its skip and ``skip_coef``
    1/sqrt(2) or 1."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, semb_dim: Optional[int] = None,
                 act: str = "swish", conv_shortcut: bool = False, dropout: float = 0.1,
                 skip_rescale: bool = False, init_scale: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self._init_common(in_ch, out_ch, temb_dim, semb_dim, act, dropout, skip_rescale,
                          init_scale, generator)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = ddpm_conv(in_ch, out_ch, 3, generator=generator)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, generator=generator)
        if self.fused:
            hwio_memory_(self.Conv_0)
            hwio_memory_(self.Conv_1)

    def _shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if self.Conv_2 is not None:
            return self.Conv_2(x)
        if self.NIN_0 is not None:
            return from_nhwc(self.NIN_0.forward_nhwc(to_nhwc(x)))
        return x

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                semb: Optional[torch.Tensor] = None,
                keep_mask: Optional[KeepMask] = None) -> torch.Tensor:
        x = x.float()
        temb_bias, semb_bias = self._dense_biases(temb, semb, torch.float32)
        skip = self._shortcut(x)
        if self.fused:
            bias0 = self._fused_bias0(x.shape[0], temb_bias, semb_bias)
            h = groupnorm_silu_conv3x3_op(
                to_nhwc(x), self.GroupNorm_0.weight, self.GroupNorm_0.bias,
                conv_hwio(self.Conv_0), bias0, self.GroupNorm_0.num_groups,
                self.GroupNorm_0.eps)
            if not self._dropping():
                bias1 = self.Conv_1.bias[None, :].expand(x.shape[0], self.out_ch)
                out = groupnorm_silu_conv3x3_op(
                    h, self.GroupNorm_1.weight, self.GroupNorm_1.bias, conv_hwio(self.Conv_1),
                    bias1, self.GroupNorm_1.num_groups, self.GroupNorm_1.eps,
                    skip=to_nhwc(skip), skip_coef=self.skip_coef)
                return from_nhwc(out)
            h = from_nhwc(h)
        else:
            h = self.Conv_0(self._plain_gn_act(self.GroupNorm_0, x))
            for extra in (temb_bias, semb_bias):
                if extra is not None:
                    h = h + extra[:, :, None, None]
        return self._second_chain(h, skip, keep_mask, torch.float32)


class ResnetBlockBigGANpp(_ResnetBlock):
    """BigGAN-style residual block with in-block up/down-sampling (FIR, or
    nearest neighbour / 2x2 mean with ``fir=False``).

    Plain blocks with ``swish`` run both GroupNorm -> SiLU -> conv3x3 chains
    as one kernel each: the first with bias ``Conv_0.bias +
    Dense_0(SiLU(temb))`` (plus ``Dense_1(SiLU(semb))`` in the
    SNR-conditioned variant), the second with the residual ``(x' + h) /
    sqrt(2)`` (or ``x' + h`` without ``skip_rescale``) in its epilogue; with
    dropout active the second chain is ``groupnorm_silu``, the dropout, then
    ``Conv_1``. Up/down blocks run GroupNorm+act, the resampling, then the
    conv (the resampling sits between norm and conv, so they cannot be
    fused), with the embeddings added after ``Conv_0``. Other
    nonlinearities run the plain chain.

    ``dtype`` is the block's compute dtype: its input is cast to it, and in
    bfloat16 the whole block runs in it (the dense layers too, whose output
    goes into the fused chain's float32 bias). A bfloat16 plain block keeps
    its two fused convs' weights packed in bf16 for the kernel
    (``packed_weight``), outside the state_dict."""

    def __init__(self, in_ch: int, out_ch: Optional[int], temb_dim: Optional[int],
                 up: bool = False, down: bool = False, semb_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, act: str = "swish", dropout: float = 0.0,
                 fir: bool = True, fir_kernel=FIR_KERNEL, skip_rescale: bool = True,
                 init_scale: float = 0.0):
        super().__init__()
        out_ch = out_ch if out_ch else in_ch
        self._init_common(in_ch, out_ch, temb_dim, semb_dim, act, dropout, skip_rescale,
                          init_scale, generator)
        self.compute_dtype = dtype
        self.up, self.down = up, down
        self.fir, self.fir_kernel = fir, tuple(fir_kernel)
        if in_ch != out_ch or up or down:
            self.Conv_2 = ddpm_conv(in_ch, out_ch, 1, generator=generator)
        else:
            self.Conv_2 = None
        if self.fused and not (up or down):  # both convs run inside the fused kernel
            hwio_memory_(self.Conv_0)
            hwio_memory_(self.Conv_1)
        # conv name -> ((device, data_ptr, _version), weight, packed): a plain
        # attribute, so not in the state_dict
        self._packed = {}

    def packed_weight(self, name: str) -> Optional[torch.Tensor]:
        """``pack_conv_weight_bf16`` of conv ``name``'s weight in a bfloat16
        block (None in float32, or where Cin is not whole K chunks of 16, which
        the kernels do not take), packed once and again only when the weight
        moves or changes: the copy is keyed on the parameter's device,
        ``data_ptr()`` and ``_version`` (an in-place update or
        ``load_state_dict`` bumps it), and holds the weight's storage, so that
        no other tensor takes its address while the key stands (inside
        ``given_weights``: the given one). In training
        the cache serves too: the packed copy feeds only the kernel's
        forward, and the gradient reaches the float32 weight through the op's
        recompute, which reads the weight itself (``GroupNormSiLUConv3x3``);
        an optimizer step updates the weight in place and so packs it anew."""
        w = getattr(self, name).weight
        if self.compute_dtype != torch.bfloat16 or w.shape[1] % CONV_BK_BF16:
            return None
        given = getattr(_given, "store", None)
        if given is not None:
            return given.get(self, f"{name}.packed",
                             lambda: pack_conv_weight_bf16(conv_hwio(getattr(self, name))))
        key = (w.device, w.data_ptr(), w._version)
        cached = self._packed.get(name)
        if cached is None or cached[0] != key:
            forbid_capture(w.device, "a packed weight")
            cached = (key, w.detach(), pack_conv_weight_bf16(conv_hwio(getattr(self, name))))
            self._packed[name] = cached
        return cached[2]

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.fir:
            resample = upsample_2d if self.up else downsample_2d
            return resample(x, self.fir_kernel, factor=2, frames=current_frames())
        return (naive_upsample_2d if self.up else naive_downsample_2d)(x, factor=2)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                semb: Optional[torch.Tensor] = None,
                keep_mask: Optional[KeepMask] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        x = x.to(dtype)
        batch = x.shape[0]
        temb_bias, semb_bias = self._dense_biases(temb, semb, dtype)
        resampling = self.up or self.down
        if self.fused and not resampling:
            x_nhwc = to_nhwc(x)
            h = gn_silu_conv(x_nhwc, self.GroupNorm_0, self.Conv_0,
                             self._fused_bias0(batch, temb_bias, semb_bias),
                             w_packed=self.packed_weight("Conv_0"))
            if self._dropping():
                skip = conv(self.Conv_2, x, dtype) if self.Conv_2 is not None else x
                return self._second_chain(from_nhwc(h), skip, keep_mask, dtype)
            skip = to_nhwc(conv(self.Conv_2, x, dtype)) if self.Conv_2 is not None else x_nhwc
            bias1 = self.Conv_1.bias[None, :].expand(batch, self.out_ch)
            out = gn_silu_conv(h, self.GroupNorm_1, self.Conv_1, bias1, skip=skip,
                               skip_coef=self.skip_coef, w_packed=self.packed_weight("Conv_1"))
            return from_nhwc(out)

        h = self.GroupNorm_0(x) if self.fused else self._plain_gn_act(self.GroupNorm_0, x)
        if resampling:
            h = self._resample(h)
            x = self._resample(x)
        h = conv(self.Conv_0, h, dtype)
        for extra in (temb_bias, semb_bias):
            if extra is not None:
                h = h + extra[:, :, None, None]
        skip = conv(self.Conv_2, x, dtype) if self.Conv_2 is not None else x
        return self._second_chain(h, skip, keep_mask, dtype)
