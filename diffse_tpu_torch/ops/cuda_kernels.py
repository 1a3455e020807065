"""Hand-written CUDA kernels: the GroupNorm -> SiLU (-> conv3x3) chains and
the fused bias + LeakyReLU.

Port of diffse_tpu/ops/pallas_kernels.py's kernels to Hopper. The CUDA
sources live in ``diffse_tpu_torch/csrc/``; at first use each is compiled
with its own ``nvcc`` (all at once) and the objects are linked into one
shared library with a plain C interface (keyed on a hash of the sources,
under ``build/kernels/`` of the checkout), called through ctypes on
PyTorch's current stream.

Every wrapper keeps the JAX signature and layout (NHWC activations, HWIO
weights). The GroupNorm chains take float32 or bfloat16 activations (the
bf16 trunk, ``NCSNpp(dtype="bf16")``) with float32 parameters, statistics
and accumulation, as the Pallas kernels do; the fused conv also takes the
JAX keyword ``compute_dtype`` (bfloat16 products on a float32 map, the bf16
trunk's output_skip heads on DDPM-style blocks). Each wrapper dispatches on
the device of its input:

  - a CPU tensor takes the plain PyTorch version beside the kernel (the same
    maths as the Pallas kernel's jnp reference);
  - a CUDA tensor launches the kernel, or raises on a dtype, shape or stride
    the kernel does not take, or when an input requires grad;
  - anything else raises.

Gradients go through ``groupnorm_silu_conv3x3_op`` and ``groupnorm_silu_op``
(what the model's layers call): ``torch.autograd.Function``s whose forward
is the wrapper above (the kernel on the card) and whose backward recomputes
the plain version under autograd, as the JAX package's custom VJP
(``_gn_silu_conv3x3_bwd``, pallas_kernels.py:544) recomputes its jnp
reference. With no input needing grad they call the wrapper directly.

Each of the three wrappers is also an operator, ``torch.ops.diffse.<name>``
(registered at the end of this module, with a fake implementation for
tracing), and the model and ``ops.fused_act`` reach the wrappers only through
the operators: ``torch.export`` keeps each as one node, so that an exported
program (``serving/export.py``) runs the same kernels.

``launch_counts`` counts each wrapper's kernel launches (nowhere else), so a
run can show that the model went through the kernels
(``stats_launch_counts`` the split statistics pass's, which only
frames-parallel enhancement runs);
``conv_config_launches`` splits the conv's by instantiation. The bf16
large-level conv (``wgmma.ss``) reads its weights packed in bf16
(``pack_conv_weight_bf16``), which the model's blocks keep; ``weight_casts``
counts the packs made on the card.

The wrappers can be captured into a CUDA graph (``capture.Program``): they
launch on the current stream, synchronise nothing and allocate with
``torch.empty``. What outlives a launch (the statistics pass's ticket
counters, one set per stream) is made by the eager warm-up run on the
capture's stream that precedes every capture; a wrapper that would make it
during a capture raises.
The counts advance where a wrapper launches its kernel, so a captured
program counts its launches once, at capture, and not on replay.

The launch plans of the GroupNorm kernels are pure functions of the shapes
(``conv_plan``, ``stats_plan``), so that the CPU tests can hold them at every
shape the model runs; the C entry points check what they are given and
compute no grid of their own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import float32_precision, forbid_capture

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

launch_counts = {"gn_silu_conv3x3": 0, "groupnorm_silu": 0, "fused_bias_leaky_relu": 0}
# the statistics pass split in two (gn_group_sums, gn_fold_ab): frames-parallel
# enhancement sums the shards' group sums between them
stats_launch_counts = {"gn_group_sums": 0, "gn_fold_ab": 0}
# gn_silu_conv3x3's launches by instantiation (CONV_CONFIGS' ids), so that a run
# can show which of its kernels the model went through
conv_config_launches = [0, 0, 0, 0]
# the GroupNorm kernels' launches on bfloat16 activations, of those counted in
# launch_counts: a bf16 trunk may run some chains in float32 (DDPM-style
# blocks, the final head), and a run tells the two apart by these
bf16_launch_counts = {"gn_silu_conv3x3": 0, "groupnorm_silu": 0}
# the conv's launches on float32 activations with bfloat16 products
# (``compute_dtype=torch.bfloat16``: a bf16 trunk's output_skip heads on
# float32 maps), of those counted in launch_counts and not in
# bf16_launch_counts
mixed_launch_counts = {"gn_silu_conv3x3": 0}
# bf16 weights packed on the card by pack_conv_weight_bf16 (a cast kernel and
# a copy each): a module packs its weights once, and the conv's wrapper
# packs them itself when it is not given them; and the bf16 copies of the
# cuDNN convs' and the dense layers' parameters (models/layers.py
# cast_params, counted on any device)
weight_casts = {"gn_silu_conv3x3": 0, "conv": 0, "dense": 0}
# the differentiable ops' backward passes (each recomputes the plain version
# and takes its gradient: no hand kernel runs there)
recompute_counts = {"gn_silu_conv3x3": 0, "groupnorm_silu": 0}


def reset_launch_counts() -> None:
    """Zero ``launch_counts``, ``stats_launch_counts``, ``conv_config_launches``,
    ``bf16_launch_counts``, ``mixed_launch_counts``, ``weight_casts`` and
    ``recompute_counts``."""
    for counts in (launch_counts, stats_launch_counts, bf16_launch_counts, mixed_launch_counts,
                   weight_casts, recompute_counts):
        for name in counts:
            counts[name] = 0
    conv_config_launches[:] = [0] * len(conv_config_launches)


# ------------------------------------------------------------------ launch plans

SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448       # bytes of shared memory one block can use
CONV_BK = 8               # input channels per K chunk in float32 (csrc kBK)
CONV_BK_BF16 = 16         # ... in bfloat16: one k16 product (csrc ConvTypes<bf16>)
CONV_STAGES = 3           # depth of the conv's cp.async ring (csrc kStages)
CONV_ACT_FLOATS = 16      # floats per position of the activated tile (csrc kActFloats)
# The activation types the GroupNorm kernels take, by the code the C entry
# points switch on.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The conv's modes, (x's dtype, the products' dtype), by the code its C entry
# point switches on: float32, bfloat16, and float32 x with bf16 products
# (csrc F32Bf16).
_CONV_MODES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
               (torch.float32, torch.bfloat16): 2}
# The conv kernel's instantiations, by the id the C entry point switches on:
# (BM positions, BN output channels, threads, instruction, tile width: 0 for
# any, else the wgmma kernel's fixed TW, with 128 / TW rows, stages of the
# ring, activated tiles). The last, bf16 only, takes the weights packed in
# bf16 (``pack_conv_weight_bf16``) and both wgmma operands from shared
# memory; its BM is the flat halo positions of a tile, th * (tw + 2).
CONV_CONFIGS = ((64, 64, 128, "mma.sync", 0, 3, 2), (128, 8, 256, "mma.sync", 0, 3, 2),
                (128, 128, 256, "wgmma", 32, 2, 1), (256, 128, 384, "wgmma.ss", 0, 4, 3))
CONV_MMA, CONV_MMA_HEAD, CONV_WGMMA, CONV_WGMMA_SS = range(4)
# The wgmma.ss kernel's packed weights: one (128-channel Cout tile, 16-channel
# K chunk) is [tap 9][Cout half 2][K 8-group 2][Cout 8-group 8][8][8] bf16
# (csrc kWsTileBytes / 2 elements), its wgmma A operand's core matrices.
PACK_TILE = 9 * 16 * 128
# Tile widths the wgmma.ss plan tries, besides the map's own width, and the
# 16-byte halo copies of each of its 128 producer threads (csrc kWsCopies).
CONV_WS_WIDTHS = (8, 16, 24, 32, 48, 64)
CONV_WS_COPIES = 7
# Float32 rows of at least this many positions take the wgmma kernel (half
# its 32-position row tile): narrower maps run faster on mma.sync's smaller
# tiles (tools/conv_plan_sweep.py).
CONV_WGMMA_MIN_W = 16
# In bf16 the wgmma kernel (one block per SM) is the faster from 8 positions
# a row, at one utterance and at bench.py's 16 (tools/conv_plan_sweep.py
# --dtype bf16); narrower rows gain at 16 utterances and lose at one.
CONV_WGMMA_MIN_W_BF16 = 8
# Float32 K units (live tap, 8-channel chunk) that one block sums on the
# tensor cores at the most. TF32 mma and wgmma accumulate with truncation,
# so a chain's error grows with its length and one way: against a float64
# truth, [4,64,64,512]->256 in one split of 576 units was 10-30x cuDNN's
# float32 error, and in splits of 64 on a par with it
# (tools/conv_accuracy.py). A longer K is split, and the reduce pass adds
# the partial sums in float32.
CONV_F32_MAX_UNITS = 72
REDUCE_THREADS = 256      # csrc kReduceThreads
STATS_THREADS = 512       # csrc kStatsThreads
STATS_MIN_ELEMS = 8192    # elements a statistics block reads at the least
STATS_MAX_PARTS = 128     # blocks per batch row: the last one folds groups x parts


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_bk(dtype: torch.dtype = torch.float32) -> int:
    """Input channels per K chunk of the conv for products of ``dtype``: one
    k8 TF32 or k16 bf16 step (32 bytes of each position of x in x's dtype)."""
    return CONV_BK_BF16 if dtype == torch.bfloat16 else CONV_BK


def _weight_row_stride(bn: int, dtype: torch.dtype = torch.float32) -> int:
    """csrc ``weight_row_stride``: the staged (float32) weight rows' stride,
    8 mod 32 for the TF32 fragments (rows t), 4 mod 32 for the bf16 ones (rows
    2t), so that a warp's fragment loads miss bank conflicts."""
    mod = 4 if dtype == torch.bfloat16 else 8
    return bn + (mod - bn % 32 + 32) % 32


def conv_taps(h: int, w: int) -> int:
    """Taps of the 3x3 kernel that touch the map (csrc ``conv_taps``)."""
    return (3 if h > 1 else 1) * (3 if w > 1 else 1)


def conv_smem_bytes(bn: int, th: int, tw: int, taps: int, stages: int = CONV_STAGES,
                    act_bufs: int = 2, dtype: torch.dtype = torch.float32,
                    x_dtype: Optional[torch.dtype] = None) -> int:
    """csrc ``conv_smem_bytes`` for products of ``dtype`` on x of ``x_dtype``
    (``dtype``'s when None): the cp.async ring of ``stages`` (raw x halo, a
    K chunk of x a position: 32 bytes, 64 for float32 x with bf16 products;
    float32 weights per stage) and ``act_bufs`` activated halo tiles
    (float32 hi and lo, 64 bytes a position; bfloat16, 32 bytes)."""
    halo = (th + 2) * (tw + 2)
    bk = conv_bk(dtype)
    raw_bytes = bk * (x_dtype or dtype).itemsize
    act_bytes = 32 if dtype == torch.bfloat16 else 4 * CONV_ACT_FLOATS
    return (stages * (halo * raw_bytes + 4 * taps * bk * _weight_row_stride(bn, dtype))
            + act_bufs * halo * act_bytes)


def conv_ws_smem_bytes(tw: int) -> int:
    """csrc ``ws_smem_bytes``: the wgmma.ss kernel's shared memory for tiles
    ``tw`` wide: a ring of ``CONV_CONFIGS``' 4 stages (the packed weights of a
    chunk, 36 KB, and the raw x halo, 32 bytes a position), 3 activated
    halos in two planes, the halo's map offsets and the barriers."""
    bm, _, _, _, _, stages, act_bufs = CONV_CONFIGS[CONV_WGMMA_SS]
    pitch = tw + 2
    halo = _cdiv(bm + 2 * pitch + 2, 8) * 8
    return (stages * (2 * PACK_TILE + 32 * halo) + act_bufs * 32 * (halo + 4) + 4 * halo
            + 8 * (2 * stages + 2 * act_bufs))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``gn_silu_conv3x3`` runs one shape: instantiation ``config``
    (``CONV_CONFIGS``), a ``th x tw`` tile of positions per block, K cut into
    ``splits`` ranges of ``units_per_split`` (live tap, 8-channel chunk)
    units, the grid ``(B * tiles_h * tiles_w, n_tiles, splits)`` and, when
    ``splits > 1``, ``reduce_blocks`` blocks that add the partial sums."""

    config: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    n_tiles: int
    units: int
    units_per_split: int
    splits: int
    grid: tuple
    smem_bytes: int
    reduce_blocks: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _tile_sizes(n: int, limit: int):
    """Tile extents along an axis of length n: n itself (if it fits) and the
    powers of two below it."""
    sizes = {v for v in (1, 2, 4, 8, 16, 32, 64, 128) if v < n and v <= limit}
    if n <= limit:
        sizes.add(n)
    return sorted(sizes)


def conv_config(b: int, h: int, w: int, cin: int, cout: int,
                dtype: torch.dtype = torch.float32,
                x_dtype: Optional[torch.dtype] = None) -> int:
    """The instantiation for ``[b, h, w, cin] -> cout`` with products of
    ``dtype`` on x of ``x_dtype`` (``dtype``'s when None): the narrow
    ``mma.sync`` block for the Cout <= 8 heads; ``wgmma`` where all nine taps
    touch the map and a row has ``CONV_WGMMA_MIN_W`` positions or more
    (``CONV_WGMMA_MIN_W_BF16`` for bf16 products); else the 64x64
    ``mma.sync`` block. On bf16 x, ``wgmma.ss`` in place of ``wgmma`` where
    its tiles times its K chunks give every SM a block (one utterance's
    narrow levels do not: there ``wgmma``'s smaller tiles fill the card); it
    stages bf16 x only."""
    if cout <= 8:
        return CONV_MMA_HEAD
    min_w = CONV_WGMMA_MIN_W_BF16 if dtype == torch.bfloat16 else CONV_WGMMA_MIN_W
    if conv_taps(h, w) != 9 or w < min_w:
        return CONV_MMA
    if (dtype == torch.bfloat16 and (x_dtype or dtype) == dtype and cout % 8 == 0
            and cin % CONV_BK_BF16 == 0):
        tile = _ws_tiles(b, h, w, cout)[0]
        if tile[2] * cin // CONV_BK_BF16 >= SMS:
            return CONV_WGMMA_SS
    return CONV_WGMMA


def _ws_tiles(b: int, h: int, w: int, cout: int):
    """The wgmma.ss kernel's tiles ``(th, tw, blocks)`` of an ``h x w`` map,
    fewest blocks first (then the smallest halo): for each width (the map's,
    or one of ``CONV_WS_WIDTHS`` below it) whose shared memory fits, as many
    rows as a wgmma's N takes (``th * (tw + 2) <= BM``), spread evenly over
    the map's height."""
    bm, bn = CONV_CONFIGS[CONV_WGMMA_SS][:2]
    tiles = []
    for tw in sorted({w} | {v for v in CONV_WS_WIDTHS if v < w}):
        th_max = min(h, bm // (tw + 2))
        # the producers copy the halo in CONV_WS_COPIES 16-byte pieces each
        if (th_max < 1 or conv_ws_smem_bytes(tw) > SMEM_LIMIT
                or 2 * (th_max + 2) * (tw + 2) > CONV_WS_COPIES * 128):
            continue
        th = _cdiv(h, _cdiv(h, th_max))
        tiles.append((th, tw, b * _cdiv(h, th) * _cdiv(w, tw) * _cdiv(cout, bn)))
    return sorted(tiles, key=lambda t: (t[2], (t[0] + 2) * (t[1] + 2)))


def make_conv_plan(b: int, h: int, w: int, cin: int, cout: int, config: int,
                   fill: int = 1, dtype: torch.dtype = torch.float32,
                   tile: Optional[tuple] = None, max_units: Optional[int] = None,
                   x_dtype: Optional[torch.dtype] = None) -> ConvPlan:
    """The plan of instantiation ``config`` for ``[b, h, w, cin] -> cout``
    with products of ``dtype`` on x of ``x_dtype`` (``dtype``'s when None)
    that aims at ``fill * SMS`` blocks: the
    position tile with the fewest tiles (then the smallest halo) among those
    whose K split can reach that many, and K cut into as many splits as it
    takes (one, when the tiles alone reach it, or when ``fill`` is 0), and
    into ranges of ``max_units`` at the most when given. The wgmma.ss tiles
    are ``_ws_tiles``' (or ``tile``, ``(th, tw)``, for the sweep), and its K
    splits whole chunks."""
    bm, bn, _, _, fixed_tw, stages, act_bufs = CONV_CONFIGS[config]
    taps = conv_taps(h, w)
    units = (cin // conv_bk(dtype)) * taps
    n_tiles = _cdiv(cout, bn)
    target = fill * SMS
    total4 = b * h * w * cout // 4
    reduce_blocks = max(1, min(_cdiv(total4, REDUCE_THREADS), 8 * SMS))
    if config == CONV_WGMMA_SS:  # K split in whole chunks, all nine taps
        chunks = units // taps
        tiles = _ws_tiles(b, h, w, cout)
        if tile is not None:
            tiles = [(*tile, b * _cdiv(h, tile[0]) * _cdiv(w, tile[1]) * n_tiles)]
        th, tw, base = next((t for t in tiles if t[2] * chunks >= target), tiles[-1])
        per = chunks if base >= target else max(1, chunks // _cdiv(target, base))
        tiles_h, tiles_w = _cdiv(h, th), _cdiv(w, tw)
        return ConvPlan(
            config=config, th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, n_tiles=n_tiles,
            units=units, units_per_split=per * taps, splits=_cdiv(chunks, per),
            grid=(b * tiles_h * tiles_w, n_tiles, _cdiv(chunks, per)),
            smem_bytes=conv_ws_smem_bytes(tw), reduce_blocks=reduce_blocks)

    def blocks(tile):
        return b * _cdiv(h, tile[0]) * _cdiv(w, tile[1]) * n_tiles

    tiles = [(bm // fixed_tw, fixed_tw)] if fixed_tw else sorted(
        ((th, tw) for tw in _tile_sizes(w, bm) for th in _tile_sizes(h, bm // tw)),
        key=lambda t: (blocks(t), (t[0] + 2) * (t[1] + 2)))
    th, tw = next((t for t in tiles if blocks(t) * units >= target), tiles[-1])
    base = blocks((th, tw))
    per = units if base >= target else max(1, units // _cdiv(target, base))
    if max_units is not None:
        per = min(per, max_units)
    tiles_h, tiles_w, splits = _cdiv(h, th), _cdiv(w, tw), _cdiv(units, per)
    return ConvPlan(
        config=config, th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, n_tiles=n_tiles,
        units=units, units_per_split=per, splits=splits,
        grid=(b * tiles_h * tiles_w, n_tiles, splits),
        smem_bytes=conv_smem_bytes(bn, th, tw, taps, stages, act_bufs, dtype, x_dtype),
        reduce_blocks=reduce_blocks)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype = torch.float32,
              x_dtype: Optional[torch.dtype] = None) -> ConvPlan:
    """The launch plan of ``gn_silu_conv3x3`` for ``[b, h, w, cin] -> cout``
    with products of ``dtype`` on x of ``x_dtype`` (``dtype``'s when None):
    ``conv_config``'s instantiation, with a tile and K split that give every
    SM a block (``make_conv_plan``), and with float32 products no split
    longer than ``CONV_F32_MAX_UNITS``."""
    return make_conv_plan(b, h, w, cin, cout, conv_config(b, h, w, cin, cout, dtype, x_dtype),
                          dtype=dtype,
                          max_units=CONV_F32_MAX_UNITS if dtype == torch.float32 else None,
                          x_dtype=x_dtype)


@functools.lru_cache(maxsize=None)
def stats_plan(b: int, hw: int, c: int) -> tuple:
    """``(parts, chunk)`` of the statistics pass over ``[b, hw, c]``: each
    batch row is cut into ``parts`` runs of ``chunk`` positions (the last may
    be shorter), one block each, at least ``STATS_MIN_ELEMS`` elements a block
    and at most ``STATS_MAX_PARTS`` blocks a row. The partial sums of a group
    are folded in part order."""
    parts = max(1, min(STATS_MAX_PARTS, _cdiv(hw * c, STATS_MIN_ELEMS)))
    chunk = _cdiv(hw, parts)
    return _cdiv(hw, chunk), chunk


# --------------------------------------------------------------- plain versions


def gn_stats_ab_reference(x, gn_scale, gn_bias, num_groups: int, eps: float):
    """Per-(batch, channel) affine ``a, b`` with ``normalized = x*a + b``.

    The maths of ``_gn_stats_ab`` (pallas_kernels.py:314): statistics over
    (spatial, channels of the group), variance as E[x^2] - mu^2, float32
    ``a, b``. The sums, mean, variance and 1/sqrt(var + eps) are taken in
    float64 and rounded to float32, as the statistics kernel folds its sums:
    so the bf16 kernels' activations round where this version's do. x is
    NHWC; returns two ``[B, C]`` float32 tensors: ``gn_fold_ab_reference`` of
    ``gn_group_sums_reference``."""
    bsz, h, w, c = x.shape
    return gn_fold_ab_reference(gn_group_sums_reference(x, num_groups), h * w, gn_scale,
                                gn_bias, eps)


def gn_group_sums_reference(x, num_groups: int):
    """Plain version of ``gn_group_sums``: each (batch, group)'s sum and sum of
    squares over the positions and the group's channels of NHWC ``x``, in
    float64, ``[B, groups, 2]``."""
    bsz, h, w, c = x.shape
    xg = x.double().reshape(bsz, h * w, num_groups, c // num_groups)
    return torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))], dim=-1)


def gn_fold_ab_reference(sums, hw: int, gn_scale, gn_bias, eps: float):
    """Plain version of ``gn_fold_ab``: the affine ``a, b`` (``[B, C]``
    float32) of ``gn_stats_ab_reference`` from the groups' float64 sums
    ``[B, groups, 2]`` over ``hw`` positions."""
    groups = sums.shape[1]
    cg = gn_scale.shape[0] // groups
    n = hw * cg
    mean = sums[..., 0] / n
    var = sums[..., 1] / n - mean * mean
    rstd = (1.0 / torch.sqrt(var + eps)).float()
    mean_c = mean.float().repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * gn_scale.float()[None, :]
    b = gn_bias.float()[None, :] - mean_c * a
    return a, b


def groupnorm_silu_reference(x, scale, bias, num_groups: int, eps: float = 1e-6,
                             apply_silu: bool = True, out_dtype: Optional[torch.dtype] = None,
                             ab=None):
    """Plain version of K3 (``_groupnorm_silu_kernel``, pallas_kernels.py:46):
    GroupNorm with ``gn_stats_ab_reference``'s statistics (or the given
    affine ``ab = (a, b)``, ``[B, C]`` float32 each), optional SiLU, in
    float32, rounded once to ``out_dtype`` (x's dtype when None)."""
    a, b = gn_stats_ab_reference(x, scale, bias, num_groups, eps) if ab is None else ab
    out = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(out_dtype or x.dtype)


def groupnorm_silu_conv3x3_reference(x, gn_scale, gn_bias, w, bias_total,
                                     num_groups: int, eps: float = 1e-6,
                                     skip=None, skip_coef: float = 1.0, ab=None,
                                     compute_dtype: Optional[torch.dtype] = None):
    """Plain version of K1/K2 (``_gn_silu_conv3x3_reference``,
    pallas_kernels.py:330): ``[skip +] conv3x3_SAME(SiLU(x*a+b)) + bias_total``,
    the sum scaled by ``skip_coef`` when ``skip`` is given, ``a, b`` x's
    statistics or the given ``ab``. NHWC in and out, HWIO weights; zero
    padding applies to the activated map.

    The products run in ``compute_dtype``, x's dtype when None: in bfloat16
    (bf16 x, or float32 x with ``compute_dtype`` bf16, as the JAX package's
    ``cd``) the float32 activation and the weights are each rounded to
    bfloat16 (to nearest even) and their products summed in float32 (exact
    products, so the float32 conv computes them); bias, skip and scale in
    float32; one rounding to x's dtype at the end."""
    a, b = gn_stats_ab_reference(x, gn_scale, gn_bias, num_groups, eps) if ab is None else ab
    v = x.float() * a[:, None, None, :] + b[:, None, None, :]
    act = (v * torch.sigmoid(v)).permute(0, 3, 1, 2)
    w = w.float()
    products = compute_dtype or x.dtype
    if products != torch.float32:
        act, w = act.to(products).float(), w.to(products).float()
    with float32_precision(x.device):
        out = F.conv2d(act, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    out = out + bias_total.float()[:, None, None, :]
    if skip is not None:
        out = (skip.float() + out) * skip_coef
    return out.to(x.dtype).contiguous()


def packed_weight_shape(cin: int, cout: int) -> tuple:
    """Shape of ``pack_conv_weight_bf16``'s output for ``[3, 3, cin, cout]``:
    (Cout tiles of 128, K chunks of 16, ``PACK_TILE``)."""
    return (_cdiv(cout, CONV_CONFIGS[CONV_WGMMA_SS][1]), cin // CONV_BK_BF16, PACK_TILE)


def pack_conv_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """An HWIO float32 conv weight ``[3, 3, Cin, Cout]`` as the wgmma.ss
    kernel reads it: each weight rounded to bfloat16 to nearest even (what
    the plain version's ``w.to(torch.bfloat16)`` does, so the products are
    the same), Cout padded with zeros to whole tiles of 128, laid out per
    (Cout tile, 16-channel K chunk) as the K-major core matrices of the
    kernel's shared-memory operand (``PACK_TILE``): one contiguous block a
    ring stage, moved by one bulk copy. Counted in ``weight_casts`` when it
    runs on the card. Returns ``packed_weight_shape(Cin, Cout)``, bfloat16."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cin % CONV_BK_BF16:
        raise ValueError(f"pack_conv_weight_bf16: w has shape {tuple(w.shape)}; expected "
                         f"(3, 3, Cin, Cout) with Cin a multiple of {CONV_BK_BF16}")
    n_tiles, chunks, _ = packed_weight_shape(cin, cout)
    with torch.no_grad():
        wp = torch.zeros((9, cin, n_tiles * 128), device=w.device, dtype=torch.bfloat16)
        wp[..., :cout] = w.reshape(9, cin, cout)
        # (tap, chunk, K 8-group, k, Cout tile, half, Cout 8-group, row) ->
        # (Cout tile, chunk, tap, half, K 8-group, Cout 8-group, row, k)
        packed = (wp.view(9, chunks, 2, 8, n_tiles, 2, 8, 8).permute(4, 1, 0, 5, 2, 6, 7, 3)
                  .reshape(n_tiles, chunks, PACK_TILE))
    if w.device.type == "cuda":
        weight_casts["gn_silu_conv3x3"] += 1
    return packed


def unpack_conv_weight_bf16(packed: torch.Tensor, cout: int) -> torch.Tensor:
    """``pack_conv_weight_bf16``'s layout back to the HWIO ``[3, 3, Cin,
    Cout]`` bfloat16 weight (the plain mapping, for the tests)."""
    n_tiles, chunks, _ = packed.shape
    w = packed.view(n_tiles, chunks, 9, 2, 2, 8, 8, 8).permute(2, 1, 4, 7, 0, 3, 5, 6)
    return w.reshape(3, 3, chunks * CONV_BK_BF16, n_tiles * 128)[..., :cout]


def fused_bias_leaky_relu_reference(x, bias, negative_slope: float = 0.2,
                                    scale: float = math.sqrt(2.0)):
    """Plain version of K4 (``_fused_bias_lrelu_kernel``, pallas_kernels.py:208):
    ``where(v >= 0, v, negative_slope * v) * scale`` with ``v = x + bias`` on
    the trailing (channel) axis, in float32, returned in x's dtype. ``bias``:
    ``[C]`` or None."""
    v = x.float()
    if bias is not None:
        v = v + bias.float()
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


# ------------------------------------------------------------------ the library


@functools.lru_cache(maxsize=None)
def _library():
    """The compiled kernel library, built and loaded on first use."""
    return bind(ctypes.CDLL(str(build_library())))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and return types on ``lib``, a
    build of ``csrc/*.cu``; returns ``lib``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.diffse_gn_stats_ab.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    lib.diffse_gn_apply.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.diffse_gn_silu_conv3x3.argtypes = [p, i, p, p, p, p, p, i, p, f, p, p, i, i, i, i, i,
                                           *[i] * 12, p]
    lib.diffse_fused_bias_lrelu.argtypes = [p, p, p, ctypes.c_longlong, i, i, f, f, p]
    lib.diffse_gn_group_sums.argtypes = [p, i, p, p, p, i, i, i, i, i, i, p]
    lib.diffse_gn_fold_ab.argtypes = [p, i, p, p, p, p, i, i, i, i, f, p]
    for fn in (lib.diffse_gn_stats_ab, lib.diffse_gn_apply, lib.diffse_gn_silu_conv3x3,
               lib.diffse_fused_bias_lrelu, lib.diffse_gn_group_sums, lib.diffse_gn_fold_ab):
        fn.restype = ctypes.c_int
    return lib


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdiffse_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds) -> None:
    """Start every command at once, wait for all; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))


def build_library() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a, one ``nvcc`` per source in parallel,
    and link them into one library, unless the library for these sources
    already exists. Returns the library's path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)
    return path


def _check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require_kernel_inputs(name: str, device: torch.device, dtypes: dict, **tensors) -> None:
    """Check what the kernel takes: each tensor on ``device``, contiguous,
    16-byte aligned, not needing grad (the differentiable ops call the
    wrappers with grad off), and of the dtype ``dtypes`` names for
    it (the activations' dtype, or float32 for parameters and biases)."""
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        want = dtypes.get(arg, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"{str(want).removeprefix('torch.')} there")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"{name}: {arg} requires grad; the wrapper has no backward (run under "
                "torch.no_grad(), or call groupnorm_silu_conv3x3_op / groupnorm_silu_op)")


def _activation_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes float32 or bfloat16")
    return x.dtype


def _products_dtype(name: str, x: torch.Tensor,
                    compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The conv's products' dtype: x's (``compute_dtype`` None), or bfloat16
    on float32 x (``compute_dtype`` bf16); any other pair raises."""
    if compute_dtype is None:
        return x.dtype
    if compute_dtype == torch.bfloat16 and x.dtype == torch.float32:
        return compute_dtype
    raise TypeError(f"{name}: compute_dtype {compute_dtype} for x of {x.dtype}; the kernel "
                    "takes None (products in x's dtype) or bfloat16 on float32 x")


def _dispatch_device(name: str, x: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {x.device}")


_tickets = {}
# counters replaced by larger ones, kept: a captured graph may hold them
_retired_tickets = []


def _ticket_counters(device: torch.device, stream: int, bsz: int) -> torch.Tensor:
    """The statistics pass's per-batch-row ticket counters on ``stream``:
    zeroed once, and left at zero by every launch (its folding block resets
    them), so launches on one stream can share them. Made outside a CUDA
    graph capture only: ``capture.Program``'s warm-up, on the capture's
    stream and at its batch, makes them before the capture."""
    key = (device.index, stream)
    counters = _tickets.get(key)
    if counters is None or counters.numel() < bsz:
        forbid_capture(device, "the statistics pass's ticket counters")
        if counters is not None:
            _retired_tickets.append(counters)
        counters = torch.zeros(max(bsz, 64), device=device, dtype=torch.int32)
        _tickets[key] = counters
    return counters


def _stats_ab(lib, x, gn_scale, gn_bias, num_groups, eps, fold_dtype=None):
    """The statistics pass's ``a, b``, folded with the arithmetic of
    ``fold_dtype`` activations (x's when None): float32 x in the conv's
    bf16-products mode takes the bf16 fold, whose ``a, b`` are the plain
    version's bit for bit, so that the activations round to bf16 alike."""
    bsz, h, w, c = x.shape
    code = 2 if (x.dtype, fold_dtype) == (torch.float32, torch.bfloat16) else _DTYPE_CODES[x.dtype]
    parts, chunk = stats_plan(bsz, h * w, c)
    a = torch.empty((bsz, c), device=x.device, dtype=torch.float32)
    b = torch.empty_like(a)
    partial = torch.empty((bsz, num_groups, parts, 2), device=x.device, dtype=torch.float64)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _ticket_counters(x.device, stream, bsz)
    _check(lib.diffse_gn_stats_ab(_ptr(x), code, _ptr(gn_scale),
                                  _ptr(gn_bias), _ptr(partial), _ptr(counters), _ptr(a),
                                  _ptr(b), bsz, h * w, c, num_groups, parts, chunk,
                                  float(eps), ctypes.c_void_p(stream)), "gn_stats_ab")
    return a, b


def gn_stats_ab(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                num_groups: int, eps: float = 1e-6):
    """The statistics pass alone (the first launch of both chains): the
    per-(batch, channel) float32 affine ``a, b`` of ``gn_stats_ab_reference``,
    from float32 or bfloat16 ``x``. Not counted in ``launch_counts``: it is
    part of the two wrappers below."""
    if not _dispatch_device("gn_stats_ab", x):
        return gn_stats_ab_reference(x, gn_scale, gn_bias, num_groups, eps)
    _check_stats_inputs("gn_stats_ab", x, gn_scale, gn_bias, num_groups)
    with torch.cuda.device(x.device):
        return _stats_ab(_library(), x, gn_scale, gn_bias, num_groups, eps)


def _check_stats_inputs(name, x, scale, bias, num_groups):
    """The statistics pass reads 16 bytes a load: 4 float32 or 8 bfloat16
    channels; C up to 2048 either way."""
    dtype = _activation_dtype(name, x)
    c, vec = x.shape[-1], 16 // x.element_size()
    if c % num_groups or c % vec or c > 4 * STATS_THREADS:
        raise ValueError(f"{name}: C={c} must divide into {num_groups} groups, be a "
                         f"multiple of {vec} and at most {4 * STATS_THREADS}")
    _require_kernel_inputs(name, x.device, {"x": dtype}, x=x, scale=scale, bias=bias)


def gn_group_sums(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The statistics pass's first half: each (batch, group)'s float64 sum and
    sum of squares over NHWC ``x`` (float32 or bfloat16), ``[B, groups, 2]``,
    summed in the order the one-pass ``gn_stats_ab`` sums them. A frames
    shard takes these over its own positions; their sum over the shards,
    folded by ``gn_fold_ab``, is the whole map's affine."""
    if not _dispatch_device("gn_group_sums", x):
        return gn_group_sums_reference(x, num_groups)
    bsz, h, w, c = x.shape
    _check_stats_inputs("gn_group_sums", x, None, None, num_groups)
    parts, chunk = stats_plan(bsz, h * w, c)
    with torch.cuda.device(x.device):
        partial = torch.empty((bsz, num_groups, parts, 2), device=x.device, dtype=torch.float64)
        sums = torch.empty((bsz, num_groups, 2), device=x.device, dtype=torch.float64)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _ticket_counters(x.device, stream, bsz)
        _check(_library().diffse_gn_group_sums(
            _ptr(x), _DTYPE_CODES[x.dtype], _ptr(partial), _ptr(counters), _ptr(sums), bsz,
            h * w, c, num_groups, parts, chunk, ctypes.c_void_p(stream)), "gn_group_sums")
    stats_launch_counts["gn_group_sums"] += 1
    return sums


def gn_fold_ab(sums: torch.Tensor, hw: int, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
               eps: float = 1e-6, dtype: torch.dtype = torch.float32):
    """The statistics pass's second half: the float32 affine ``a, b`` (``[B,
    C]`` each) from the groups' float64 sums ``[B, groups, 2]`` over ``hw``
    positions, with the arithmetic the one-pass kernel uses for activations of
    ``dtype``: ``gn_fold_ab(gn_group_sums(x), H * W, ...)`` is
    ``gn_stats_ab(x, ...)`` bit for bit."""
    if not _dispatch_device("gn_fold_ab", sums):
        return gn_fold_ab_reference(sums, hw, gn_scale, gn_bias, eps)
    bsz, groups, two = sums.shape
    c = gn_scale.shape[0]
    if two != 2 or c % groups or dtype not in _DTYPE_CODES:
        raise ValueError(f"gn_fold_ab: sums {tuple(sums.shape)} for C={c}, {dtype}")
    _require_kernel_inputs("gn_fold_ab", sums.device, {"sums": torch.float64}, sums=sums,
                           scale=gn_scale, bias=gn_bias)
    with torch.cuda.device(sums.device):
        a = torch.empty((bsz, c), device=sums.device, dtype=torch.float32)
        b = torch.empty_like(a)
        _check(_library().diffse_gn_fold_ab(
            _ptr(sums), _DTYPE_CODES[dtype], _ptr(gn_scale), _ptr(gn_bias), _ptr(a), _ptr(b),
            bsz, hw, c, groups, float(eps), _stream(sums.device)), "gn_fold_ab")
    stats_launch_counts["gn_fold_ab"] += 1
    return a, b


def _check_ab(name: str, x: torch.Tensor, ab) -> None:
    """A given affine: two contiguous float32 ``[B, C]`` on x's device."""
    shape = (x.shape[0], x.shape[-1])
    if len(ab) != 2 or any(tuple(t.shape) != shape for t in ab):
        raise ValueError(f"{name}: ab must be two [B, C] = {list(shape)} tensors")
    _require_kernel_inputs(name, x.device, {}, a=ab[0], b=ab[1])


# ------------------------------------------------------------------- wrappers


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-6, apply_silu: bool = True,
                   out_dtype: Optional[torch.dtype] = None, ab=None) -> torch.Tensor:
    """GroupNorm (+SiLU) over NHWC ``x`` (port of ``groupnorm_silu_pallas``,
    pallas_kernels.py:117). ``x``: float32 or bfloat16; ``scale``, ``bias``:
    ``[C]`` float32. Float32 statistics and maths; the output is x's dtype,
    or ``out_dtype`` (float32 for a bfloat16 x: flax's GroupNorm promotes a
    bf16 input to float32, as the attention blocks' norm does). ``ab``: the
    affine ``(a, b)`` to apply (``[B, C]`` float32 each, ``scale`` and
    ``bias`` folded in) in place of x's own statistics, whose pass is then
    skipped (a frames shard's, summed over the shards)."""
    out_dtype = out_dtype or x.dtype
    if not _dispatch_device("groupnorm_silu", x):
        return groupnorm_silu_reference(x, scale, bias, num_groups, eps, apply_silu,
                                        out_dtype, ab)
    bsz, h, w, c = x.shape
    _check_stats_inputs("groupnorm_silu", x, scale, bias, num_groups)
    if ab is not None:
        _check_ab("groupnorm_silu", x, ab)
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"groupnorm_silu: out_dtype {out_dtype} for x of {x.dtype}; "
                        "the kernel writes x's dtype or float32")
    lib = _library()
    with torch.cuda.device(x.device):
        a, b = _stats_ab(lib, x, scale, bias, num_groups, eps) if ab is None else ab
        out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
        _check(lib.diffse_gn_apply(_ptr(x), _DTYPE_CODES[x.dtype], _ptr(a), _ptr(b),
                                   _ptr(out), _DTYPE_CODES[out_dtype], bsz, h * w, c,
                                   int(apply_silu), _stream(x.device)),
               "groupnorm_silu")
    launch_counts["groupnorm_silu"] += 1
    bf16_launch_counts["groupnorm_silu"] += x.dtype == torch.bfloat16
    return out


def groupnorm_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor,
                           gn_bias: torch.Tensor, w: torch.Tensor,
                           bias_total: torch.Tensor, num_groups: int,
                           eps: float = 1e-6, skip: Optional[torch.Tensor] = None,
                           skip_coef: float = 1.0,
                           w_packed: Optional[torch.Tensor] = None, ab=None,
                           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused GroupNorm + SiLU + conv3x3 (+bias [+skip] * skip_coef), the port
    of ``groupnorm_silu_conv3x3_pallas`` (pallas_kernels.py:565) covering both
    of its regimes.

    Args:
        x: ``[B, H, W, Cin]``, float32 or bfloat16 (the products run in x's
            dtype unless ``compute_dtype`` says otherwise, accumulated in
            float32); gn_scale, gn_bias: ``[Cin]``.
        w: ``[3, 3, Cin, Cout]`` (HWIO), float32 (rounded to bfloat16 in the
            kernel for bfloat16 products).
        bias_total: ``[B, Cout]`` float32 conv bias plus any per-batch
            conditioning; a ``[Cout]`` bias expanded over the batch (row
            stride 0) is taken as it is, without a copy.
        skip: optional ``[B, H, W, Cout]`` residual, of x's dtype.
        w_packed: optional ``pack_conv_weight_bf16(w)``, which the bf16
            ``wgmma.ss`` instantiation reads; where the plan takes that
            instantiation and none is given, the wrapper packs ``w`` itself
            (counted in ``weight_casts``).
        ab: optional GroupNorm affine ``(a, b)`` (``[B, Cin]`` float32 each,
            ``gn_scale`` and ``gn_bias`` folded in) in place of x's own
            statistics, whose pass is then skipped: a frames shard's, summed
            over the shards, with x extended by its neighbours' columns.
        compute_dtype: the JAX keyword. None: products in x's dtype;
            ``torch.bfloat16`` on float32 x: the activation (computed in
            float32) and the weights rounded to bfloat16, their products
            summed in float32, bias, skip and output float32 (counted in
            ``mixed_launch_counts``). Any other pair raises ``TypeError``.

    Returns ``[B, H, W, Cout]`` of x's dtype.
    """
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"gn_silu_conv3x3: w has shape {tuple(w.shape)}, "
                         f"expected (3, 3, {cin}, Cout)")
    if w_packed is not None and (w_packed.dtype != torch.bfloat16 or cin % CONV_BK_BF16 or
                                 tuple(w_packed.shape) != packed_weight_shape(cin, cout)):
        raise ValueError(f"gn_silu_conv3x3: w_packed is {w_packed.dtype} "
                         f"{tuple(w_packed.shape)}; expected bfloat16 "
                         f"{packed_weight_shape(cin, cout)} (pack_conv_weight_bf16)")
    products = _products_dtype("gn_silu_conv3x3", x, compute_dtype)
    if not _dispatch_device("gn_silu_conv3x3", x):
        return groupnorm_silu_conv3x3_reference(x, gn_scale, gn_bias, w, bias_total,
                                                num_groups, eps, skip, skip_coef, ab,
                                                compute_dtype)
    dtype = _activation_dtype("gn_silu_conv3x3", x)
    bk = conv_bk(products)
    if cin % bk or cout % 4 or cin % num_groups or cin > 4 * STATS_THREADS:
        raise ValueError(f"gn_silu_conv3x3: Cin={cin} must be a multiple of {bk} and "
                         f"of {num_groups} groups and at most {4 * STATS_THREADS}, "
                         f"Cout={cout} a multiple of 4")
    if tuple(bias_total.shape) != (bsz, cout):
        raise ValueError("gn_silu_conv3x3: bias_total must be [B, Cout]")
    bias_row_stride = bias_total.stride(0) if bsz > 1 else 0
    if bias_total.stride(1) != 1 or bias_row_stride not in (0, cout):
        raise ValueError("gn_silu_conv3x3: bias_total's rows must be contiguous "
                         "or one row expanded over the batch")
    if skip is not None and tuple(skip.shape) != (bsz, h, wd, cout):
        raise ValueError("gn_silu_conv3x3: skip must be [B, H, W, Cout]")
    bias_rows = bias_total[0] if bias_row_stride == 0 else bias_total
    _require_kernel_inputs("gn_silu_conv3x3", x.device, {"x": dtype, "skip": dtype}, x=x,
                           gn_scale=gn_scale, gn_bias=gn_bias, w=w, bias_total=bias_rows,
                           skip=skip)
    if ab is not None:
        _check_ab("gn_silu_conv3x3", x, ab)
    x_dtype = None if products == dtype else dtype
    plan = conv_plan(bsz, h, wd, cin, cout, products, x_dtype)
    if plan.config != CONV_WGMMA_SS:
        w_packed = None
    elif w_packed is None:
        w_packed = pack_conv_weight_bf16(w)
    else:
        _require_kernel_inputs("gn_silu_conv3x3", x.device, {"w_packed": torch.bfloat16},
                               w_packed=w_packed)
    lib = _library()
    with torch.cuda.device(x.device):
        a, b = (_stats_ab(lib, x, gn_scale, gn_bias, num_groups, eps, products) if ab is None
                else ab)
        out = torch.empty((bsz, h, wd, cout), device=x.device, dtype=dtype)
        partial = None if plan.splits == 1 else torch.empty(
            (plan.splits, bsz * h * wd, cout), device=x.device, dtype=torch.float32)
        _check(lib.diffse_gn_silu_conv3x3(
            _ptr(x), _CONV_MODES[dtype, products], _ptr(a), _ptr(b), _ptr(w), _ptr(w_packed),
            _ptr(bias_rows), bias_row_stride,
            _ptr(skip), float(skip_coef), _ptr(out), _ptr(partial), bsz, h, wd, cin, cout,
            plan.config, plan.th, plan.tw, plan.tiles_w, plan.tiles_h * plan.tiles_w,
            plan.units_per_split, plan.splits, *plan.grid, plan.smem_bytes,
            plan.reduce_blocks, _stream(x.device)),
            "gn_silu_conv3x3")
    launch_counts["gn_silu_conv3x3"] += 1
    bf16_launch_counts["gn_silu_conv3x3"] += dtype == torch.bfloat16
    mixed_launch_counts["gn_silu_conv3x3"] += products != dtype
    conv_config_launches[plan.config] += 1
    return out


# ------------------------------------------------------------- differentiable ops


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None entries skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _recompute_grads(name: str, ctx, plain, grad_out: torch.Tensor, inputs) -> tuple:
    """The gradients of ``plain(*inputs)`` (a plain version, recomputed from
    the saved inputs under autograd) against ``grad_out``, for each input
    that ``ctx.needs_input_grad`` asks for, None for the others. Each input
    is its own leaf, so a tensor given twice (an identity skip is ``x``)
    gets both gradients, which autograd adds; a ``[Cout]`` bias expanded
    over the batch gets a ``[B, Cout]`` gradient, which the expand's
    backward sums over the batch. cuDNN's convolutions run in float32 here,
    as in the forward. Counted in ``recompute_counts[name]``, and marked for
    the profiler as "<name> backward (recompute)"."""
    recompute_counts[name] += 1
    wanted = [t is not None and need for t, need in zip(inputs, ctx.needs_input_grad)]
    leaves = [None if t is None else t.detach().requires_grad_(want)
              for t, want in zip(inputs, wanted)]
    with (torch.profiler.record_function(f"{name} backward (recompute)"), torch.enable_grad(),
          float32_precision(grad_out.device)):
        out = plain(*leaves)
        grads = iter(torch.autograd.grad(out, [t for t, want in zip(leaves, wanted) if want],
                                         grad_out))
    return tuple(next(grads) if want else None for want in wanted)


class GroupNormSiLUConv3x3(torch.autograd.Function):
    """``groupnorm_silu_conv3x3`` with a gradient: the counterpart of the
    JAX package's ``_gn_silu_conv3x3_vjp`` (pallas_kernels.py:524-559). The
    forward runs the wrapper's op (the kernel on the card) and saves only the
    inputs, ``_gn_silu_conv3x3_fwd``'s residuals; the backward recomputes
    ``groupnorm_silu_conv3x3_reference`` and takes its gradients with respect
    to x, gn_scale, gn_bias, the float32 w (through the bf16 rounding of a
    bf16 x, as ``w.astype(compute_dtype)`` in JAX), bias_total and skip.
    ``w_packed`` is a copy of w for the bf16 kernel and carries no gradient.
    With a given affine ``a, b`` the gradients go to them in place of
    gn_scale and gn_bias, which the function then does not read. With
    ``compute_dtype`` (bf16 products on a float32 map) the recompute rounds
    as the forward does."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, w, bias_total, skip, a, b, w_packed, num_groups,
                eps, skip_coef, compute_dtype=None):
        ctx.save_for_backward(x, gn_scale, gn_bias, w, bias_total, skip, a, b)
        ctx.settings = (num_groups, eps, skip_coef, compute_dtype)
        return gn_silu_conv3x3_custom_op(x, gn_scale, gn_bias, w, bias_total, num_groups, eps,
                                         skip, skip_coef, w_packed, a, b, compute_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        num_groups, eps, skip_coef, compute_dtype = ctx.settings

        def plain(x, gn_scale, gn_bias, w, bias_total, skip, a, b):
            return groupnorm_silu_conv3x3_reference(x, gn_scale, gn_bias, w, bias_total,
                                                    num_groups, eps, skip, skip_coef,
                                                    _given_ab(a, b), compute_dtype)

        grads = _recompute_grads("gn_silu_conv3x3", ctx, plain, grad_out,
                                 _read_inputs(ctx.saved_tensors))
        return (*grads, None, None, None, None, None)


class GroupNormSiLU(torch.autograd.Function):
    """``groupnorm_silu`` with a gradient. The JAX package gives K3 no custom
    VJP: its gradient is that of ``_groupnorm_silu_jnp``
    (pallas_kernels.py:195), the same function. The forward runs the op
    and saves the inputs; the backward recomputes
    ``groupnorm_silu_reference`` and takes its gradients with respect to x,
    scale and bias (with a given affine ``a, b``: x, a and b)."""

    @staticmethod
    def forward(ctx, x, scale, bias, a, b, num_groups, eps, apply_silu, out_dtype):
        ctx.save_for_backward(x, scale, bias, a, b)
        ctx.settings = (num_groups, eps, apply_silu, out_dtype)
        return groupnorm_silu_custom_op(x, scale, bias, num_groups, eps, apply_silu, out_dtype,
                                        a, b)

    @staticmethod
    def backward(ctx, grad_out):
        num_groups, eps, apply_silu, out_dtype = ctx.settings

        def plain(x, scale, bias, a, b):
            return groupnorm_silu_reference(x, scale, bias, num_groups, eps, apply_silu,
                                            out_dtype, _given_ab(a, b))

        grads = _recompute_grads("groupnorm_silu", ctx, plain, grad_out,
                                 _read_inputs(ctx.saved_tensors))
        return (*grads, None, None, None, None)


def _given_ab(a, b):
    return None if a is None else (a, b)


def _read_inputs(saved: tuple) -> tuple:
    """The saved inputs ``(x, scale, bias, ..., a, b)`` of a GroupNorm op for
    its recompute: with a given affine ``a, b`` the GroupNorm's scale and
    bias are replaced by None, since the function does not read them."""
    if saved[-1] is None:
        return saved
    return (saved[0], None, None, *saved[3:])


def groupnorm_silu_conv3x3_op(x: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                              w: torch.Tensor, bias_total: torch.Tensor, num_groups: int,
                              eps: float = 1e-6, skip: Optional[torch.Tensor] = None,
                              skip_coef: float = 1.0,
                              w_packed: Optional[torch.Tensor] = None,
                              ab=None, compute_dtype: Optional[torch.dtype] = None
                              ) -> torch.Tensor:
    """``groupnorm_silu_conv3x3`` (same arguments) that autograd can
    differentiate (``GroupNormSiLUConv3x3``); the wrapper's op when no
    input needs a gradient (under ``torch.no_grad()``, for one)."""
    a, b = (None, None) if ab is None else ab
    if not needs_grad(x, gn_scale, gn_bias, w, bias_total, skip, a, b):
        return gn_silu_conv3x3_custom_op(x, gn_scale, gn_bias, w, bias_total, num_groups, eps,
                                         skip, skip_coef, w_packed, a, b, compute_dtype)
    return GroupNormSiLUConv3x3.apply(x, gn_scale, gn_bias, w, bias_total, skip, a, b,
                                      w_packed, num_groups, eps, skip_coef, compute_dtype)


def groupnorm_silu_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-6, apply_silu: bool = True,
                      out_dtype: Optional[torch.dtype] = None, ab=None) -> torch.Tensor:
    """``groupnorm_silu`` (same arguments) that autograd can differentiate
    (``GroupNormSiLU``); the wrapper's op when no input needs a gradient."""
    a, b = (None, None) if ab is None else ab
    if not needs_grad(x, scale, bias, a, b):
        return groupnorm_silu_custom_op(x, scale, bias, num_groups, eps, apply_silu, out_dtype,
                                        a, b)
    return GroupNormSiLU.apply(x, scale, bias, a, b, num_groups, eps, apply_silu, out_dtype)


def fused_bias_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          negative_slope: float = 0.2,
                          scale: float = math.sqrt(2.0)) -> torch.Tensor:
    """``leaky_relu(x + bias, negative_slope) * scale`` over a channels-last
    ``x [..., C]`` (port of ``fused_bias_leaky_relu_pallas``,
    pallas_kernels.py:215). ``bias``: ``[C]`` of x's dtype, or None. Float32
    or bfloat16 in and out, float32 maths."""
    if not _dispatch_device("fused_bias_leaky_relu", x):
        return fused_bias_leaky_relu_reference(x, bias, negative_slope, scale)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bias_leaky_relu: x is {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if x.ndim == 0:
        raise ValueError("fused_bias_leaky_relu: x needs a trailing channel axis")
    c = x.shape[-1]
    for arg, t in (("x", x), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"fused_bias_leaky_relu: {arg} is on {t.device}, "
                             f"expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"fused_bias_leaky_relu: {arg} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_bias_leaky_relu: {arg} must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"fused_bias_leaky_relu: {arg} requires grad; the kernel has no "
                "backward yet (run under torch.no_grad())")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"fused_bias_leaky_relu: bias has shape {tuple(bias.shape)}, "
                         f"expected ({c},)")
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _check(lib.diffse_fused_bias_lrelu(
            _ptr(x), _ptr(bias), _ptr(out), x.numel() // c if c else 0, c,
            _DTYPE_CODES[x.dtype], float(negative_slope), float(scale),
            _stream(x.device)), "fused_bias_leaky_relu")
    launch_counts["fused_bias_leaky_relu"] += 1
    return out


# ------------------------------------------------------------------- custom ops
#
# The three wrappers as operators of the ``diffse`` namespace, so that a
# program traced by ``torch.export`` keeps them as single nodes (a ctypes
# call cannot be traced: a fake tensor has no memory). Each op's CPU and
# CUDA implementation is the wrapper above, which picks the plain version or
# the kernel by its input's device (``_dispatch_device``); the fake
# implementation gives the output's shape and dtype. The model's layers reach
# the GroupNorm ops through ``groupnorm_silu_conv3x3_op`` and
# ``groupnorm_silu_op``; ``ops.fused_act`` reaches the third. Registering
# them builds nothing. A given GroupNorm affine is the two trailing optional
# tensors ``a``, ``b`` of the GroupNorm ops (the wrappers' ``ab``).

OP_NAMESPACE = "diffse"
_OP_SCHEMAS = {
    "groupnorm_silu_conv3x3": (
        "(Tensor x, Tensor gn_scale, Tensor gn_bias, Tensor w, Tensor bias_total, "
        "int num_groups, float eps=1e-06, Tensor? skip=None, float skip_coef=1.0, "
        "Tensor? w_packed=None, Tensor? a=None, Tensor? b=None, "
        "ScalarType? compute_dtype=None) -> Tensor",
        lambda x, gn_scale, gn_bias, w, bias_total, num_groups, eps=1e-6, skip=None,
        skip_coef=1.0, w_packed=None, a=None, b=None, compute_dtype=None:
        groupnorm_silu_conv3x3(x, gn_scale, gn_bias, w, bias_total, num_groups, eps, skip,
                               skip_coef, w_packed, _given_ab(a, b), compute_dtype)),
    "groupnorm_silu": (
        "(Tensor x, Tensor scale, Tensor bias, int num_groups, float eps=1e-06, "
        "bool apply_silu=True, ScalarType? out_dtype=None, Tensor? a=None, Tensor? b=None) "
        "-> Tensor",
        lambda x, scale, bias, num_groups, eps=1e-6, apply_silu=True, out_dtype=None, a=None,
        b=None: groupnorm_silu(x, scale, bias, num_groups, eps, apply_silu, out_dtype,
                               _given_ab(a, b))),
    "fused_bias_leaky_relu": (
        "(Tensor x, Tensor? bias=None, float negative_slope=0.2, "
        "float scale=1.4142135623730951) -> Tensor", fused_bias_leaky_relu),
}


def _conv_fake(x, gn_scale, gn_bias, w, bias_total, num_groups, eps=1e-6, skip=None,
               skip_coef=1.0, w_packed=None, a=None, b=None, compute_dtype=None):
    return x.new_empty((*x.shape[:3], w.shape[-1]))


def _groupnorm_fake(x, scale, bias, num_groups, eps=1e-6, apply_silu=True, out_dtype=None,
                    a=None, b=None):
    return x.new_empty(x.shape, dtype=out_dtype or x.dtype)


def _fused_act_fake(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    return torch.empty_like(x)


_OP_FAKES = {"groupnorm_silu_conv3x3": _conv_fake, "groupnorm_silu": _groupnorm_fake,
             "fused_bias_leaky_relu": _fused_act_fake}

for _name, (_schema, _wrapper) in _OP_SCHEMAS.items():
    _qualname = f"{OP_NAMESPACE}::{_name}"
    torch.library.define(_qualname, _schema)
    torch.library.impl(_qualname, ("cpu", "cuda"), _wrapper)
    torch.library.register_fake(_qualname, _OP_FAKES[_name])
del _name, _schema, _wrapper, _qualname

gn_silu_conv3x3_custom_op = torch.ops.diffse.groupnorm_silu_conv3x3.default
groupnorm_silu_custom_op = torch.ops.diffse.groupnorm_silu.default
fused_bias_leaky_relu_custom_op = torch.ops.diffse.fused_bias_leaky_relu.default
