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
and accumulation, as the Pallas kernels do. Each wrapper dispatches on the
device of its input:

  - a CPU tensor takes the plain PyTorch version beside the kernel (the same
    maths as the Pallas kernel's jnp reference);
  - a CUDA tensor launches the kernel, or raises on a dtype, shape or stride
    the kernel does not take, or when autograd would need a backward (the
    backward comes with training);
  - anything else raises.

``launch_counts`` counts each wrapper's kernel launches (nowhere else), so a
run can show that the model went through the kernels.

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

from ..utils import float32_precision

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

launch_counts = {"gn_silu_conv3x3": 0, "groupnorm_silu": 0, "fused_bias_leaky_relu": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
# The conv kernel's instantiations, by the id the C entry point switches on:
# (BM positions, BN output channels, threads, instruction, tile width: 0 for
# any, else the wgmma kernel's fixed TW, with 128 / TW rows, stages of the
# ring, activated tiles).
CONV_CONFIGS = ((64, 64, 128, "mma.sync", 0, 3, 2), (128, 8, 256, "mma.sync", 0, 3, 2),
                (128, 128, 256, "wgmma", 32, 2, 1))
CONV_MMA, CONV_MMA_HEAD, CONV_WGMMA = range(3)
# Float32 rows of at least this many positions take the wgmma kernel (half
# its 32-position row tile): narrower maps run faster on mma.sync's smaller
# tiles (tools/conv_plan_sweep.py).
CONV_WGMMA_MIN_W = 16
# In bf16 the wgmma kernel (one block per SM) is the faster from 8 positions
# a row, at one utterance and at bench.py's 16 (tools/conv_plan_sweep.py
# --dtype bf16); narrower rows gain at 16 utterances and lose at one.
CONV_WGMMA_MIN_W_BF16 = 8
REDUCE_THREADS = 256      # csrc kReduceThreads
STATS_THREADS = 512       # csrc kStatsThreads
STATS_MIN_ELEMS = 8192    # elements a statistics block reads at the least
STATS_MAX_PARTS = 128     # blocks per batch row: the last one folds groups x parts


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_bk(dtype: torch.dtype = torch.float32) -> int:
    """Input channels per K chunk of the conv for activations of ``dtype``:
    32 bytes of each position either way."""
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
                    act_bufs: int = 2, dtype: torch.dtype = torch.float32) -> int:
    """csrc ``conv_smem_bytes``: the cp.async ring of ``stages`` (raw x halo,
    32 bytes a position, and float32 weights per stage) and ``act_bufs``
    activated halo tiles (float32 hi and lo, 64 bytes a position; bfloat16,
    32 bytes)."""
    halo = (th + 2) * (tw + 2)
    bk = conv_bk(dtype)
    act_bytes = 32 if dtype == torch.bfloat16 else 4 * CONV_ACT_FLOATS
    return (stages * (halo * 32 + 4 * taps * bk * _weight_row_stride(bn, dtype))
            + act_bufs * halo * act_bytes)


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


def conv_config(h: int, w: int, cout: int, dtype: torch.dtype = torch.float32) -> int:
    """The instantiation for an ``h x w`` map and ``cout``: the narrow
    ``mma.sync`` block for the Cout <= 8 heads; ``wgmma`` where all nine taps
    touch the map and a row has ``CONV_WGMMA_MIN_W`` positions or more
    (``CONV_WGMMA_MIN_W_BF16`` for bf16 activations); else the 64x64
    ``mma.sync`` block."""
    if cout <= 8:
        return CONV_MMA_HEAD
    min_w = CONV_WGMMA_MIN_W_BF16 if dtype == torch.bfloat16 else CONV_WGMMA_MIN_W
    if conv_taps(h, w) == 9 and w >= min_w:
        return CONV_WGMMA
    return CONV_MMA


def make_conv_plan(b: int, h: int, w: int, cin: int, cout: int, config: int,
                   fill: int = 1, dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The plan of instantiation ``config`` for ``[b, h, w, cin] -> cout``
    with activations of ``dtype`` that aims at ``fill * SMS`` blocks: the
    position tile with the fewest tiles (then the smallest halo) among those
    whose K split can reach that many, and K cut into as many splits as it
    takes (one, when the tiles alone reach it, or when ``fill`` is 0)."""
    bm, bn, _, _, fixed_tw, stages, act_bufs = CONV_CONFIGS[config]
    taps = conv_taps(h, w)
    units = (cin // conv_bk(dtype)) * taps
    n_tiles = _cdiv(cout, bn)
    target = fill * SMS

    def blocks(tile):
        return b * _cdiv(h, tile[0]) * _cdiv(w, tile[1]) * n_tiles

    tiles = [(bm // fixed_tw, fixed_tw)] if fixed_tw else sorted(
        ((th, tw) for tw in _tile_sizes(w, bm) for th in _tile_sizes(h, bm // tw)),
        key=lambda t: (blocks(t), (t[0] + 2) * (t[1] + 2)))
    th, tw = next((t for t in tiles if blocks(t) * units >= target), tiles[-1])
    base = blocks((th, tw))
    per = units if base >= target else max(1, units // _cdiv(target, base))
    total4 = b * h * w * cout // 4
    tiles_h, tiles_w, splits = _cdiv(h, th), _cdiv(w, tw), _cdiv(units, per)
    return ConvPlan(
        config=config, th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, n_tiles=n_tiles,
        units=units, units_per_split=per, splits=splits,
        grid=(b * tiles_h * tiles_w, n_tiles, splits),
        smem_bytes=conv_smem_bytes(bn, th, tw, taps, stages, act_bufs, dtype),
        reduce_blocks=max(1, min(_cdiv(total4, REDUCE_THREADS), 8 * SMS)))


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype = torch.float32) -> ConvPlan:
    """The launch plan of ``gn_silu_conv3x3`` for ``[b, h, w, cin] -> cout``
    with activations of ``dtype``: ``conv_config``'s instantiation, with a
    tile and K split that give every SM a block (``make_conv_plan``)."""
    return make_conv_plan(b, h, w, cin, cout, conv_config(h, w, cout, dtype), dtype=dtype)


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
    NHWC; returns two ``[B, C]`` float32 tensors."""
    bsz, h, w, c = x.shape
    cg = c // num_groups
    xg = x.double().reshape(bsz, h * w, num_groups, cg)
    n = h * w * cg
    mean = xg.sum(dim=(1, 3)) / n
    var = (xg * xg).sum(dim=(1, 3)) / n - mean * mean
    rstd = (1.0 / torch.sqrt(var + eps)).float()
    mean_c = mean.float().repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * gn_scale.float()[None, :]
    b = gn_bias.float()[None, :] - mean_c * a
    return a, b


def groupnorm_silu_reference(x, scale, bias, num_groups: int, eps: float = 1e-6,
                             apply_silu: bool = True, out_dtype: Optional[torch.dtype] = None):
    """Plain version of K3 (``_groupnorm_silu_kernel``, pallas_kernels.py:46):
    GroupNorm with ``gn_stats_ab_reference``'s statistics, optional SiLU, in
    float32, rounded once to ``out_dtype`` (x's dtype when None)."""
    a, b = gn_stats_ab_reference(x, scale, bias, num_groups, eps)
    out = x.float() * a[:, None, None, :] + b[:, None, None, :]
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(out_dtype or x.dtype)


def groupnorm_silu_conv3x3_reference(x, gn_scale, gn_bias, w, bias_total,
                                     num_groups: int, eps: float = 1e-6,
                                     skip=None, skip_coef: float = 1.0):
    """Plain version of K1/K2 (``_gn_silu_conv3x3_reference``,
    pallas_kernels.py:330): ``[skip +] conv3x3_SAME(SiLU(x*a+b)) + bias_total``,
    the sum scaled by ``skip_coef`` when ``skip`` is given. NHWC in and out,
    HWIO weights; zero padding applies to the activated map.

    The products run in x's dtype: for bfloat16 x (``compute_dtype`` bf16 in
    the JAX package) the float32 activation and the weights are each rounded
    to bfloat16 (to nearest even) and their products summed in float32 (exact
    products, so the float32 conv computes them); bias, skip and scale in
    float32; one rounding to bfloat16 at the end."""
    a, b = gn_stats_ab_reference(x, gn_scale, gn_bias, num_groups, eps)
    v = x.float() * a[:, None, None, :] + b[:, None, None, :]
    act = (v * torch.sigmoid(v)).permute(0, 3, 1, 2)
    w = w.float()
    if x.dtype != torch.float32:
        act, w = act.to(x.dtype).float(), w.to(x.dtype).float()
    with float32_precision(x.device):
        out = F.conv2d(act, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    out = out + bias_total.float()[:, None, None, :]
    if skip is not None:
        out = (skip.float() + out) * skip_coef
    return out.to(x.dtype).contiguous()


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
    lib.diffse_gn_silu_conv3x3.argtypes = [p, i, p, p, p, p, i, p, f, p, p, i, i, i, i, i,
                                           *[i] * 12, p]
    lib.diffse_fused_bias_lrelu.argtypes = [p, p, p, ctypes.c_longlong, i, i, f, f, p]
    for fn in (lib.diffse_gn_stats_ab, lib.diffse_gn_apply, lib.diffse_gn_silu_conv3x3,
               lib.diffse_fused_bias_lrelu):
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
    16-byte aligned, not needing grad, and of the dtype ``dtypes`` names for
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
                f"{name}: {arg} requires grad; the kernel has no backward yet "
                "(run under torch.no_grad())")


def _activation_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes float32 or bfloat16")
    return x.dtype


def _dispatch_device(name: str, x: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {x.device}")


_tickets = {}


def _ticket_counters(device: torch.device, stream: int, bsz: int) -> torch.Tensor:
    """The statistics pass's per-batch-row ticket counters on ``stream``:
    zeroed once, and left at zero by every launch (its folding block resets
    them), so launches on one stream can share them."""
    key = (device.index, stream)
    counters = _tickets.get(key)
    if counters is None or counters.numel() < bsz:
        counters = torch.zeros(max(bsz, 64), device=device, dtype=torch.int32)
        _tickets[key] = counters
    return counters


def _stats_ab(lib, x, gn_scale, gn_bias, num_groups, eps):
    bsz, h, w, c = x.shape
    parts, chunk = stats_plan(bsz, h * w, c)
    a = torch.empty((bsz, c), device=x.device, dtype=torch.float32)
    b = torch.empty_like(a)
    partial = torch.empty((bsz, num_groups, parts, 2), device=x.device, dtype=torch.float64)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counters = _ticket_counters(x.device, stream, bsz)
    _check(lib.diffse_gn_stats_ab(_ptr(x), _DTYPE_CODES[x.dtype], _ptr(gn_scale),
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


# ------------------------------------------------------------------- wrappers


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-6, apply_silu: bool = True,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm (+SiLU) over NHWC ``x`` (port of ``groupnorm_silu_pallas``,
    pallas_kernels.py:117). ``x``: float32 or bfloat16; ``scale``, ``bias``:
    ``[C]`` float32. Float32 statistics and maths; the output is x's dtype,
    or ``out_dtype`` (float32 for a bfloat16 x: flax's GroupNorm promotes a
    bf16 input to float32, as the attention blocks' norm does)."""
    out_dtype = out_dtype or x.dtype
    if not _dispatch_device("groupnorm_silu", x):
        return groupnorm_silu_reference(x, scale, bias, num_groups, eps, apply_silu,
                                        out_dtype)
    bsz, h, w, c = x.shape
    _check_stats_inputs("groupnorm_silu", x, scale, bias, num_groups)
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"groupnorm_silu: out_dtype {out_dtype} for x of {x.dtype}; "
                        "the kernel writes x's dtype or float32")
    lib = _library()
    with torch.cuda.device(x.device):
        a, b = _stats_ab(lib, x, scale, bias, num_groups, eps)
        out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
        _check(lib.diffse_gn_apply(_ptr(x), _DTYPE_CODES[x.dtype], _ptr(a), _ptr(b),
                                   _ptr(out), _DTYPE_CODES[out_dtype], bsz, h * w, c,
                                   int(apply_silu), _stream(x.device)),
               "groupnorm_silu")
    launch_counts["groupnorm_silu"] += 1
    return out


def groupnorm_silu_conv3x3(x: torch.Tensor, gn_scale: torch.Tensor,
                           gn_bias: torch.Tensor, w: torch.Tensor,
                           bias_total: torch.Tensor, num_groups: int,
                           eps: float = 1e-6, skip: Optional[torch.Tensor] = None,
                           skip_coef: float = 1.0) -> torch.Tensor:
    """Fused GroupNorm + SiLU + conv3x3 (+bias [+skip] * skip_coef), the port
    of ``groupnorm_silu_conv3x3_pallas`` (pallas_kernels.py:565) covering both
    of its regimes.

    Args:
        x: ``[B, H, W, Cin]``, float32 or bfloat16 (the products run in x's
            dtype, accumulated in float32); gn_scale, gn_bias: ``[Cin]``.
        w: ``[3, 3, Cin, Cout]`` (HWIO), float32 (rounded to bfloat16 in the
            kernel for a bfloat16 x).
        bias_total: ``[B, Cout]`` float32 conv bias plus any per-batch
            conditioning; a ``[Cout]`` bias expanded over the batch (row
            stride 0) is taken as it is, without a copy.
        skip: optional ``[B, H, W, Cout]`` residual, of x's dtype.

    Returns ``[B, H, W, Cout]`` of x's dtype.
    """
    if not _dispatch_device("gn_silu_conv3x3", x):
        return groupnorm_silu_conv3x3_reference(x, gn_scale, gn_bias, w, bias_total,
                                                num_groups, eps, skip, skip_coef)
    dtype = _activation_dtype("gn_silu_conv3x3", x)
    bk = conv_bk(dtype)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"gn_silu_conv3x3: w has shape {tuple(w.shape)}, "
                         f"expected (3, 3, {cin}, Cout)")
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
    plan = conv_plan(bsz, h, wd, cin, cout, dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        a, b = _stats_ab(lib, x, gn_scale, gn_bias, num_groups, eps)
        out = torch.empty((bsz, h, wd, cout), device=x.device, dtype=dtype)
        partial = None if plan.splits == 1 else torch.empty(
            (plan.splits, bsz * h * wd, cout), device=x.device, dtype=torch.float32)
        _check(lib.diffse_gn_silu_conv3x3(
            _ptr(x), _DTYPE_CODES[dtype], _ptr(a), _ptr(b), _ptr(w), _ptr(bias_rows),
            bias_row_stride,
            _ptr(skip), float(skip_coef), _ptr(out), _ptr(partial), bsz, h, wd, cin, cout,
            plan.config, plan.th, plan.tw, plan.tiles_w, plan.tiles_h * plan.tiles_w,
            plan.units_per_split, plan.splits, *plan.grid, plan.smem_bytes,
            plan.reduce_blocks, _stream(x.device)),
            "gn_silu_conv3x3")
    launch_counts["gn_silu_conv3x3"] += 1
    return out


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
