"""The launch plans of the GroupNorm kernels, and their arithmetic, on the CPU.

``conv_plan`` and ``stats_plan`` (diffse_tpu_torch/ops/cuda_kernels.py) are
pure functions of the shapes. These tests hold them at every shape the 65M
NCSN++ forward runs at T = 64, 128 and 192 frames in float32, and in bfloat16
at T = 64 for one utterance and bench.py's batch of 16, and emulate in torch
what the CUDA kernels compute block by block under those plans: the conv's
3xTF32 split (or its bf16 products) and its K splits added in order, and the
statistics pass's partial sums folded in part order. The kernels themselves run only on the card
(tests/test_torch_kernels.py, ``-m gpu``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.ops.main_path_shapes import (BENCH_BATCH, BENCH_FRAMES, CONV_SHAPES_T64,
                                                   FRAMES, GN_SHAPES_T64, RUNS, at_frames)

torch.set_num_threads(2)

KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)

# Maps up to [64, 32] (T=128) are the deep and middle levels: one block per
# output tile leaves most of the card idle there, so their plans split K.
DEEP_HW = 64 * 32


CONV_CASES = [(t, s[:4]) for t in FRAMES for s in at_frames(t, CONV_SHAPES_T64)]
GN_CASES = [(t, s) for t in FRAMES for s in at_frames(t, GN_SHAPES_T64)]
# the bf16 trunk's runs: (batch, frames) and every conv shape of a forward
BF16_CONV_CASES = [(b, t, s[:4]) for b, t, dtype in RUNS if dtype == torch.bfloat16
                   for s in at_frames(t, CONV_SHAPES_T64)]


def _check_conv_plan(b, h, w, cin, cout, dtype):
    plan = ck.conv_plan(b, h, w, cin, cout, dtype)
    bm, bn = ck.CONV_CONFIGS[plan.config][:2]
    assert plan.ctas >= ck.SMS or plan.splits == 1
    if h * w <= DEEP_HW:
        assert plan.ctas >= ck.SMS, plan
    # tiles and splits cover M, N and K exactly once
    assert plan.th * plan.tw <= bm
    rows = np.zeros((h, w), int)
    for i in range(plan.tiles_h):
        for j in range(plan.tiles_w):
            rows[i * plan.th:(i + 1) * plan.th, j * plan.tw:(j + 1) * plan.tw] += 1
    assert (rows == 1).all()
    cols = np.zeros(cout, int)
    for n in range(plan.n_tiles):
        cols[n * bn:(n + 1) * bn] += 1
    assert (cols == 1).all()
    assert plan.units == cin // ck.conv_bk(dtype) * ck.conv_taps(h, w)
    units = np.zeros(plan.units, int)
    for z in range(plan.splits):
        units[z * plan.units_per_split:(z + 1) * plan.units_per_split] += 1
    assert (units == 1).all()
    assert plan.grid == (b * plan.tiles_h * plan.tiles_w, plan.n_tiles, plan.splits)
    # the shared memory fits, and is what the kernel carves
    stages, act_bufs = ck.CONV_CONFIGS[plan.config][5:]
    assert plan.smem_bytes == ck.conv_smem_bytes(bn, plan.th, plan.tw, ck.conv_taps(h, w),
                                                 stages, act_bufs, dtype)
    assert plan.smem_bytes <= ck.SMEM_LIMIT
    return plan


@pytest.mark.parametrize("frames,shape", CONV_CASES,
                         ids=[f"T{t}-{'x'.join(map(str, s))}" for t, s in CONV_CASES])
def test_conv_plan_fills_the_card_and_covers_once(frames, shape):
    _check_conv_plan(1, *shape, torch.float32)


@pytest.mark.parametrize("batch,frames,shape", BF16_CONV_CASES,
                         ids=[f"B{b}-T{t}-{'x'.join(map(str, s))}" for b, t, s in BF16_CONV_CASES])
def test_conv_plan_bf16_fills_the_card_and_covers_once(batch, frames, shape):
    """The bf16 trunk's plans: K units of 16 channels (one k16 product a
    tap), the float32 weights' ring in shared memory, at one utterance and
    at bench.py's batch of 16."""
    plan = _check_conv_plan(batch, *shape, torch.bfloat16)
    h, w, cin, cout = shape
    assert plan.config == ck.conv_config(h, w, cout, torch.bfloat16)
    if batch == BENCH_BATCH and frames == BENCH_FRAMES and h * w >= 64 * 16 and cout > 8:
        # 16 utterances give the large levels' trunk convs blocks enough
        # without a K split
        assert plan.splits == 1


@pytest.mark.parametrize("h,w,cout,config", [
    (4, 1, 256, ck.CONV_MMA), (4, 3, 256, ck.CONV_MMA), (16, 12, 256, ck.CONV_MMA),
    (32, 8, 256, ck.CONV_MMA), (1, 64, 256, ck.CONV_MMA), (64, 16, 256, ck.CONV_WGMMA),
    (32, 24, 256, ck.CONV_WGMMA), (64, 32, 256, ck.CONV_WGMMA), (5, 40, 128, ck.CONV_WGMMA),
    (256, 192, 128, ck.CONV_WGMMA), (4, 1, 4, ck.CONV_MMA_HEAD), (256, 64, 4, ck.CONV_MMA_HEAD)])
def test_conv_config_by_map_and_cout(h, w, cout, config):
    """The heads take the narrow block; rows of 16 or more positions with all
    nine taps the wgmma kernel; the rest (a map of height 1 too) mma.sync."""
    assert ck.conv_config(h, w, cout) == config
    assert ck.conv_plan(1, h, w, 256, cout).config == config


@pytest.mark.parametrize("h,w,cout,config", [
    (4, 1, 256, ck.CONV_MMA), (8, 2, 256, ck.CONV_MMA), (16, 4, 256, ck.CONV_MMA),
    (32, 8, 256, ck.CONV_WGMMA), (16, 8, 512, ck.CONV_WGMMA), (64, 16, 256, ck.CONV_WGMMA),
    (256, 64, 4, ck.CONV_MMA_HEAD)])
def test_conv_config_bf16(h, w, cout, config):
    """In bf16 the wgmma kernel takes rows from 8 positions (the float32
    rule's 16 picks mma.sync at W = 8)."""
    assert ck.conv_config(h, w, cout, torch.bfloat16) == config
    assert ck.conv_plan(1, h, w, 256, cout, torch.bfloat16).config == config
    if w == 8:
        assert ck.conv_config(h, w, cout) == ck.CONV_MMA


@pytest.mark.parametrize("fill", [0, 1, 2])
@pytest.mark.parametrize("shape", [(1, 4, 1, 256, 4), (1, 4, 3, 512, 256), (2, 8, 64, 128, 128),
                                   (1, 256, 192, 128, 128)])
def test_make_conv_plan_aims_at_fill_blocks_per_sm(shape, fill):
    """One K split for fill 0; otherwise at least fill x SMS blocks, from the
    tiles alone or by splitting K (the tile shrinks when K is too short)."""
    b, h, w, cin, cout = shape
    plan = ck.make_conv_plan(b, h, w, cin, cout, ck.conv_config(h, w, cout), fill)
    if fill == 0:
        assert plan.splits == 1 and plan.units_per_split == plan.units
    else:
        assert plan.ctas >= fill * ck.SMS, plan
    per = plan.units_per_split
    assert plan.splits * per >= plan.units > (plan.splits - 1) * per
    assert plan.smem_bytes <= ck.SMEM_LIMIT


@pytest.mark.parametrize("frames,shape", GN_CASES,
                         ids=[f"T{t}-{'x'.join(map(str, s))}" for t, s in GN_CASES])
def test_stats_plan_covers_once(frames, shape):
    """The parts cover the positions once; small maps take one block, large
    maps many more blocks than (batch x groups)."""
    _check_stats_plan(1, *shape)


@pytest.mark.parametrize("shape", GN_SHAPES_T64, ids=["x".join(map(str, s)) for s in GN_SHAPES_T64])
def test_stats_plan_covers_once_at_the_bench_batch(shape):
    """bench.py's batch of 16 at 64 frames: one row of parts per utterance."""
    _check_stats_plan(BENCH_BATCH, *shape)


def _check_stats_plan(b, h, w, c):
    parts, chunk = ck.stats_plan(b, h * w, c)
    assert parts * chunk >= h * w > (parts - 1) * chunk
    assert parts <= ck.STATS_MAX_PARTS
    if h * w * c <= ck.STATS_MIN_ELEMS:
        assert parts == 1
    if h * w * c >= 32 * 2 * ck.STATS_MIN_ELEMS:
        assert parts > 32


# --------------------------------------------------------------- emulations


def _tf32(t):
    """Nearest TF32 value (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32``: round, then clear the low 13 bits."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _chain_inputs(seed, b, h, w, cin, cout, with_skip):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    gs = torch.from_numpy((1 + 0.1 * rng.standard_normal(cin)).astype(np.float32))
    gb = torch.from_numpy((0.1 * rng.standard_normal(cin)).astype(np.float32))
    wk = torch.from_numpy((0.05 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32))
    bt = torch.from_numpy((0.1 * rng.standard_normal((b, cout))).astype(np.float32))
    skip = (torch.from_numpy(rng.standard_normal((b, h, w, cout)).astype(np.float32))
            if with_skip else None)
    return x, gs, gb, wk, bt, skip


def _activated(x, gs, gb, groups):
    a, b = ck.gn_stats_ab_reference(x, gs, gb, groups, 1e-6)
    v = x * a[:, None, None, :] + b[:, None, None, :]
    return v / (1 + torch.exp(-v))


def _emulate_conv(act, wk, bt, skip, coef, plan, products, bk=ck.CONV_BK):
    """What gn_silu_conv3x3_kernel and conv_split_reduce_kernel compute under
    ``plan``, block by block: each block's position tile reads its halo of the
    zero-padded activated map, walks its K units (live tap, ``bk``-channel
    chunk) and adds ``products(a, w)`` (float64); the K splits are added in
    split order, then bias, skip and scale."""
    b, h, w, cin = act.shape
    cout = wk.shape[-1]
    bn = ck.CONV_CONFIGS[plan.config][1]
    taps = ck.conv_taps(h, w)
    dy0, dx0, nx = (-1 if h > 1 else 0), (-1 if w > 1 else 0), (3 if w > 1 else 1)
    padded = torch.zeros((b, plan.tiles_h * plan.th + 2, plan.tiles_w * plan.tw + 2, cin))
    padded[:, 1:h + 1, 1:w + 1] = act
    wpad = torch.zeros((3, 3, cin, plan.n_tiles * bn))
    wpad[..., :cout] = wk
    partial = torch.zeros((plan.splits, b, plan.tiles_h * plan.th, plan.tiles_w * plan.tw,
                           plan.n_tiles * bn), dtype=torch.float64)
    for m in range(plan.grid[0]):
        bi, tile = divmod(m, plan.tiles_h * plan.tiles_w)
        oh0, ow0 = tile // plan.tiles_w * plan.th, tile % plan.tiles_w * plan.tw
        halo = padded[bi, oh0:oh0 + plan.th + 2, ow0:ow0 + plan.tw + 2]
        for z in range(plan.splits):
            acc = torch.zeros((plan.th * plan.tw, plan.n_tiles * bn), dtype=torch.float64)
            for u in range(z * plan.units_per_split,
                           min(plan.units, (z + 1) * plan.units_per_split)):
                c, l = divmod(u, taps)
                dy, dx = dy0 + l // nx, dx0 + l % nx
                a_rows = halo[1 + dy:1 + dy + plan.th, 1 + dx:1 + dx + plan.tw,
                              c * bk:(c + 1) * bk].reshape(-1, bk)
                acc += products(a_rows, wpad[dy + 1, dx + 1, c * bk:(c + 1) * bk])
            partial[z, bi, oh0:oh0 + plan.th, ow0:ow0 + plan.tw] = acc.reshape(
                plan.th, plan.tw, -1)
    out = partial[0]
    for z in range(1, plan.splits):
        out = out + partial[z]
    out = out[:, :h, :w, :cout] + bt.double()[:, None, None, :]
    if skip is not None:
        out = (skip.double() + out) * coef
    return out


def _tf32x3(a, w):
    (ah, al), (wh, wl) = _split(a), _split(w)
    d = torch.float64
    return al.to(d) @ wh.to(d) + ah.to(d) @ wl.to(d) + ah.to(d) @ wh.to(d)


def _tf32x1(a, w):
    return _tf32(a).double() @ _tf32(w).double()


def _exact(act, wk, bt, skip, coef):
    out = F.conv2d(act.double().permute(0, 3, 1, 2), wk.double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1) + bt.double()[:, None, None, :]
    return out if skip is None else (skip.double() + out) * coef


def test_tf32x3_split_keeps_float32_accuracy(capsys):
    """At [2,16,8,128]->128 the kernel's 3xTF32 arithmetic, under its plan,
    meets the kernel tolerance against float64; one TF32 pass does not come
    close (its error is printed beside the split's)."""
    x, gs, gb, wk, bt, skip = _chain_inputs(0, 2, 16, 8, 128, 128, True)
    act = _activated(x, gs, gb, 32)
    plan = ck.conv_plan(2, 16, 8, 128, 128)
    coef = 1 / np.sqrt(2.0)
    ref = _exact(act, wk, bt, skip, coef)
    three = _emulate_conv(act, wk, bt, skip, coef, plan, _tf32x3)
    one = _emulate_conv(act, wk, bt, skip, coef, plan, _tf32x1)
    err3 = (three - ref).abs().max().item()
    err1 = (one - ref).abs().max().item()
    with capsys.disabled():
        print(f"\n[2,16,8,128]->128 against float64: 3xTF32 max abs err {err3:.3e}, "
              f"one TF32 pass {err1:.3e} ({err1 / err3:.0f}x)")
    torch.testing.assert_close(three, ref, **KERNEL_TOL)
    assert err1 >= 10 * err3


@pytest.mark.parametrize("shape", [(1, 16, 12, 256, 256, False), (1, 4, 1, 256, 4, False),
                                   (1, 4, 3, 512, 256, True), (2, 8, 6, 128, 128, True),
                                   (2, 8, 64, 128, 128, True)])
def test_split_k_plans_sum_to_the_conv(shape):
    """The deep-level plans (K split across blocks, uneven and across chunk
    boundaries at [1,16,12,256]; dead taps at W=1; the wgmma tile at
    [2,8,64,128]) add up to the conv."""
    b, h, w, cin, cout, with_skip = shape
    plan = ck.conv_plan(b, h, w, cin, cout)
    assert plan.splits > 1
    x, gs, gb, wk, bt, skip = _chain_inputs(1, *shape)
    act = _activated(x, gs, gb, 32)
    out = _emulate_conv(act, wk, bt, skip, 0.5, plan, _tf32x3)
    torch.testing.assert_close(out, _exact(act, wk, bt, skip, 0.5), **KERNEL_TOL)


def _bf16(a, w):
    """The bf16 kernels' products: each operand rounded to bfloat16 (to
    nearest even), products exact, summed in float64 here."""
    return a.bfloat16().double() @ w.bfloat16().double()


def bf16_spacing(v):
    """The bfloat16 spacing (8 significant bits) at |v|."""
    return torch.exp2(torch.floor(torch.log2(v.double().abs().clamp_min(2.0 ** -126))) - 7)


def bf16_ulps(out, ref):
    """|out - ref| in units of ref's bfloat16 spacing, elementwise."""
    return (out.double() - ref.double()).abs() / bf16_spacing(ref)


# bf16 outputs that sum in float32 in another order: within one bfloat16 ulp
# of each other, except where the sum cancels to far below its terms (there
# the terms' float32 rounding is many ulps of the result): on at most this
# share of the elements, which stay within one ulp of the largest output.
BF16_SHARE = 1e-3


def assert_bf16_close(out, ref):
    ulps = bf16_ulps(out, ref)
    assert (ulps > 1).double().mean().item() <= BF16_SHARE, ulps.max()
    assert (out.double() - ref.double()).abs().max() <= bf16_spacing(ref.abs().max())


@pytest.mark.parametrize("shape", [(1, 16, 12, 256, 256, False), (1, 4, 1, 256, 4, False),
                                   (1, 4, 3, 512, 256, True), (2, 8, 6, 128, 128, True),
                                   (2, 8, 64, 128, 128, True), (16, 4, 1, 256, 256, True)])
def test_bf16_split_k_plans_sum_to_the_conv(shape):
    """The bf16 plans (16-channel K units, split across blocks where K is
    short; bench.py's batch at the deepest level last) add up to the plain
    version's conv: the float64 sum of the exact bf16 products, rounded to
    bfloat16, within one bfloat16 ulp of the plain version's float32 sum
    rounded once, but where the sum cancels (``assert_bf16_close``)."""
    b, h, w, cin, cout, with_skip = shape
    plan = ck.conv_plan(b, h, w, cin, cout, torch.bfloat16)
    x, gs, gb, wk, bt, skip = _chain_inputs(1, *shape)
    x = x.bfloat16()
    skip = None if skip is None else skip.bfloat16()
    # the plain version's activation, so that only the sums' order differs
    a, bb = ck.gn_stats_ab_reference(x, gs, gb, 32, 1e-6)
    v = x.float() * a[:, None, None, :] + bb[:, None, None, :]
    act = v * torch.sigmoid(v)
    out = _emulate_conv(act, wk, bt, skip, 0.5, plan, _bf16, bk=ck.CONV_BK_BF16).bfloat16()
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, 32, skip=skip, skip_coef=0.5)
    assert ref.dtype == torch.bfloat16
    assert_bf16_close(out, ref)


def test_split_k_plan_cuts_chunks_unevenly():
    """[1,16,12,256]->256: the split is not a multiple of the 9 taps, nor
    does it divide K, so blocks start and end inside a chunk."""
    plan = ck.conv_plan(1, 16, 12, 256, 256)
    assert plan.units % plan.units_per_split and plan.units_per_split % 9


@pytest.mark.parametrize("shape", [(2, 16, 8, 128), (1, 4, 3, 256), (1, 64, 48, 128),
                                   (3, 16, 4, 384), (1, 256, 64, 128)])
def test_stats_partials_fold_to_the_reference(shape):
    """The statistics pass's arithmetic under its plan: per-part float64
    sums of x and x^2 per group, folded in part order, then the affine as
    ``_gn_stats_ab`` computes it, equal to ``gn_stats_ab_reference`` (whose
    float32 E[x^2] - mu^2 is itself good to ~1e-7 of E[x^2] / var: unit
    normal x keeps that ratio near 1, as the network's activations do)."""
    b, h, w, c = shape
    groups = min(c // 4, 32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    parts, chunk = ck.stats_plan(b, h * w, c)
    xg = x.double().reshape(b, h * w, groups, c // groups)
    s = torch.zeros((b, groups), dtype=torch.float64)
    q = torch.zeros_like(s)
    for p in range(parts):
        run = xg[:, p * chunk:(p + 1) * chunk]
        s = s + run.sum(dim=(1, 3))
        q = q + (run * run).sum(dim=(1, 3))
    n = h * w * (c // groups)
    mean = s / n
    rstd = torch.rsqrt((q / n - mean * mean).float() + 1e-6)
    a = rstd.repeat_interleave(c // groups, dim=1) * scale
    bb = bias - mean.float().repeat_interleave(c // groups, dim=1) * a
    ref_a, ref_b = ck.gn_stats_ab_reference(x, scale, bias, groups, 1e-6)
    torch.testing.assert_close(a, ref_a, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(bb, ref_b, atol=1e-6, rtol=1e-6)


def test_stats_wrapper_takes_the_plain_version_on_cpu():
    x = torch.randn(2, 8, 4, 128)
    p = torch.ones(128)
    ck.reset_launch_counts()
    a, b = ck.gn_stats_ab(x, p, 0 * p, 32)
    ref_a, ref_b = ck.gn_stats_ab_reference(x, p, 0 * p, 32, 1e-6)
    assert torch.equal(a, ref_a) and torch.equal(b, ref_b)
    assert not any(ck.launch_counts.values())
