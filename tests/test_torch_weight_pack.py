"""The bf16 ``wgmma.ss`` conv's packed weights and its arithmetic, on the CPU.

``pack_conv_weight_bf16`` (diffse_tpu_torch/ops/cuda_kernels.py) rounds a
float32 HWIO weight to bf16 once and lays it out as the kernel's shared-memory
operand; ``ResnetBlockBigGANpp`` keeps one packed copy per fused conv in
bf16. These tests hold the packing to ``w.to(torch.bfloat16)`` bit for bit,
the block's copy to its weights, and emulate in torch what
``gn_silu_conv3x3_ws_kernel`` computes block by block under its plans (the
flat halo of pitch tw + 2, a tap as one shift of it, the packed operand read
at the kernel's byte offsets, the K split in whole chunks). The kernel itself
runs only on the card (tests/test_torch_kernels.py, ``-m gpu``)."""

import numpy as np
import pytest
import torch

from diffse_tpu_torch.models import layers
from diffse_tpu_torch.ops import cuda_kernels as ck
from test_torch_conv_plan import assert_bf16_close

torch.set_num_threads(2)

# (Cin, Cout) of the 65M NCSN++'s fused convs (trunk blocks and heads)
CONV_WIDTHS_65M = [(128, 128), (256, 128), (384, 128), (128, 256), (256, 256), (384, 256),
                   (512, 256), (128, 4), (256, 4)]


def _weight(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
                            .astype(np.float32))


@pytest.mark.parametrize("cin,cout", CONV_WIDTHS_65M)
def test_pack_then_unpack_is_the_bf16_cast(cin, cout):
    """Packing rounds each weight as ``w.to(torch.bfloat16)`` does (to nearest
    even), and the plain mapping back gives it bit for bit; the padded
    output channels are zero."""
    w = _weight(cin, cout)
    packed = ck.pack_conv_weight_bf16(w)
    assert packed.dtype == torch.bfloat16
    assert tuple(packed.shape) == ck.packed_weight_shape(cin, cout)
    back = ck.unpack_conv_weight_bf16(packed, cout)
    assert torch.equal(back.view(torch.int16), w.to(torch.bfloat16).view(torch.int16))
    full = ck.unpack_conv_weight_bf16(packed, packed.shape[0] * 128)
    assert not full[..., cout:].float().any()


def test_packed_layout_is_the_kernels_operand():
    """Element offsets as the kernel reads them: chunk tile (Cout tile nt,
    chunk c) at ``(nt * chunks + c) * PACK_TILE``, then tap l at 2048, the
    warpgroup's half of 64 channels at 1024, K 8-groups at 512 (the
    descriptor's LBO, 1 KB), 8-row groups at 64 (SBO, 128 B), rows at 8."""
    cin, cout = 64, 256
    w = _weight(cin, cout, seed=1)
    flat = ck.pack_conv_weight_bf16(w).reshape(-1)
    chunks = cin // 16
    rng = np.random.default_rng(2)
    for _ in range(500):
        nt, c, l, half, kg, rg, row, k = (int(rng.integers(n)) for n in
                                          (2, chunks, 9, 2, 2, 8, 8, 8))
        off = ((nt * chunks + c) * 9 + l) * 2048 + half * 1024 + kg * 512 + rg * 64 + row * 8 + k
        ref = w[l // 3, l % 3, c * 16 + kg * 8 + k, nt * 128 + half * 64 + rg * 8 + row]
        assert flat[off].item() == ref.to(torch.bfloat16).item()


def _emulate_ws(x, gs, gb, wk, bt, skip, coef, plan):
    """What gn_silu_conv3x3_ws_kernel (and conv_split_reduce_kernel) compute
    under ``plan``, block by block, with the plain version's activation: each
    block's activated flat halo (pitch tw + 2, zero outside the map and past
    the halo), per chunk and tap the packed operand times the halo shifted by
    ``(l // 3) * pitch + l % 3``, over the wgmma's 256 flat positions
    (float64 sums), of which the epilogue keeps ``r * pitch + c`` for the
    tile's r < th, c < tw."""
    b, h, w, cin = x.shape
    cout = wk.shape[-1]
    n_pos = ck.CONV_CONFIGS[ck.CONV_WGMMA_SS][0]
    a, bb = ck.gn_stats_ab_reference(x, gs, gb, 32 if cin >= 128 else cin // 4, 1e-6)
    v = x.float() * a[:, None, None, :] + bb[:, None, None, :]
    act = (v * torch.sigmoid(v)).bfloat16().double()
    packed = ck.pack_conv_weight_bf16(wk).double()
    pitch = plan.tw + 2
    halo = -(-(n_pos + 2 * pitch + 2) // 8) * 8
    per = plan.units_per_split // 9
    partial = torch.zeros((plan.splits, b, h, w, plan.n_tiles * 128), dtype=torch.float64)
    hp = torch.arange((plan.th + 2) * pitch)
    for m in range(plan.grid[0]):
        bi, tile = divmod(m, plan.tiles_h * plan.tiles_w)
        oh0, ow0 = tile // plan.tiles_w * plan.th, tile % plan.tiles_w * plan.tw
        ih, iw = oh0 - 1 + hp // pitch, ow0 - 1 + hp % pitch
        ok = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
        flat = torch.zeros((halo, cin), dtype=torch.float64)
        flat[hp[ok]] = act[bi, ih[ok], iw[ok]]
        r, c = torch.meshgrid(torch.arange(plan.th), torch.arange(plan.tw), indexing="ij")
        keep = (oh0 + r < h) & (ow0 + c < w)
        r, c = r[keep], c[keep]
        for nt in range(plan.n_tiles):
            for z in range(plan.splits):
                acc = torch.zeros((n_pos, 128), dtype=torch.float64)
                for ch in range(z * per, min(cin // 16, (z + 1) * per)):
                    # [tap][half][K 8-group][row 8-group][row][k] -> [tap][Cout 128][K 16]
                    a_op = packed[nt, ch].view(9, 2, 2, 8, 8, 8).permute(0, 1, 3, 4, 2, 5)
                    a_op = a_op.reshape(9, 128, 16)
                    for l in range(9):
                        shift = (l // 3) * pitch + l % 3
                        acc += flat[shift:shift + n_pos, ch * 16:(ch + 1) * 16] @ a_op[l].T
                partial[z, bi, oh0 + r, ow0 + c, nt * 128:(nt + 1) * 128] = acc[r * pitch + c]
    out = partial[0]
    for z in range(1, plan.splits):
        out = out + partial[z]
    out = out[..., :cout] + bt.double()[:, None, None, :]
    if skip is not None:
        out = (skip.double() + out) * coef
    return out


# Maps whose wgmma.ss tiles are ragged (rows or columns past the map), W = 8,
# 16 and 64 (two tiles a row), Cout of two tiles and of part of one.
WS_SHAPES = [(1, 30, 8, 32, 128), (2, 15, 16, 32, 256), (1, 9, 64, 32, 64), (1, 4, 20, 32, 136)]


@pytest.mark.parametrize("shape", WS_SHAPES, ids=["x".join(map(str, s)) for s in WS_SHAPES])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("fill", [0, 1])
def test_ws_plan_arithmetic_matches_the_plain_version(shape, with_skip, fill):
    """The wgmma.ss kernel's arithmetic under its plans (one K split, and K
    split in whole chunks to fill the card), emulated, within one bf16 ulp
    of the plain version but where the sum cancels (``assert_bf16_close``)."""
    b, h, w, cin, cout = shape
    plan = ck.make_conv_plan(b, h, w, cin, cout, ck.CONV_WGMMA_SS, fill, torch.bfloat16)
    assert (plan.splits > 1) == (fill == 1)
    assert plan.th * (plan.tw + 2) <= 256 and plan.units_per_split % 9 == 0
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(np.float32)).bfloat16()
    gs = torch.from_numpy((1 + 0.1 * rng.standard_normal(cin)).astype(np.float32))
    gb = torch.from_numpy((0.1 * rng.standard_normal(cin)).astype(np.float32))
    wk = _weight(cin, cout, seed=4)
    bt = torch.from_numpy((0.1 * rng.standard_normal((b, cout))).astype(np.float32))
    skip = (torch.from_numpy(rng.standard_normal((b, h, w, cout)).astype(np.float32)).bfloat16()
            if with_skip else None)
    groups = 32 if cin >= 128 else cin // 4
    out = _emulate_ws(x, gs, gb, wk, bt, skip, 0.5, plan).bfloat16()
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, groups, skip=skip,
                                              skip_coef=0.5)
    assert_bf16_close(out, ref)


def test_ws_plans_cover_the_tiles_of_the_main_path():
    """At bench.py's batch the large levels' tiles: 7 rows of 32 at W = 64 and
    32 (pitch 34: 238 of a wgmma's 256 positions), 13 rows of 16 at W = 16, 16
    rows of 8 at W = 8; one K split where the tiles fill the card."""
    for (h, w, cin, cout), tile in {(256, 64, 128, 128): (7, 32), (128, 32, 256, 128): (7, 32),
                                    (64, 16, 256, 256): (13, 16),
                                    (32, 8, 256, 256): (16, 8)}.items():
        plan = ck.conv_plan(16, h, w, cin, cout, torch.bfloat16)
        assert plan.config == ck.CONV_WGMMA_SS
        assert (plan.th, plan.tw) == tile
        assert plan.splits == 1 or h * w < 64 * 16


def _block(dtype, cin=32, cout=32):
    return layers.ResnetBlockBigGANpp(cin, cout, temb_dim=16, dtype=dtype,
                                      generator=torch.Generator().manual_seed(0))


def _forward(block, cin=32):
    x = torch.randn(2, cin, 8, 8).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return block(x, torch.randn(2, 16))


def test_block_packs_each_fused_conv_once_and_after_updates():
    """A bf16 block packs Conv_0's and Conv_1's weights at its first forward
    and not again; an in-place update or a ``load_state_dict`` (both bump the
    weight's version) packs again, to the new weights."""
    block = _block(torch.bfloat16)
    _forward(block)
    first = {name: block.packed_weight(name) for name in ("Conv_0", "Conv_1")}
    _forward(block)
    for name, packed in first.items():
        assert block.packed_weight(name) is packed
        w = layers.conv_hwio(getattr(block, name))
        assert torch.equal(ck.unpack_conv_weight_bf16(packed, w.shape[-1]), w.bfloat16())
    with torch.no_grad():
        block.Conv_0.weight.mul_(2.0)
    again = block.packed_weight("Conv_0")
    assert again is not first["Conv_0"]
    assert torch.equal(again.float(), 2.0 * first["Conv_0"].float())
    assert block.packed_weight("Conv_1") is first["Conv_1"]
    state = {k: v.clone() for k, v in block.state_dict().items()}
    state["Conv_1.weight"] += 1.0
    block.load_state_dict(state)
    reloaded = block.packed_weight("Conv_1")
    assert reloaded is not first["Conv_1"]
    assert torch.equal(ck.unpack_conv_weight_bf16(reloaded, 32),
                       layers.conv_hwio(block.Conv_1).bfloat16())


def test_packed_copy_stays_out_of_the_state_dict():
    """The packed copies are no parameter or buffer: the bf16 block's
    state_dict has the float32 block's keys and values, before and after a
    forward. The float32 block packs nothing."""
    b16, b32 = _block(torch.bfloat16), _block(torch.float32)
    before = b16.state_dict()
    assert set(before) == set(b32.state_dict())
    _forward(b16)
    _forward(b32)
    after = b16.state_dict()
    assert set(after) == set(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert len(b16._packed) == 2
    assert b32._packed == {} and b32.packed_weight("Conv_0") is None


def test_wrapper_checks_the_packed_weight():
    """A packed weight of the wrong shape or dtype is refused, on the CPU
    too (where the plain version reads ``w``)."""
    x = torch.randn(1, 8, 8, 32).bfloat16()
    p = torch.ones(32)
    w = _weight(32, 32)
    bt = torch.zeros(1, 32)
    packed = ck.pack_conv_weight_bf16(w)
    out = ck.groupnorm_silu_conv3x3(x, p, 0 * p, w, bt, 8, w_packed=packed)
    assert torch.equal(out, ck.groupnorm_silu_conv3x3_reference(x, p, 0 * p, w, bt, 8))
    with pytest.raises(ValueError, match="w_packed"):
        ck.groupnorm_silu_conv3x3(x, p, 0 * p, w, bt, 8, w_packed=packed.float())
    with pytest.raises(ValueError, match="w_packed"):
        ck.groupnorm_silu_conv3x3(x, p, 0 * p, w, bt, 8, w_packed=packed[:, :1])
