"""The port's GroupNorm -> SiLU (-> conv3x3) kernels against the JAX package.

On the CPU each wrapper of diffse_tpu_torch/ops/cuda_kernels.py takes its
plain PyTorch version; those are held to the Pallas kernels of
diffse_tpu/ops/pallas_kernels.py run in interpret mode, at the shapes of both
of K1's regimes (row-tiled, and the small-map kernel K2) and of K3, with the
JAX tests' float32 tolerance (atol = rtol = 2e-4); their bf16 versions in
tests/test_torch_bf16.py. The tests marked ``gpu`` launch the CUDA kernels,
float32 and bf16, and hold them to the plain versions on the card (bf16:
``assert_bf16_close``); they skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.ops.pallas_kernels import (
    groupnorm_silu_conv3x3_pallas,
    groupnorm_silu_pallas,
)
from diffse_tpu_torch.ops import cuda_kernels as ck
from test_torch_conv_plan import assert_bf16_close

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=2e-4)

# (B, H, W, Cin, Cout): K1's row-tiled regime (W % 8 == 0, H >= 8) with
# Cout 128, 256 and the 4-channel pyramid head, then K2's tiny maps.
K1_SHAPES = [(2, 16, 8, 128, 128), (2, 16, 8, 128, 256), (2, 16, 8, 128, 4)]
K2_SHAPES = [(1, 16, 4, 128, 128), (2, 8, 2, 128, 128), (3, 4, 1, 128, 128),
             (2, 4, 3, 128, 128)]


def _chain_inputs(rng, b, h, w, cin, cout, with_skip):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    gs = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    gb = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    wk = (0.05 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    bt = (0.1 * rng.standard_normal((b, cout))).astype(np.float32)
    skip = rng.standard_normal((b, h, w, cout)).astype(np.float32) if with_skip else None
    return x, gs, gb, wk, bt, skip


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape,with_skip", [
    (K1_SHAPES[0], False), (K1_SHAPES[0], True), (K1_SHAPES[1], False),
    (K1_SHAPES[2], False), (K2_SHAPES[0], False), (K2_SHAPES[1], False),
    (K2_SHAPES[2], False), (K2_SHAPES[2], True), (K2_SHAPES[3], True),
])
def test_gn_silu_conv3x3_plain_matches_pallas(shape, with_skip):
    x, gs, gb, wk, bt, skip = _chain_inputs(np.random.default_rng(0), *shape, with_skip)
    groups = min(shape[3] // 4, 32)
    coef = 1.0 / np.sqrt(2.0) if with_skip else 1.0
    ref = groupnorm_silu_conv3x3_pallas(
        jnp.asarray(x), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(wk),
        jnp.asarray(bt), num_groups=groups,
        skip=None if skip is None else jnp.asarray(skip), skip_coef=coef,
        interpret=True)
    ck.reset_launch_counts()
    tx, tgs, tgb, twk, tbt, tskip = _torch(x, gs, gb, wk, bt, skip)
    out = ck.groupnorm_silu_conv3x3(tx, tgs, tgb, twk, tbt, groups, skip=tskip,
                                    skip_coef=coef)
    assert out.shape == (shape[0], shape[1], shape[2], shape[4])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not any(ck.launch_counts.values())


@pytest.mark.parametrize("shape,apply_silu", [
    ((2, 8, 4, 384), True), ((2, 8, 4, 384), False), ((2, 16, 8, 128), True),
])
def test_groupnorm_silu_plain_matches_pallas(shape, apply_silu):
    """C=384 gives a group width of 12, not a power of two."""
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    groups = min(c // 4, 32)
    ref = groupnorm_silu_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                num_groups=groups, apply_silu=apply_silu, interpret=True)
    ck.reset_launch_counts()
    out = ck.groupnorm_silu(*_torch(x, scale, bias), groups, apply_silu=apply_silu)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert not any(ck.launch_counts.values())


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; a device with neither a
    kernel nor a plain version raises instead of falling back."""
    x = torch.empty((1, 4, 4, 16), device="meta")
    p = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.groupnorm_silu(x, p, p, 4)
    with pytest.raises(ValueError, match="no kernel"):
        ck.groupnorm_silu_conv3x3(x, p, p, torch.empty((3, 3, 16, 16), device="meta"),
                                  torch.empty((1, 16), device="meta"), 4)


def test_kernel_input_checks_name_each_dtype():
    """The wrappers' checks say which dtype each argument takes: the
    activations (and the skip) float32 or bfloat16, parameters, weights and
    biases float32."""
    cpu = torch.device("cpu")
    x16, p32 = torch.zeros(2, 8, dtype=torch.bfloat16), torch.zeros(8)
    ck._require_kernel_inputs("k", cpu, {"x": torch.bfloat16}, x=x16, scale=p32)
    with pytest.raises(TypeError, match="takes float32 there"):
        ck._require_kernel_inputs("k", cpu, {"x": torch.bfloat16}, x=x16, scale=p32.bfloat16())
    with pytest.raises(TypeError, match="takes bfloat16 there"):
        ck._require_kernel_inputs("k", cpu, {"x": torch.bfloat16, "skip": torch.bfloat16},
                                  x=x16, skip=p32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ck._activation_dtype("k", x16.half())


def test_library_path_is_keyed_on_sources():
    path = ck.library_path()
    assert path.parent == ck.BUILD_DIR
    assert path.name.startswith("libdiffse_kernels_") and path.suffix == ".so"
    assert ck.library_path() == path


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The main path's conv shapes: the large levels (wgmma; K in ranges of at
# most CONV_F32_MAX_UNITS), the deep ones (K split across blocks), the
# latency-bound middle levels, [1,16,12,256]->256 whose split does not divide
# K, a W=1 head (dead taps, Cout=4), and the wgmma kernel on partial tiles
# (H, W not multiples of the tile), a batch of two and an uneven split; and
# [8,64,64,64]->128, whose 72 units and 256 tiles keep all of K in one block
# (the kernel's own epilogue).
GPU_CONV_SHAPES = [(1, 256, 64, 128, 128), (1, 256, 192, 128, 128), (1, 128, 32, 384, 128),
                   (1, 256, 64, 128, 4),
                   (1, 16, 4, 256, 256), (1, 8, 2, 256, 256), (1, 4, 1, 256, 256),
                   (1, 16, 12, 512, 256), (1, 8, 6, 256, 256), (1, 4, 3, 256, 256),
                   (1, 32, 16, 256, 256), (1, 32, 24, 256, 256), (1, 64, 32, 256, 256),
                   (1, 16, 12, 256, 256), (1, 4, 1, 256, 4), (1, 5, 96, 128, 128),
                   (2, 8, 64, 128, 128), (1, 5, 40, 64, 128), (8, 64, 64, 64, 128)]


def test_gpu_conv_shapes_include_an_uneven_split():
    plans = [ck.conv_plan(b, h, w, cin, cout) for b, h, w, cin, cout in GPU_CONV_SHAPES]
    assert any(p.splits > 1 and p.units % p.units_per_split for p in plans)
    assert any(p.splits == 1 for p in plans)
    instructions = {ck.CONV_CONFIGS[p.config][3:5] for p in plans}
    assert {("wgmma", 32), ("mma.sync", 0)} <= instructions


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_CONV_SHAPES)
@pytest.mark.parametrize("with_skip", [False, True])
def test_gn_silu_conv3x3_kernel_matches_plain(cuda, shape, with_skip):
    arrays = _chain_inputs(np.random.default_rng(2), *shape, with_skip)
    x, gs, gb, wk, bt, skip = [None if a is None else a.to(cuda) for a in _torch(*arrays)]
    groups = min(shape[3] // 4, 32)
    coef = 1.0 / np.sqrt(2.0)
    ck.reset_launch_counts()
    out = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, groups, skip=skip, skip_coef=coef)
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, groups, skip=skip,
                                              skip_coef=coef)
    torch.cuda.synchronize()
    assert ck.launch_counts["gn_silu_conv3x3"] == 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256, 64, 128), (1, 128, 32, 256), (2, 16, 4, 384)])
@pytest.mark.parametrize("apply_silu", [False, True])
def test_groupnorm_silu_kernel_matches_plain(cuda, shape, apply_silu):
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 1).astype(np.float32)).to(cuda)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    groups = min(c // 4, 32)
    ck.reset_launch_counts()
    out = ck.groupnorm_silu(x, scale, bias, groups, apply_silu=apply_silu)
    ref = ck.groupnorm_silu_reference(x, scale, bias, groups, apply_silu=apply_silu)
    torch.cuda.synchronize()
    assert ck.launch_counts["groupnorm_silu"] == 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256, 192, 128), (1, 4, 3, 256), (3, 16, 4, 384),
                                   (2, 128, 64, 256)])
def test_gn_stats_kernel_matches_plain_and_repeats(cuda, shape):
    """The statistics pass alone, against its plain version, and the same
    bits on every run (its partial sums are folded in a fixed order)."""
    rng = np.random.default_rng(5)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    groups = min(c // 4, 32)
    a, b = ck.gn_stats_ab(x, scale, bias, groups)
    ref_a, ref_b = ck.gn_stats_ab_reference(x, scale, bias, groups, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, ref_a, **TOL)
    torch.testing.assert_close(b, ref_b, **TOL)
    for _ in range(3):
        a2, b2 = ck.gn_stats_ab(x, scale, bias, groups)
        assert torch.equal(a, a2) and torch.equal(b, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 16, 12, 512, 256), (1, 256, 64, 128, 128)])
def test_gn_silu_conv3x3_kernel_repeats_bitwise(cuda, shape):
    """Split-K partial sums are added in split order, not by atomics: every
    run gives the same bits."""
    arrays = _chain_inputs(np.random.default_rng(6), *shape, True)
    x, gs, gb, wk, bt, skip = [a.to(cuda) for a in _torch(*arrays)]
    first = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, skip=skip, skip_coef=0.5)
    for _ in range(3):
        again = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, skip=skip, skip_coef=0.5)
        assert torch.equal(first, again)


# bf16: the same shapes plus bench.py's batch of 16 at 64 frames (the large
# level, middle ones, the deep levels and a head) and W = 8 on wgmma.
GPU_BF16_CONV_SHAPES = GPU_CONV_SHAPES + [
    (16, 256, 64, 128, 128), (16, 64, 16, 256, 256), (16, 32, 8, 512, 256), (16, 16, 4, 256, 256),
    (16, 4, 1, 512, 256), (16, 256, 64, 128, 4), (16, 8, 2, 256, 4), (1, 32, 8, 256, 256)]


def _bf16_chain_inputs(cuda, shape, with_skip, seed):
    arrays = _chain_inputs(np.random.default_rng(seed), *shape, with_skip)
    x, gs, gb, wk, bt, skip = [None if a is None else a.to(cuda) for a in _torch(*arrays)]
    return x.bfloat16(), gs, gb, wk, bt, None if skip is None else skip.bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_BF16_CONV_SHAPES)
@pytest.mark.parametrize("with_skip", [False, True])
def test_gn_silu_conv3x3_bf16_kernel_matches_plain(cuda, shape, with_skip):
    x, gs, gb, wk, bt, skip = _bf16_chain_inputs(cuda, shape, with_skip, 7)
    groups = min(shape[3] // 4, 32)
    coef = 1.0 / np.sqrt(2.0)
    ck.reset_launch_counts()
    out = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, groups, skip=skip, skip_coef=coef)
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, groups, skip=skip,
                                              skip_coef=coef)
    torch.cuda.synchronize()
    assert ck.launch_counts["gn_silu_conv3x3"] == 1
    assert out.dtype == ref.dtype == torch.bfloat16
    assert_bf16_close(out.cpu(), ref.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256, 64, 128), (1, 128, 32, 256), (2, 16, 4, 384),
                                   (16, 256, 64, 128), (16, 16, 4, 256)])
@pytest.mark.parametrize("apply_silu,out_dtype", [(False, torch.bfloat16), (True, torch.bfloat16),
                                                  (False, torch.float32)])
def test_groupnorm_silu_bf16_kernel_matches_plain(cuda, shape, apply_silu, out_dtype):
    """K3 on a bf16 map, out bf16 (the resampling blocks) or float32 (the
    attention's norm)."""
    rng = np.random.default_rng(8)
    c = shape[-1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 1).astype(np.float32)).to(cuda)
    x = x.bfloat16()
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    groups = min(c // 4, 32)
    ck.reset_launch_counts()
    out = ck.groupnorm_silu(x, scale, bias, groups, apply_silu=apply_silu, out_dtype=out_dtype)
    ref = ck.groupnorm_silu_reference(x, scale, bias, groups, apply_silu=apply_silu,
                                      out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ck.launch_counts["groupnorm_silu"] == 1
    assert out.dtype == ref.dtype == out_dtype
    if out_dtype == torch.bfloat16:
        assert_bf16_close(out.cpu(), ref.cpu())
    else:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256, 192, 128), (1, 4, 3, 256), (16, 256, 64, 128)])
def test_gn_stats_bf16_kernel_matches_plain_and_repeats(cuda, shape):
    rng = np.random.default_rng(9)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda).bfloat16()
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    groups = min(c // 4, 32)
    a, b = ck.gn_stats_ab(x, scale, bias, groups)
    ref_a, ref_b = ck.gn_stats_ab_reference(x, scale, bias, groups, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(a, ref_a, **TOL)
    torch.testing.assert_close(b, ref_b, **TOL)
    a2, b2 = ck.gn_stats_ab(x, scale, bias, groups)
    assert torch.equal(a, a2) and torch.equal(b, b2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 16, 12, 512, 256), (16, 256, 64, 128, 128)])
def test_gn_silu_conv3x3_bf16_kernel_repeats_bitwise(cuda, shape):
    x, gs, gb, wk, bt, skip = _bf16_chain_inputs(cuda, shape, True, 10)
    first = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, skip=skip, skip_coef=0.5)
    again = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, 32, skip=skip, skip_coef=0.5)
    assert torch.equal(first, again)


# the wgmma.ss kernel on ragged tiles, W = 8, 16 and 64, Cout of two tiles and
# of part of one (tests/test_torch_weight_pack.py emulates the same plans)
GPU_WS_SHAPES = [(1, 30, 8, 32, 128), (2, 15, 16, 32, 256), (1, 9, 64, 32, 64),
                 (1, 4, 20, 32, 136), (2, 19, 64, 128, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_WS_SHAPES)
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("fill", [0, 1])
def test_gn_silu_conv3x3_ws_kernel_matches_plain(cuda, monkeypatch, shape, with_skip, fill):
    """The packed-weight bf16 kernel under its plans with one K split and K
    split to fill the card, given the packed weight and packing it itself
    (counted in ``weight_casts``): the same bits either way."""
    b, h, w, cin, cout = shape
    plan = ck.make_conv_plan(b, h, w, cin, cout, ck.CONV_WGMMA_SS, fill, torch.bfloat16)
    monkeypatch.setattr(ck, "conv_plan", lambda *args: plan)
    x, gs, gb, wk, bt, skip = _bf16_chain_inputs(cuda, shape, with_skip, 11)
    groups = min(cin // 4, 32)
    ck.reset_launch_counts()
    packed = ck.pack_conv_weight_bf16(wk)
    out = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, groups, skip=skip, skip_coef=0.5,
                                    w_packed=packed)
    again = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt, groups, skip=skip, skip_coef=0.5)
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bt, groups, skip=skip,
                                              skip_coef=0.5)
    torch.cuda.synchronize()
    assert ck.conv_config_launches[ck.CONV_WGMMA_SS] == 2
    assert ck.weight_casts["gn_silu_conv3x3"] == 2
    assert torch.equal(out, again)
    assert_bf16_close(out.cpu(), ref.cpu())


@pytest.mark.gpu
def test_kernel_refuses_grad_and_bad_inputs(cuda):
    x = torch.randn(1, 8, 8, 128, device=cuda, requires_grad=True)
    p = torch.ones(128, device=cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        ck.groupnorm_silu(x, p, p, 32)
    with pytest.raises(TypeError, match="float32"):
        ck.groupnorm_silu(x.detach().double(), p, p, 32)
    with pytest.raises(TypeError, match="float32"):
        ck.groupnorm_silu(x.detach().bfloat16(), p.bfloat16(), p, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ck.groupnorm_silu(x.detach().transpose(1, 2), p, p, 32)


@pytest.mark.gpu
def test_gn_silu_conv3x3_kernel_takes_expanded_bias(cuda):
    """A [Cout] bias expanded over the batch (row stride 0) is read in place."""
    arrays = _chain_inputs(np.random.default_rng(4), 3, 8, 6, 128, 128, True)
    x, gs, gb, wk, bt, skip = [a.to(cuda) for a in _torch(*arrays)]
    bias = bt[0][None, :].expand(3, 128)
    out = ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bias, 32, skip=skip, skip_coef=0.5)
    ref = ck.groupnorm_silu_conv3x3_reference(x, gs, gb, wk, bias.contiguous(), 32,
                                              skip=skip, skip_coef=0.5)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)
    with pytest.raises(ValueError, match="bias_total"):
        ck.groupnorm_silu_conv3x3(x, gs, gb, wk, bt.t().contiguous().t(), 32)


@pytest.mark.gpu
def test_enhance_on_card_is_float32_under_tf32_defaults(cuda):
    """``ScoreModel.enhance`` (``sebridge_v2``) on the card, with TF32 allowed
    process-wide, matches the same call on the CPU to float32 accuracy, and
    leaves the process-wide setting as it was."""
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.utils import randn_like

    arch = dict(nf=16, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(16,))
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v2",
                           snr_conditioned="false", sigma_max=1.0)
    sde_kwargs = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
    cpu, card = [ScoreModel(cfg, backbone_kwargs=arch, sde_kwargs=sde_kwargs, device=d)
                 for d in ("cpu", cuda)]
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in cpu.backbone.parameters():
            if p.requires_grad:
                z = torch.randn(p.shape, generator=g)
                p.copy_(z / p[0].numel() ** 0.5 if p.ndim >= 2 else 0.1 * z)
    card.backbone.load_state_dict(cpu.backbone.state_dict())
    y = (0.1 * np.random.default_rng(6).standard_normal((1, 63 * 128))).astype(np.float32)

    def noise():
        gen = torch.Generator().manual_seed(7)
        return lambda like: randn_like(like.cpu(), gen).to(like.device)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ref = cpu.enhance(y, y, noise=noise())
    out = card.enhance(y, y, noise=noise())
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert out.shape == ref.shape == (y.shape[-1],)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.gpu
def test_snrnet_on_card_is_float32_under_tf32_defaults(cuda):
    """SNRNet on the card, TF32 allowed process-wide, matches the CPU to
    float32 accuracy (1e-5) and leaves the process-wide setting as it was."""
    import copy

    from diffse_tpu_torch.models.snrnet import SNRNet

    torch.manual_seed(0)
    cpu = SNRNet().eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 2, 256, 64))
                         .astype(np.float32))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.no_grad():
        ref = cpu(x)
        out = card(x.to(cuda)).cpu()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
