"""K1's float32-input / bf16-products mode (``groupnorm_silu_conv3x3(...,
compute_dtype=torch.bfloat16)`` on float32 x) and the bf16 trunk's
output_skip heads on DDPM-style blocks, which run it.

The mode's plain version (the activation and the weights rounded to bf16,
their products summed in float32, bias, skip and output float32) against
the JAX package's ``_gn_silu_conv3x3_reference`` and its Pallas K1 / K2 in
interpret mode, both with ``compute_dtype=jnp.bfloat16`` on the same float32
map: at a K1 shape ([2,16,8,128]->4) and a K2-regime shape ([2,4,2,128]->4),
with and without the residual, and on a frames shard (``ab=``: the whole
map's affine on the right half's columns extended by its neighbour's
column, cropped, against the JAX function of the whole map). Tolerance: within
``GAP_SHARE`` (a third) of the JAX package's own bf16-products-vs-float32
gap at that call, which is what tests/test_torch_bf16_configs.py holds the
whole forward through these heads to; the reading is printed (it is
float32 summation order but where two programs' statistics, float64 here
and float32 in JAX, move an activation across a bf16 rounding boundary).

Then the heads: in the bf16 trunk of ``ddpm-noconv-naive`` and of DDPM++
with ``progressive="output_skip"`` (tests/test_torch_backbones.py's TINY
size) a spy on the wrappers sees every output_skip head call the K1 wrapper
with float32 x and ``compute_dtype=bf16``, and no head's conv reach
``F.conv2d`` outside it; the mode's gradient (the recompute) against
``jax.vjp`` of the JAX reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffse_tpu.ops.pallas_kernels import (_gn_silu_conv3x3_reference,
                                           groupnorm_silu_conv3x3_pallas)
from diffse_tpu_torch.models.ncsnpp import NCSNpp
from diffse_tpu_torch.ops import cuda_kernels as ck
from test_torch_backbones import CONFIGS, DDPMPP, TINY
from test_torch_bf16 import GAP_SHARE

torch.set_num_threads(2)

GROUPS = 32
BF16_GRAD_TOL = 0.05  # tests/test_torch_train_ops.py's bf16 bound
# (x shape, Cout): K1's row-tiled regime, and K2's whole small map
SHAPES = [((2, 16, 8, 128), 4), ((2, 4, 2, 128), 4)]
HEAD_CONFIGS = {"ddpm-noconv-naive": CONFIGS["ddpm-noconv-naive"],
                "ddpmpp-output_skip": dict(DDPMPP, progressive="output_skip")}


def _draw(shape, cout, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return dict(x=(2 * rng.standard_normal(shape) + 0.5).astype(np.float32),
                gs=(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                gb=(0.1 * rng.standard_normal(c)).astype(np.float32),
                w=(rng.standard_normal((3, 3, c, cout)) / np.sqrt(9 * c)).astype(np.float32),
                bt=(0.1 * rng.standard_normal((shape[0], cout))).astype(np.float32),
                skip=rng.standard_normal((*shape[:3], cout)).astype(np.float32))


def _jax(d, skip, compute_dtype, pallas):
    args = [jnp.asarray(d[k]) for k in ("x", "gs", "gb", "w", "bt")]
    sk = jnp.asarray(d["skip"]) if skip else None
    if pallas:
        out = groupnorm_silu_conv3x3_pallas(*args, GROUPS, skip=sk, skip_coef=0.7071,
                                            compute_dtype=compute_dtype, interpret=True)
    else:
        out = _gn_silu_conv3x3_reference(*args, sk, 0.7071, GROUPS, 1e-6, compute_dtype)
    return np.asarray(out)


def _rel(out, ref):
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape,cout", SHAPES, ids=["k1", "k2"])
@pytest.mark.parametrize("skip", [False, True], ids=["noskip", "skip"])
@pytest.mark.parametrize("shard", [False, True], ids=["whole", "ab"])
def test_mode_plain_version_matches_jax(shape, cout, skip, shard, capsys):
    d = _draw(shape, cout, seed=sum(shape) + cout + 7 * skip + 3 * shard)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    kw = dict(skip=t["skip"] if skip else None, skip_coef=0.7071,
              compute_dtype=torch.bfloat16)
    args = (t["gs"], t["gb"], t["w"], t["bt"], GROUPS)
    if shard:  # the right half's columns, extended by a column but past the global edge
        lo, hi = shape[2] // 2, shape[2]
        ab = ck.gn_stats_ab_reference(t["x"], t["gs"], t["gb"], GROUPS, 1e-6)
        ext = slice(lo - 1, hi)
        if skip:
            kw["skip"] = t["skip"][:, :, ext].contiguous()
        out = ck.groupnorm_silu_conv3x3_reference(t["x"][:, :, ext].contiguous(), *args, ab=ab,
                                                  **kw)[:, :, 1:]
        cols = slice(lo, hi)
    else:
        out = ck.groupnorm_silu_conv3x3_reference(t["x"], *args, **kw)
        cols = slice(None)
    assert out.dtype == torch.float32
    out = out.numpy()
    ref = _jax(d, skip, jnp.bfloat16, pallas=False)[:, :, cols]
    pallas = _jax(d, skip, jnp.bfloat16, pallas=True)[:, :, cols]
    gap = _rel(_jax(d, skip, None, pallas=False)[:, :, cols], ref)
    errs = _rel(out, ref), _rel(out, pallas)
    with capsys.disabled():
        print(f"\n{list(shape)}->{cout} skip={skip} shard={shard}: port vs JAX reference "
              f"{errs[0]:.3e}, vs interpret Pallas {errs[1]:.3e} (of max|ref|; JAX's own "
              f"bf16-products-vs-float32 gap {gap:.3e}, limit {GAP_SHARE * gap:.3e})")
    assert gap > 0 and max(errs) <= GAP_SHARE * gap
    # the wrapper on the CPU is the plain version
    if not shard:
        assert torch.equal(ck.groupnorm_silu_conv3x3(t["x"], *args, **kw), torch.from_numpy(out))


def test_mode_gradient_matches_jax():
    """The differentiable op with ``compute_dtype`` (its backward the
    recompute of the plain version) against ``jax.vjp`` of the JAX
    reference on the same float32 map, within ``BF16_GRAD_TOL`` of each
    gradient's largest magnitude: the JAX reference cannot be differentiated
    with ``compute_dtype=bf16`` (its conv's transpose takes a bf16 and a
    float32 operand and raises), so it is taken with float32 products, as
    tests/test_torch_train_ops.py holds the bf16 op."""
    d = _draw((2, 4, 2, 128), 4, seed=3)
    t = {k: torch.from_numpy(v).requires_grad_(k != "skip") for k, v in d.items()}
    out = ck.groupnorm_silu_conv3x3_op(t["x"], t["gs"], t["gb"], t["w"], t["bt"], GROUPS,
                                       skip=t["skip"], skip_coef=0.7071,
                                       compute_dtype=torch.bfloat16)
    g = np.random.default_rng(4).standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))

    def jax_fn(x, gs, gb, w, bt):
        return _gn_silu_conv3x3_reference(x, gs, gb, w, bt, jnp.asarray(d["skip"]), 0.7071,
                                          GROUPS, 1e-6, None)

    _, vjp = jax.vjp(jax_fn, *[jnp.asarray(d[k]) for k in ("x", "gs", "gb", "w", "bt")])
    for name, ref in zip(("x", "gs", "gb", "w", "bt"), vjp(jnp.asarray(g))):
        ref = np.asarray(ref)
        got = t[name].grad.numpy()
        assert np.max(np.abs(got - ref)) <= BF16_GRAD_TOL * np.max(np.abs(ref)), name


def test_the_mode_raises_on_other_pairs():
    d = _draw((1, 4, 2, 16), 4, seed=5)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    args = (t["gs"], t["gb"], t["w"], t["bt"][:1], 4)
    for x, cd in ((t["x"].bfloat16(), torch.bfloat16), (t["x"], torch.float32),
                  (t["x"], torch.float16)):
        with pytest.raises(TypeError, match="compute_dtype"):
            ck.groupnorm_silu_conv3x3(x, *args, compute_dtype=cd)


def test_mode_plans_fit_and_skip_wgmma_ss():
    """The mode's plans at the heads' shapes (the 65.6M-wide levels of one
    utterance at 64 frames and bench.py's batch of 16) take the narrow
    ``mma.sync`` block, split K on the small maps, and fit in shared memory
    with their 64-byte staging of float32 x; a wide Cout takes ``wgmma``,
    never the bf16-x-only ``wgmma.ss``."""
    for b in (1, 16):
        for (h, w, c) in ((256, 64, 128), (128, 32, 128), (64, 16, 256), (32, 8, 256),
                          (16, 4, 256), (8, 2, 256), (4, 1, 256)):
            plan = ck.conv_plan(b, h, w, c, 4, torch.bfloat16, torch.float32)
            assert plan.config == ck.CONV_MMA_HEAD and plan.smem_bytes <= ck.SMEM_LIMIT
            assert plan.smem_bytes > ck.conv_plan(b, h, w, c, 4, torch.bfloat16).smem_bytes
    wide = ck.conv_plan(16, 256, 64, 128, 128, torch.bfloat16, torch.float32)
    assert wide.config == ck.CONV_WGMMA and wide.smem_bytes <= ck.SMEM_LIMIT
    assert ck.conv_plan(16, 256, 64, 128, 128, torch.bfloat16).config == ck.CONV_WGMMA_SS


@pytest.mark.parametrize("name", sorted(HEAD_CONFIGS))
def test_output_skip_heads_take_k1_with_bf16_products(monkeypatch, name):
    """Every output_skip head of the bf16 trunk on DDPM-style blocks (a
    float32 map) calls the K1 wrapper with float32 x and
    ``compute_dtype=bf16``, and no head's conv (3x3 to the 4 output
    channels) runs as ``F.conv2d`` outside it."""
    arch = {**TINY, **HEAD_CONFIGS[name]}
    model = NCSNpp(**arch, dtype="bf16", generator=torch.Generator().manual_seed(0)).eval()
    wrapper, conv2d, calls, head_convs = ck.groupnorm_silu_conv3x3, F.conv2d, [], []
    inside = [False]

    def conv_spy(x, gn_scale, gn_bias, w, *args):
        compute_dtype = args[7] if len(args) > 7 else None
        calls.append((x.dtype, x.shape[-1], w.shape[-1], compute_dtype))
        inside[0] = True
        try:
            return wrapper(x, gn_scale, gn_bias, w, *args)
        finally:
            inside[0] = False

    def conv2d_spy(x, weight, *args, **kwargs):
        if not inside[0] and tuple(weight.shape[::2]) == (4, 3):
            head_convs.append(tuple(weight.shape))
        return conv2d(x, weight, *args, **kwargs)

    monkeypatch.setattr(ck, "groupnorm_silu_conv3x3", conv_spy)
    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d_spy)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((1, 2, 16, 16))
                          + 1j * rng.standard_normal((1, 2, 16, 16))).astype(np.complex64))
    with torch.no_grad():
        out = model(x, torch.tensor([0.5]))
    assert torch.isfinite(torch.view_as_real(out)).all()
    heads = [c for c in calls if c[2] == 4]
    assert len(heads) == len(arch["ch_mult"])  # one head a level of the up path
    assert all(c == (torch.float32, c[1], 4, torch.bfloat16) for c in heads), heads
    assert not head_convs
    # the DDPM-style blocks' fused chains stay float32 with float32 products
    assert all(c[0] == torch.float32 and c[3] is None for c in calls if c[2] != 4)
