"""The port's bf16 trunk (``NCSNpp(dtype="bf16")``) against the JAX package's.

The JAX side runs ``dtype="bf16"`` with ``use_pallas_groupnorm=True,
fuse_pyramid=True``, the path whose rounding points the port follows (its
Pallas GroupNorm+SiLU kernel in interpret mode, its fused chain's reference
with ``compute_dtype=bf16``). Inputs are made with numpy from a seed; the
weights go through ``convert.state_dict_from_jax``.

Two bf16 programs that round in different places differ by about as much as
bf16 differs from float32, so the forward and waveform tests hold the port
to a share of the JAX package's own bf16-vs-float32 gap on the same input
(``GAP_SHARE``), and print both. The kernels' plain versions are held to
the JAX references within one bfloat16 ulp but on a small share of the
elements (``assert_bf16_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.ops.pallas_kernels import _gn_silu_conv3x3_reference, groupnorm_silu_pallas
from diffse_tpu.sampling import get_pc_sampler as jax_get_pc_sampler
from diffse_tpu.transforms import pad_spec as jax_pad_spec
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.models.ncsnpp import NCSNpp
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.sampling import get_pc_sampler
from diffse_tpu_torch.transforms import pad_spec, spec_fwd
from test_torch_conv_plan import assert_bf16_close
from test_torch_enhance import noise_from, replay_pc_draws
from test_torch_ncsnpp import _inputs, random_jax_params

torch.set_num_threads(2)

JAX_FLAGS = dict(use_pallas_groupnorm=True, fuse_pyramid=True)
# tests/test_backbones.py::test_ncsnpp_bf16_trunk_matches_f32's configuration
TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
# The port's bf16 output may be at most this share of the JAX package's own
# bf16-vs-float32 gap away from the JAX bf16 output, at the JAX package's
# initialisation (the blocks' last convs and the pyramid heads start near
# zero, so a rounding that differs does not grow through the depth).
GAP_SHARE = 1 / 3
# At the 65M depth the float32 statistics and sums, taken in another order
# than XLA's, flip some bf16 roundings, and each grows through the depth
# like any bf16 rounding: the port stays below the JAX package's own
# bf16-vs-float32 gap, not a third of it.
GAP_SHARE_65M = 1.0


def _rel(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def _bf16_np(a):
    """numpy float32 values rounded to bfloat16 (nearest even), as float32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _tiny_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 2, 16, 16))
         + 1j * rng.standard_normal((2, 2, 16, 16))).astype(np.complex64)
    return x, np.asarray([0.5, 0.9], np.float32)


def _jax_forwards(arch, params, x, t):
    """(JAX bf16 output, JAX float32 output), both with the pallas flags, op
    by op as tests/test_backbones.py runs them: under ``jax.jit`` XLA may
    fuse a chain of bf16 operations and round once at its end, where the op
    by op program (and the port) rounds after each."""
    apply16 = JaxNCSNpp(**arch, **JAX_FLAGS, dtype="bf16").apply
    apply32 = JaxNCSNpp(**arch, **JAX_FLAGS).apply
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    return (np.asarray(apply16({"params": params}, xj, tj)),
            np.asarray(apply32({"params": params}, xj, tj)))


def _port_forward(arch, params, x, t, dtype="bf16"):
    model = NCSNpp(**arch, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params, **arch), strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(t)).numpy()


# ------------------------------------------------------------------- kernels


def _chain_inputs(seed, b, h, w, cin, cout, with_skip):
    rng = np.random.default_rng(seed)
    x = _bf16_np(rng.standard_normal((b, h, w, cin)).astype(np.float32))
    gs = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    gb = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bt = (0.1 * rng.standard_normal((b, cout))).astype(np.float32)
    skip = _bf16_np(rng.standard_normal((b, h, w, cout)).astype(np.float32)) if with_skip else None
    return x, gs, gb, wk, bt, skip


@pytest.mark.parametrize("shape", [(2, 16, 8, 128, 128), (2, 16, 8, 128, 4), (2, 8, 2, 256, 256),
                                   (1, 4, 3, 128, 128), (2, 4, 1, 256, 4)])
@pytest.mark.parametrize("with_skip", [False, True])
def test_gn_silu_conv3x3_bf16_plain_matches_jax(shape, with_skip):
    """K1/K2 in bf16: the plain version against ``_gn_silu_conv3x3_reference``
    with ``compute_dtype=bf16`` (activation and weights rounded to bf16,
    float32 sums, one rounding at the end), Cout 128 and 4, with and without
    skip. Within one bf16 ulp but on a share of at most 1e-3 of the elements
    (``assert_bf16_close``): the float32 statistics differ in their last bits,
    which may flip the bf16 rounding of a few activated elements."""
    x, gs, gb, wk, bt, skip = _chain_inputs(0, *shape, with_skip)
    groups = min(shape[3] // 4, 32)
    coef = 1.0 / np.sqrt(2.0) if with_skip else 1.0
    ref = _gn_silu_conv3x3_reference(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(wk),
        jnp.asarray(bt), None if skip is None else jnp.asarray(skip).astype(jnp.bfloat16),
        coef, groups, 1e-6, jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    ck.reset_launch_counts()
    out = ck.groupnorm_silu_conv3x3(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(gs), torch.from_numpy(gb),
        torch.from_numpy(wk), torch.from_numpy(bt), groups,
        skip=None if skip is None else torch.from_numpy(skip).bfloat16(), skip_coef=coef)
    assert out.dtype == torch.bfloat16
    assert out.shape == (shape[0], shape[1], shape[2], shape[4])
    assert_bf16_close(out, torch.from_numpy(np.asarray(ref.astype(jnp.float32))))
    assert not any(ck.launch_counts.values())


@pytest.mark.parametrize("shape,apply_silu", [((2, 8, 4, 384), True), ((2, 8, 4, 384), False),
                                              ((2, 16, 8, 128), True)])
def test_groupnorm_silu_bf16_plain_matches_pallas(shape, apply_silu):
    """K3 on a bf16 map, bf16 out: the plain version against
    ``groupnorm_silu_pallas`` in interpret mode (``assert_bf16_close``)."""
    rng = np.random.default_rng(1)
    c = shape[-1]
    x = _bf16_np((rng.standard_normal(shape) * 2 + 1).astype(np.float32))
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    groups = min(c // 4, 32)
    ref = groupnorm_silu_pallas(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale),
                                jnp.asarray(bias), num_groups=groups, apply_silu=apply_silu,
                                interpret=True)
    assert ref.dtype == jnp.bfloat16
    out = ck.groupnorm_silu(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups, apply_silu=apply_silu)
    assert out.dtype == torch.bfloat16
    assert_bf16_close(out, torch.from_numpy(np.asarray(ref.astype(jnp.float32))))


def test_groupnorm_bf16_in_float32_out_matches_flax():
    """The attention's norm: flax's ``GroupNorm`` (dtype None) on a bf16 map
    gives float32; so does ``groupnorm_silu(..., out_dtype=float32)``
    (float32 tolerance: the same maths in another order)."""
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = _bf16_np((rng.standard_normal((2, 8, 4, 256)) * 2 + 1).astype(np.float32))
    scale = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-6)
    ref = gn.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                   jnp.asarray(x).astype(jnp.bfloat16))
    assert ref.dtype == jnp.float32
    out = ck.groupnorm_silu(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                            torch.from_numpy(bias), 32, apply_silu=False,
                            out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------------- forward


def test_tiny_bf16_forward_matches_jax(capsys):
    """The tiny NCSN++ of tests/test_backbones.py in bf16 (B = 2, t = [0.5,
    0.9], the JAX package's initialisation through ``convert.py``): the port
    within a third of the JAX package's own bf16-vs-float32 gap of the JAX
    bf16 output."""
    x, t = _tiny_inputs()
    params = JaxNCSNpp(**TINY).init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))["params"]
    ref16, ref32 = _jax_forwards(TINY, params, x, t)
    out = _port_forward(TINY, params, x, t)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    with capsys.disabled():
        print(f"\ntiny bf16 NCSN++: JAX bf16 vs JAX float32 {gap:.3e}; port bf16 vs JAX bf16 "
              f"{err:.3e} (limit {GAP_SHARE * gap:.3e})")
    assert out.shape == ref16.shape == (2, 1, 16, 16) and out.dtype == np.complex64
    assert err <= GAP_SHARE * gap
    np.testing.assert_allclose(_port_forward(TINY, params, x, t, None), ref32, atol=1e-5, rtol=0)


def test_tiny_bf16_forward_with_redrawn_weights_stays_within_bf16_noise(capsys):
    """With every weight redrawn at 1/sqrt(fan_in) the blocks' residual
    branches carry full-size signals, and a bf16 rounding that goes the other
    way (the float32 statistics differ in their last bits) grows through the
    depth like any other bf16 rounding: the port's distance from the JAX
    bf16 output is then of the order of bf16's own distance from float32
    (held to twice it; a fault gives a gap of order one)."""
    x, t = _tiny_inputs()
    params = random_jax_params(TINY, seed=3, frames=16)
    ref16, ref32 = _jax_forwards(TINY, params, x, t)
    out = _port_forward(TINY, params, x, t)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    with capsys.disabled():
        print(f"\ntiny bf16 NCSN++, redrawn weights: JAX bf16 vs JAX float32 {gap:.3e}; port "
              f"bf16 vs JAX bf16 {err:.3e}")
    assert err <= 2 * gap


def test_bf16_trunk_blocks_output_bf16():
    """Every residual block of the bf16 trunk returns bf16 (as
    tests/test_backbones.py spies the JAX package's); the parameters and the
    state_dict stay float32 and the output is complex64."""
    model = NCSNpp(**TINY, dtype="bf16")
    seen = []
    for m in model.modules():
        if isinstance(m, layers.ResnetBlockBigGANpp):
            m.register_forward_hook(lambda mod, args, out: seen.append(out.dtype))
    x, t = _tiny_inputs()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t))
    assert seen and all(d == torch.bfloat16 for d in seen), seen
    assert out.dtype == torch.complex64
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    assert set(model.state_dict()) == set(NCSNpp(**TINY).state_dict())


def test_trunk_dtype_names():
    assert NCSNpp(**TINY, dtype="bfloat16").compute_dtype == torch.bfloat16
    assert NCSNpp(**TINY, dtype="float32").compute_dtype == torch.float32
    assert NCSNpp(**TINY).compute_dtype == torch.float32
    with pytest.raises(ValueError, match="compute dtype"):
        NCSNpp(**TINY, dtype="fp8")
    with pytest.raises(ValueError, match="fuse_pyramid"):
        NCSNpp(**TINY, fuse_pyramid=False)


@pytest.mark.slow
def test_65m_bf16_forward_matches_jax(capsys):
    """The full 65M configuration at F=256, T=64, with the JAX package's
    initialisation: the port within the JAX package's own bf16-vs-float32
    gap (``GAP_SHARE_65M``)."""
    x, t = _inputs(5, 1, 64)
    params = JaxNCSNpp().init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))["params"]
    ref16, ref32 = _jax_forwards({}, params, x, t)
    out = _port_forward({}, params, x, t)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    with capsys.disabled():
        print(f"\n65M bf16 NCSN++: JAX bf16 vs JAX float32 {gap:.3e}; port bf16 vs JAX bf16 "
              f"{err:.3e} (limit {GAP_SHARE_65M * gap:.3e})")
    assert err <= GAP_SHARE_65M * gap


# ------------------------------------------------------ bench.py's program

# three levels (bench.py's NCSN++ has seven): every kind of block, attention
# at the deepest, for a JAX bf16 program that runs op by op
SAMPLER_ARCH = dict(nf=4, ch_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(64,),
                    image_size=256)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
HOP = 128
FRAMES = 64
BATCH = 2
N_STEPS = 2


def _jax_program(model, variables, y_wav, key):
    """bench.py's ``enhance_batch`` (bench.py:147-160), with N steps."""
    norm = jnp.max(jnp.abs(y_wav), axis=-1, keepdims=True)
    Y = jax_pad_spec(model._forward_transform(model._stft(y_wav / norm))[:, None])
    sampler = jax_get_pc_sampler(
        "reverse_diffusion", "ald", sde=model.sde,
        score_fn=lambda x_, t_, y_: model.forward(variables, x_, t_, y_)[0], Y=Y,
        denoise=True, eps=model.cfg.t_eps, snr=0.5, corrector_steps=1)
    sample, _ = sampler(key)
    return model.to_audio(sample[:, 0]) * norm


def _port_program(model, y_wav, noise):
    """The same program from the port's modules."""
    norm = torch.max(torch.abs(y_wav), dim=-1, keepdim=True).values
    Y = pad_spec(spec_fwd(model._stft(y_wav / norm), model.spec_cfg)[:, None])
    sampler = get_pc_sampler("reverse_diffusion", "ald", sde=model.sde, score_fn=model.forward,
                             Y=Y, noise=noise, eps=model.cfg.t_eps, snr=0.5, corrector_steps=1)
    sample, _ = sampler()
    return model.to_audio(sample[:, 0]) * norm


def _heads_redrawn(params, seed):
    """The JAX package's initialisation with the output pyramid's heads and
    the output layer redrawn (kernels at 1/sqrt(fan_in), biases small): their
    initialisation at zero would hide the network from the waveform."""
    rng = np.random.default_rng(seed)
    params = dict(params)
    for name in params:
        if (name.startswith("Conv_") and name != "Conv_0") or name == "output_layer":
            shape = params[name]["kernel"].shape
            params[name] = {
                "kernel": jnp.asarray((rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))
                                      .astype(np.float32)),
                "bias": jnp.asarray((0.1 * rng.standard_normal(shape[-1])).astype(np.float32))}
    return params


def test_bbed_pc_batch_bf16_matches_jax(capsys):
    """bench.py's batch program (normalise each row, STFT, ``spec_fwd``,
    ``pad_spec``, reverse_diffusion + ald, ``to_audio``, times the norm) at
    batch 2 and N = 2 steps, bf16 trunk, the JAX package's noise draws fed to
    the port: the port's waveform within a third of the JAX package's own
    bf16-vs-float32 waveform gap of the JAX bf16 waveform. The JAX bf16
    program runs op by op (``jax.disable_jit``: jitted, XLA would fuse bf16
    operations in the scan's body and skip their roundings)."""
    cfg = dict(backbone="ncsnpp", sde="bbed", model_type="bbed", snr_conditioned="false",
               sigma_max=0.5)
    shape = (BATCH, 1, 256, FRAMES)
    key = jax.random.PRNGKey(21)
    y = (0.1 * np.random.default_rng(22).standard_normal((BATCH, (FRAMES - 1) * HOP))
         ).astype(np.float32)
    waves = {}
    for dtype in ("bf16", None):
        jax_model = JaxScoreModel(JaxScoreModelConfig(**cfg),
                                  backbone_kwargs=dict(SAMPLER_ARCH, **JAX_FLAGS, dtype=dtype),
                                  sde_kwargs=dict(SDE_KWARGS, N=N_STEPS))
        if dtype == "bf16":
            variables = jax_model.init_variables(jax.random.PRNGKey(23), num_frames=FRAMES)
            variables = {"params": _heads_redrawn(variables["params"], seed=24)}
            with jax.disable_jit():
                waves[dtype] = np.asarray(_jax_program(jax_model, variables, jnp.asarray(y), key))
        else:
            waves[dtype] = np.asarray(_jax_program(jax_model, variables, jnp.asarray(y), key))
    port = ScoreModel(ScoreModelConfig(**cfg), backbone_kwargs=dict(SAMPLER_ARCH, dtype="bf16"),
                      sde_kwargs=dict(SDE_KWARGS, N=N_STEPS), device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(variables["params"], **SAMPLER_ARCH),
                                  strict=True)
    draws = replay_pc_draws(key, N_STEPS, shape)
    with torch.no_grad():
        out = _port_program(port, torch.from_numpy(y), noise_from(draws)).numpy()
    gap, err = _rel(waves["bf16"], waves[None]), _rel(out, waves["bf16"])
    with capsys.disabled():
        print(f"\nbbed_pc batch {BATCH}, N={N_STEPS}, bf16: JAX bf16 vs JAX float32 waveform "
              f"{gap:.3e}; port bf16 vs JAX bf16 {err:.3e} (limit {GAP_SHARE * gap:.3e})")
    assert out.shape == waves["bf16"].shape == y.shape
    assert np.isfinite(out).all()
    assert err <= GAP_SHARE * gap
