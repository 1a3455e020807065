"""The bf16 trunk of every NCSN++ configuration (``NCSNpp(dtype="bf16")``,
``NCSNppSNR``) against the JAX package's bf16 program.

The JAX side runs ``dtype="bf16"`` with ``use_pallas_groupnorm=True,
fuse_pyramid=True`` op by op, as tests/test_torch_bf16.py runs the paper's
configuration; the weights are the JAX package's initialisation at
tests/test_torch_backbones.py's TINY size, bridged by
``convert.state_dict_from_jax``; inputs are made with numpy from a seed.

Each forward is held three ways. Module by module: every block, attention,
Combine and resampling layer with parameters, fed the inputs the JAX
module was given, returns the JAX module's dtype and its output within one
bf16 ulp but on at most ``BF16_SHARE`` of the elements (float32 outputs
within 1e-5 of their largest magnitude). Whole: the port's output within
``GAP_SHARE`` (a third) of the JAX package's own bf16-vs-float32 gap of the
JAX bf16 output, both printed. And by its noise: the port's output is as
far from the JAX float32 output as the JAX bf16 output is (root mean
square, within ``NOISE_SHARE``), which a trunk that computed in float32, or
rounded elsewhere, would not be.

Where a module's float32 sums, taken in another order than XLA's, flip a
bf16 rounding (about one element in four thousand), the flip grows through
the depth like any bf16 rounding. In ``FLIPS_GROW`` (init_scale 0.1, so
that the blocks' last convs do not start near zero) one flipped rounding
reaches the output at the size of the gap itself: there the test moves one
element of the JAX middle block's bf16 output by one ulp (``ONE_ULP_AT``)
and JAX's own output moves by more than a third of its gap (0.60 and 0.93
of it here), as far as the port lies from it (0.93 and 0.77). Those two are
held whole to ``FLIPS_GROW_BOUND`` of the gap, and to JAX's own one-ulp
move exceeding ``GAP_SHARE`` (else the exception is void); the module and
noise checks hold as for the rest.

Then ``enhance`` with the bf16 trunk of DDPM++ and of the residual
configuration (BigGAN FIR blocks with both residual pyramids):
``sebridge_v2`` and ``bbed_pc`` (N = 2), the JAX package's draws fed to the
port, against the JAX package's bf16 ``enhance`` run op by op
(``jax.disable_jit``: jitted, XLA would fuse bf16 operations and skip their
roundings), within ``GAP_SHARE`` of its own bf16-vs-float32 waveform gap,
both printed, on the JAX package's initialisation with the heads and the
output layer redrawn.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffse_tpu.models.ncsnpp import NCSNppSNR as JaxNCSNppSNR
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch import convert
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.models.ncsnpp import NCSNpp, NCSNppSNR
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from test_torch_backbones import CONFIGS, DDPMPP, TINY
from test_torch_bf16 import GAP_SHARE, JAX_FLAGS, _heads_redrawn, _rel
from test_torch_conv_plan import BF16_SHARE, bf16_ulps
from test_torch_enhance import noise_from, replay_pc_draws

torch.set_num_threads(2)

# (configuration, SNR-conditioned): a flipped rounding grows to the gap's size
FLIPS_GROW = {("biggan-noskiprescale-positional-none", False),
              ("biggan-noskiprescale-positional-none", True)}
FLIPS_GROW_BOUND = 1.25
# (module path, element) of the JAX bf16 output moved by one ulp
ONE_ULP_AT = (("ResnetBlockBigGANpp_3",), (0, 3, 4, 5))
# |rms(port - JAX float32) / rms(JAX bf16 - JAX float32) - 1|
NOISE_SHARE = 0.1
F32_TOL = 1e-5
# the modules of the trunk a forward is held to module by module
CHECKED = (layers.ResnetBlockBigGANpp, layers.ResnetBlockDDPMpp, layers.AttnBlockpp,
           layers.Combine, layers.Upsample, layers.Downsample)


def _inputs(snr):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 2, 16, 16))
         + 1j * rng.standard_normal((2, 2, 16, 16))).astype(np.complex64)
    conds = [np.asarray([0.5, 0.9], np.float32)]
    if snr:
        conds.append(np.asarray([0.3, 0.7], np.float32))
    return x, conds


def _rms(out, ref):
    return float(np.sqrt(np.mean(np.abs(out - ref) ** 2)))


def _jax_bf16_recording(jax_cls, arch, params, x, conds):
    """The JAX bf16 output op by op, and each submodule's (inputs, output)
    by its path, recorded as the forward calls them."""
    calls = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.path:
            calls.setdefault(context.module.path, (args, out))
        return out

    model = jax_cls(**arch, **JAX_FLAGS, dtype="bf16")
    with nn.intercept_methods(record):
        out = model.apply({"params": params}, jnp.asarray(x), *map(jnp.asarray, conds))
    return np.asarray(out), calls


def _jax_bf16_one_ulp(jax_cls, arch, params, x, conds):
    """The JAX bf16 output op by op with the element ``ONE_ULP_AT`` of one
    module's output moved up by one bf16 ulp."""
    path, idx = ONE_ULP_AT

    def moved(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.path == path:
            bits = np.array(out).view(np.uint16).copy()
            bits[idx] += 1
            out = jnp.asarray(bits.view(jnp.bfloat16))
        return out

    model = jax_cls(**arch, **JAX_FLAGS, dtype="bf16")
    with nn.intercept_methods(moved):
        out = model.apply({"params": params}, jnp.asarray(x), *map(jnp.asarray, conds))
    return np.asarray(out)


def _to_port(a):
    """A JAX NHWC map (or another array) as the port's tensor: NCHW in
    channels_last memory, in its dtype."""
    if not hasattr(a, "dtype"):
        return a
    bf16 = a.dtype == jnp.bfloat16
    t = torch.from_numpy(np.array(a.astype(jnp.float32) if bf16 else a))
    if t.ndim == 4:
        t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return t.bfloat16() if bf16 else t


def _module_gaps(port, arch, snr, calls):
    """Each checked module of ``port`` on the inputs its JAX module was
    given: (name, port dtype, JAX dtype, share of elements beyond one bf16
    ulp or None, largest difference over the largest magnitude)."""
    corr = convert.ncsnpp_correspondence(
        **{k: v for k, v in arch.items() if k not in convert.NCSNPP_VALUE_FIELDS},
        snr_conditioning=snr)
    tops = {}
    for prefix, flax_path, _ in corr:
        if prefix.startswith("all_modules."):
            tops.setdefault(".".join(prefix.split(".")[:2]), flax_path[0])
    rows = []
    for name, flax_name in tops.items():
        module = port.get_submodule(name)
        if not isinstance(module, CHECKED) or (flax_name,) not in calls:
            continue
        args, out = calls[(flax_name,)]
        args = [_to_port(a) for a in args]
        if isinstance(module, (layers.ResnetBlockBigGANpp, layers.ResnetBlockDDPMpp)):
            # (x, temb, semb, train[, x2]) -> (x, temb, semb, x2)
            args = args[:3] + args[4:5]
        with torch.no_grad():
            got = module(*args)
        ref = _to_port(out)
        scale = ref.double().abs().max().item()
        rel = (got.double() - ref.double()).abs().max().item() / scale
        share = None
        if ref.dtype == torch.bfloat16:
            share = (bf16_ulps(got, ref) > 1).double().mean().item()
        rows.append((name, got.dtype, ref.dtype, share, rel))
    return rows


@pytest.mark.parametrize("snr", [False, True], ids=["ncsnpp", "ncsnpp_snr"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_forward_matches_jax(name, snr, capsys):
    arch = {**TINY, **CONFIGS[name]}
    jax_cls, cls = (JaxNCSNppSNR, NCSNppSNR) if snr else (JaxNCSNpp, NCSNpp)
    x, conds = _inputs(snr)
    # the float32 output comes with the initialisation, op by op
    ref32, variables = jax_cls(**arch, **JAX_FLAGS).init_with_output(
        jax.random.PRNGKey(0), jnp.asarray(x), *map(jnp.asarray, conds))
    params, ref32 = variables["params"], np.asarray(ref32)
    ref16, calls = _jax_bf16_recording(jax_cls, arch, params, x, conds)
    port = cls(**arch, dtype="bf16").eval()
    port.load_state_dict(state_dict_from_jax(params, **arch, snr_conditioning=snr), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x), *map(torch.from_numpy, conds)).numpy()
    rows = _module_gaps(port, arch, snr, calls)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    noise = _rms(out, ref32) / _rms(ref16, ref32)
    share, witness = GAP_SHARE, ""
    if (name, snr) in FLIPS_GROW:
        share = FLIPS_GROW_BOUND
        one_ulp = _rel(_jax_bf16_one_ulp(jax_cls, arch, params, x, conds), ref16) / gap
        witness = f"JAX bf16 with one element moved one ulp vs JAX bf16 {one_ulp:.3f} x the gap; "
        assert one_ulp > GAP_SHARE
    with capsys.disabled():
        print(f"\n{name} {'ncsnpp_snr' if snr else 'ncsnpp'} bf16: JAX bf16 vs JAX float32 "
              f"{gap:.3e}; port bf16 vs JAX bf16 {err:.3e} (limit {share:.3f} x the gap); "
              f"port bf16 vs JAX float32 {noise:.3f} x the gap in rms; {witness}"
              f"{len(rows)} modules, worst share beyond one ulp "
              f"{max((r[3] or 0.0) for r in rows):.2e}")
    assert out.shape == ref16.shape == (2, 1, 16, 16) and out.dtype == np.complex64
    assert rows
    for name_, got_dtype, ref_dtype, share_, rel in rows:
        assert got_dtype == ref_dtype, name_
        if share_ is None:
            assert rel <= F32_TOL, (name_, rel)
        else:
            assert share_ <= BF16_SHARE, (name_, share_)
    assert err <= share * gap
    assert abs(noise - 1.0) <= NOISE_SHARE


# ------------------------------------------------------------------- enhance

# two levels, attention at the second (128 x 32 positions): each level of the
# JAX bf16 program op by op costs seconds
ENHANCE_ARCH = dict(nf=4, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(128,),
                    image_size=256)
RESIDUAL = dict(progressive="residual", progressive_input="residual")
ENHANCE_CONFIGS = {"ddpmpp": {k: v for k, v in DDPMPP.items() if k != "dropout"},
                   "residual": RESIDUAL}
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
FRAMES = 64
SAMPLES = (FRAMES - 1) * 128
N_STEPS = 2


_PARAMS = {}


def _initialised(jax_model, config):
    """The backbone's initialisation (jitted: op by op it costs more than its
    compilation), one for both branches of a configuration."""
    if config not in _PARAMS:
        _PARAMS[config] = jax.jit(lambda key: jax_model.init_variables(
            key, num_frames=FRAMES))(jax.random.PRNGKey(31))["params"]
    return _PARAMS[config]


def _enhance_pair(config, model_type, sigma_max):
    """The JAX ScoreModel in bf16 and float32 and the port's in bf16, on the
    JAX package's initialisation with the heads and the output layer
    redrawn (``_heads_redrawn``: at zero they would hide the network)."""
    arch = dict(ENHANCE_ARCH, **ENHANCE_CONFIGS[config])
    cfg = dict(backbone="ncsnpp", sde="bbed", model_type=model_type, snr_conditioned="false",
               sigma_max=sigma_max, t_eps=3e-2)
    sde = dict(SDE_KWARGS, N=N_STEPS)
    jax16, jax32 = (JaxScoreModel(JaxScoreModelConfig(**cfg),
                                  backbone_kwargs=dict(arch, **JAX_FLAGS, dtype=dtype),
                                  sde_kwargs=sde) for dtype in ("bf16", None))
    variables = {"params": _heads_redrawn(_initialised(jax32, config), seed=32)}
    port = ScoreModel(ScoreModelConfig(**cfg), backbone_kwargs=dict(arch, dtype="bf16"),
                      sde_kwargs=sde, device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(variables["params"], **arch),
                                  strict=True)
    return jax16, jax32, variables, port


@pytest.mark.parametrize("branch", ["sebridge_v2", "bbed_pc"])
@pytest.mark.parametrize("config", list(ENHANCE_CONFIGS))
def test_bf16_enhance_matches_jax(config, branch, capsys):
    model_type, sigma_max = ("bbed", 0.5) if branch == "bbed_pc" else ("sebridge_v2", 1.0)
    jax16, jax32, variables, port = _enhance_pair(config, model_type, sigma_max)
    rng = np.random.default_rng(33)
    x = (0.1 * rng.standard_normal((1, SAMPLES))).astype(np.float32)
    y = x + (0.05 * rng.standard_normal((1, SAMPLES))).astype(np.float32)
    key = jax.random.PRNGKey(34)
    spec = (1, 1, 256, FRAMES)
    if branch == "bbed_pc":
        draws = replay_pc_draws(key, N_STEPS, spec)
    else:
        draws = [np.asarray(jax_randn_like(key, jnp.zeros(spec, jnp.complex64)))]
    kw = dict(key=key, N=N_STEPS, clean_rms=1.0, noise_rms=1.0)
    with jax.disable_jit():
        ref16 = np.asarray(jax16.enhance(variables, x, y, **kw))
    ref32 = np.asarray(jax32.enhance(variables, x, y, **kw))
    out = port.enhance(x, y, noise=noise_from(draws), N=N_STEPS)
    gap, err = _rel(ref16, ref32), _rel(out, ref16)
    with capsys.disabled():
        print(f"\n{config} {branch} bf16 enhance: JAX bf16 vs JAX float32 waveform {gap:.3e}; "
              f"port bf16 vs JAX bf16 {err:.3e} (limit {GAP_SHARE * gap:.3e})")
    assert out.shape == ref16.shape == (SAMPLES,) and np.isfinite(out).all()
    assert err <= GAP_SHARE * gap
