"""The port's diffusion maths and ``ScoreModel.enhance`` against the JAX
package, on identical weights (the bridge) and identical noise draws.

The JAX sampler's draws are deterministic functions of its PRNG key; the
tests replay its key schedule (prior from ``split(key)[0]``, then per step
``k, kc, kp = split(k, 3)`` with the corrector's draw from
``fold_in(kc, i)`` and the predictor's from ``kp``) and feed those draws to
the port through its injected noise source, in the port's draw order.
Waveforms must agree to a relative error below 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models import score_model as jax_score_model
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.models.snrnet import SNRNet as JaxSNRNet
from diffse_tpu.sampling import get_pc_sampler as jax_get_pc_sampler
from diffse_tpu.sampling import timesteps_space as jax_timesteps_space
from diffse_tpu.sde import BBED as JaxBBED
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import score_model
from diffse_tpu_torch.models.ncsnpp import NCSNppSNR
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.shared import BackboneRegistry
from diffse_tpu_torch.sampling import get_pc_sampler, timesteps_space
from diffse_tpu_torch.sde import BBED
from test_torch_ncsnpp import random_jax_params
from test_torch_snr import port_snrnet, random_snrnet_params

torch.set_num_threads(2)

# three levels (the JAX package's tiny NCSN++ has five): every kind of block,
# attention at the deepest, and a shorter compile of the JAX program
ARCH = dict(nf=4, ch_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(64,),
            image_size=256)
JAX_FLAGS = dict(use_pallas_groupnorm=True, fuse_pyramid=True)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
FIXED_SNR = 0.17783  # the -15 dB training set's SNR as an amplitude ratio
HOP = 128
T_ORIG = 63 * HOP  # 64 frames: the width bucket pads nothing
SPEC_SHAPE = (1, 1, 256, 64)


def replay_pc_draws(key, n_steps, shape=SPEC_SHAPE, corrector_steps=1):
    """The JAX pc sampler's draws, in the order it consumes them."""
    dummy = jnp.zeros(shape, jnp.complex64)
    prior_key, k = jax.random.split(key)
    draws = [np.asarray(jax_randn_like(prior_key, dummy))]
    for _ in range(n_steps):
        k, kc, kp = jax.random.split(k, 3)
        for i in range(corrector_steps):
            draws.append(np.asarray(jax_randn_like(jax.random.fold_in(kc, i), dummy)))
        draws.append(np.asarray(jax_randn_like(kp, dummy)))
    return draws


def noise_from(draws):
    """The port's noise source, handing out ``draws`` in order."""
    it = iter(draws)

    def noise(like):
        z = torch.from_numpy(np.array(next(it)))
        assert tuple(z.shape) == tuple(like.shape)
        return z.to(like.device)

    return noise


def _rel_err(out, ref):
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def _cspec(rng, shape, scale):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def test_timesteps_space_matches_jax():
    np.testing.assert_array_equal(timesteps_space(0.999, 30, 0.03),
                                  jax_timesteps_space(0.999, 30, 0.03))


def test_bbed_sde_matches_jax():
    rng = np.random.default_rng(0)
    t = np.asarray([0.03, 0.2, 0.5, 0.9, 0.999], np.float32)
    x = _cspec(rng, (5, 1, 8, 6), 0.3)
    y = _cspec(rng, (5, 1, 8, 6), 0.3)
    ours, ref = BBED(**SDE_KWARGS), JaxBBED(**SDE_KWARGS)
    tt, xt, yt = torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y)
    tj, xj, yj = jnp.asarray(t), jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(ours._std(tt).numpy(), np.asarray(ref._std(tj)), rtol=1e-5)
    for a, b in zip(ours.sde(xt, tt, yt), ref.sde(xj, tj, yj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.marginal_prob(xt, tt, yt)[0].numpy(),
                               np.asarray(ref.marginal_prob(xj, tj, yj)[0]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(ours.discretize(xt, tt, yt, 0.0333), ref.discretize(xj, tj, yj, 0.0333)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("corrector", ["ald", "none"])
def test_pc_sampler_matches_jax(corrector):
    """The sampler loop alone, with an analytic score in place of the network."""
    rng = np.random.default_rng(1)
    shape = (2, 1, 16, 8)
    y = _cspec(rng, shape, 0.5)
    sde_ours, sde_ref = BBED(**SDE_KWARGS, N=6), JaxBBED(**SDE_KWARGS, N=6)

    def score(x, t, y_):
        return (y_ - x) * (1.0 + t[:, None, None, None])

    key = jax.random.PRNGKey(3)
    ref, nfe_ref = jax_get_pc_sampler(
        "reverse_diffusion", corrector, sde_ref, score, jnp.asarray(y), snr=0.5,
        eps=0.03)(key)
    draws = replay_pc_draws(key, 6, shape, corrector_steps=1 if corrector == "ald" else 0)
    out, nfe = get_pc_sampler("reverse_diffusion", corrector, sde_ours, score,
                              torch.from_numpy(y), noise_from(draws), snr=0.5, eps=0.03)()
    assert nfe == int(nfe_ref)
    assert _rel_err(out.numpy(), np.asarray(ref)) < 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return random_jax_params(ARCH, seed=5)


def _model_pair(jax_params, model_type, sigma_max, snr_conditioned="false",
                backbone="ncsnpp", snr_params=None):
    """The JAX model and the port's on the same weights (and the same SNRNet
    weights, when ``snr_params`` is given)."""
    jax_cfg = JaxScoreModelConfig(backbone=backbone, sde="bbed", model_type=model_type,
                                  snr_conditioned=snr_conditioned, fixed_snr=FIXED_SNR,
                                  sigma_max=sigma_max, t_eps=3e-2)
    ref = JaxScoreModel(jax_cfg, backbone_kwargs=dict(ARCH, **JAX_FLAGS),
                        sde_kwargs=dict(SDE_KWARGS, N=30),
                        snr_model=None if snr_params is None else (
                            JaxSNRNet(), {"params": snr_params}))
    cfg = ScoreModelConfig(**{f: getattr(jax_cfg, f) for f in ScoreModelConfig.__dataclass_fields__})
    ours = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=dict(SDE_KWARGS, N=30),
                      device="cpu", snr_model=None if snr_params is None else port_snrnet(snr_params))
    ours.backbone.load_state_dict(
        state_dict_from_jax(jax_params, **ARCH, snr_conditioning=backbone == "ncsnpp_snr"),
        strict=True)
    return ref, ours


def _noisy_wav(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, T_ORIG)) * 0.1).astype(np.float32)


def _clean_and_noisy(seed):
    """A harmonic 'clean' waveform and the same plus white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(T_ORIG) / 16000
    clean = 0.3 * np.sin(2 * np.pi * 190 * t) * (0.2 + np.abs(np.sin(2 * np.pi * 3 * t)))
    noisy = clean + 0.05 * rng.standard_normal(T_ORIG)
    return clean[None].astype(np.float32), noisy[None].astype(np.float32)


def _single_draw(key):
    """The one draw ``randn_like(key, Y)`` of the JAX package's 1-NFE branches."""
    return np.asarray(jax_randn_like(key, jnp.zeros(SPEC_SHAPE, jnp.complex64)))


def _jax_t_hat(est_snr):
    """The JAX package's snap of ``est_snr`` to the Karras grid."""
    t30 = jnp.asarray(jax_score_model.t_30)
    t_ = jax_score_model.calculate_snr_direct(1.0, jnp.float32(est_snr), FIXED_SNR)
    return np.float32(t30[jnp.argmin(jnp.abs(t30 - t_))])


@pytest.fixture(scope="module")
def snr_params():
    # the fc bias puts g_hat near 0.12, so est_snr ~ 0.14 and t_hat inside the grid
    return random_snrnet_params(seed=11, fc_bias=-2.0)


def test_enhance_bbed_pc_matches_jax(jax_params):
    """The main path: 30 PC steps (reverse_diffusion + ald), 60 forwards."""
    ref_model, ours = _model_pair(jax_params, "bbed", 0.5)
    y = _noisy_wav(1)
    key = jax.random.PRNGKey(7)
    ref = ref_model.enhance({"params": jax_params}, y, y, key=key, N=30)
    out = ours.enhance(y, y, noise=noise_from(replay_pc_draws(key, 30)), N=30)
    assert out.shape == ref.shape == (T_ORIG,)
    assert _rel_err(out, ref) < 1e-4


def test_enhance_sebridge_v2_matches_jax(jax_params):
    """The 1-NFE branch: one draw Z, X_T = Y + Z*sigma_max*0.999."""
    ref_model, ours = _model_pair(jax_params, "sebridge_v2", 1.0)
    y = _noisy_wav(2)
    key = jax.random.PRNGKey(13)
    ref = ref_model.enhance({"params": jax_params}, y, y, key=key)
    draw = np.asarray(jax_randn_like(key, jnp.zeros(SPEC_SHAPE, jnp.complex64)))
    out = ours.enhance(y, y, noise=noise_from([draw]))
    assert out.shape == ref.shape == (T_ORIG,)
    assert _rel_err(out, ref) < 1e-4


def test_enhance_sebridge_matches_jax(jax_params):
    """The deterministic 1-NFE branch: one forward from Y at t = 0.999."""
    ref_model, ours = _model_pair(jax_params, "sebridge", 0.5)
    y = _noisy_wav(4)
    ref = ref_model.enhance({"params": jax_params}, y, y, key=jax.random.PRNGKey(0))
    out = ours.enhance(y, y, noise=noise_from([]))
    assert out.shape == ref.shape == (T_ORIG,)
    assert _rel_err(out, ref) < 1e-4


@pytest.mark.parametrize("oracle", [False, True], ids=["snrnet", "oracle"])
def test_enhance_sebridge_v3_snr_matches_jax(jax_params, snr_params, oracle):
    """The paper's single-NFE mode: SNRNet's estimate on the unpadded y (or
    the oracle ``noise_rms / clean_rms``), snapped to the Karras grid, the
    normalisation factor corrected, one forward at t_hat. The snapped t_hat
    is the JAX package's, and inside the grid."""
    ref_model, ours = _model_pair(jax_params, "sebridge_v3", 1.0, snr_conditioned="true",
                                  snr_params=snr_params)
    _, y = _clean_and_noisy(5)
    key = jax.random.PRNGKey(17)
    rms = dict(oracle=oracle, clean_rms=1.0, noise_rms=0.07)
    ref = ref_model.enhance({"params": jax_params}, y, y, key=key, **rms)
    out = ours.enhance(y, y, noise=noise_from([_single_draw(key)]), **rms)
    assert out.shape == ref.shape == (T_ORIG,)
    assert _rel_err(out, ref) < 1e-4

    if oracle:
        est, est_ref = np.float32(0.07), np.float32(0.07)
    else:
        est = ours.estimate_snr(y)[0].item()
        est_ref = float(ref_model.estimate_snr(jnp.asarray(y))[0])
    t_hat = score_model.snap_to_karras_grid(est, FIXED_SNR)[0]
    assert t_hat == _jax_t_hat(est_ref)
    assert score_model.T_30_F32[0] < t_hat < score_model.T_30_F32[-1]


def test_enhance_sebridge_v2_snr_matches_jax(snr_params):
    """The SNR-conditioned NCSN++ (``ncsnpp_snr``): the noise level is
    ``max|X - Y| * sigma_max`` from the clean reference, and its log feeds
    the second Fourier embedding."""
    params = random_jax_params(ARCH, seed=6, snr=True)
    ref_model, ours = _model_pair(params, "sebridge_v2", 0.5, snr_conditioned="true",
                                  backbone="ncsnpp_snr", snr_params=snr_params)
    x, y = _clean_and_noisy(7)
    key = jax.random.PRNGKey(19)
    ref = ref_model.enhance({"params": params}, x, y, key=key)
    out = ours.enhance(x, y, noise=noise_from([_single_draw(key)]))
    assert out.shape == ref.shape == (T_ORIG,)
    assert _rel_err(out, ref) < 1e-4


def test_noise_cond_follows_the_backbone_not_its_name():
    """The backbone's class says whether it takes the noise condition, so an
    SNR-conditioned backbone under another registered name still gets ``s``
    and computes what ``ncsnpp_snr`` does."""
    alias = "ncsnpp_snr_alias"
    if alias not in BackboneRegistry.get_all_names():
        BackboneRegistry.register(alias)(type("NCSNppSNRAlias", (NCSNppSNR,), {}))
    models = {}
    for backbone, takes in (("ncsnpp", False), ("ncsnpp_snr", True), (alias, True)):
        cfg = ScoreModelConfig(backbone=backbone, sde="bbed", model_type="sebridge_v2",
                               snr_conditioned="true")
        models[backbone] = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS,
                                      device="cpu", generator=torch.Generator().manual_seed(2))
        assert models[backbone].backbone_takes_noise_cond is takes
    rng = np.random.default_rng(9)
    x, y = (torch.from_numpy(_cspec(rng, SPEC_SHAPE, 0.3)) for _ in range(2))
    t, s = torch.tensor([0.5]), torch.tensor([0.07])
    outs = [models[b].forward(x, t, y, s=s) for b in ("ncsnpp_snr", alias)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], models[alias].forward(x, t, y, s=t))


def test_enhance_snr_fixed_is_not_for_inference():
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                           snr_conditioned="fixed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu")
    y = _noisy_wav(8)
    with pytest.raises(NotImplementedError):
        model.enhance(y, y)


@pytest.mark.parametrize("length", [8000, 8100])
def test_enhance_keeps_length_and_seed(length):
    """Host padding to the width bucket and back; a generator makes the run
    reproducible."""
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    y = _noisy_wav(3)[:, :length] if length <= T_ORIG else np.tile(_noisy_wav(3), 2)[:, :length]
    a = model.enhance(y, y, generator=torch.Generator().manual_seed(1), N=2)
    b = model.enhance(y, y, generator=torch.Generator().manual_seed(1), N=2)
    assert a.shape == (length,) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


def test_score_model_runs_on_the_card_unless_told(monkeypatch):
    """``ScoreModel`` defaults to the card; without one, the default raises
    and nothing falls back to the CPU. ``device="cpu"`` works as before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cuda")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu")
    assert model.device == torch.device("cpu")
    assert next(model.backbone.parameters()).device.type == "cpu"
    y = _noisy_wav(5)
    out = model.enhance(y, y, noise=lambda like: torch.zeros_like(like))
    assert out.shape == (y.shape[-1],) and np.isfinite(out).all()
