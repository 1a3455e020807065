"""The port's SDEs, time grids, predictors and correctors, and ``enhance``
with them, against the JAX package on the same inputs and the same draws.

The JAX samplers run op by op (``jax.disable_jit``), and their draws are
replayed into the port's noise source in the order the port takes them
(the prior, then per step the corrector's and the predictor's), as in
``tests/test_torch_enhance.py``. Tolerances (max |diff| / max |ref|): the
SDE methods 1e-6; the time grids within 2 float32 ulp (``torch.sigmoid``
and ``torch.exp`` against XLA's may round the other way); the samplers on
an analytic score 1e-5; ``enhance`` on the tiny NCSN++ 1e-4, as every
enhance test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.sampling import CorrectorRegistry as JaxCorrectorRegistry
from diffse_tpu.sampling import PredictorRegistry as JaxPredictorRegistry
from diffse_tpu.sampling import get_pc_sampler as jax_get_pc_sampler
from diffse_tpu.sampling import timesteps_space as jax_timesteps_space
from diffse_tpu.sde import SDERegistry as JaxSDERegistry
from diffse_tpu.transforms.stft import get_window as jax_get_window
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.sampling import (
    CorrectorRegistry,
    PredictorRegistry,
    get_ode_sampler,
    get_pc_sampler,
    step_grid,
    timesteps_space,
)
from diffse_tpu_torch.sampling.predictors import ReverseDiffusionPredictor
from diffse_tpu_torch.sde import SDERegistry
from diffse_tpu_torch.transforms import get_window
from diffse_tpu_torch.utils import randn_like
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

# three levels (the JAX package's tiny NCSN++ has five): every kind of block,
# attention at the deepest, and a shorter compile of the JAX program
ARCH = dict(nf=4, ch_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(64,),
            image_size=256)
JAX_FLAGS = dict(use_pallas_groupnorm=True, fuse_pyramid=True)
HOP = 128
T_ORIG = 63 * HOP  # 64 frames: the width bucket pads nothing
SPEC_SHAPE = (1, 1, 256, 64)
SHAPE = (2, 1, 16, 8)
# Each SDE at the parameters the tests use: BBED at the paper's, OUVE at its
# defaults, PROPOSED_1 with sigma_max != sigma_min (at its defaults its std
# is NaN in both packages: Ei(0) = -inf).
SDE_KWARGS = {"ouve": {}, "bbed": dict(T_sampling=0.999, k=2.6, theta=0.52),
              "proposed_1": dict(sigma_min=1.0, sigma_max=2.6, theta=0.52)}
PREDICTORS = ["reverse_diffusion", "euler_maruyama", "heun", "exp_euler", "exp_heun", "none"]
CORRECTORS = ["ald", "langevin", "none"]
GRIDS = ["linear", "logit", "bridge_geom"]
STOCHASTIC = {"reverse_diffusion", "euler_maruyama"}  # the predictors that draw


def rel_err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def cspec(rng, shape, scale):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def sde_pair(name, **overrides):
    kw = dict(SDE_KWARGS[name], **overrides)
    return SDERegistry.get_by_name(name)(**kw), JaxSDERegistry.get_by_name(name)(**kw)


def analytic_score(x, t, y):
    return (y - x) * (1.0 + t[:, None, None, None])


def replay_draws(key, n_steps, shape, corrector_steps, predictor_draws):
    """The JAX pc sampler's draws, in the order the port takes them."""
    dummy = jnp.zeros(shape, jnp.complex64)
    prior_key, k = jax.random.split(key)
    draws = [np.asarray(jax_randn_like(prior_key, dummy))]
    for _ in range(n_steps):
        k, kc, kp = jax.random.split(k, 3)
        draws += [np.asarray(jax_randn_like(jax.random.fold_in(kc, i), dummy))
                  for i in range(corrector_steps)]
        if predictor_draws:
            draws.append(np.asarray(jax_randn_like(kp, dummy)))
    return draws


def noise_from(draws):
    """The port's noise source, handing out ``draws`` in order, all of them."""
    it = iter(draws)

    def noise(like):
        z = torch.from_numpy(np.array(next(it)))
        assert tuple(z.shape) == tuple(like.shape)
        return z.to(like.device)

    noise.left = lambda: sum(1 for _ in it)
    return noise


# ----------------------------------------------------------------- registries


def test_every_name_of_the_jax_registries_is_ported():
    for ours, ref in ((SDERegistry, JaxSDERegistry), (PredictorRegistry, JaxPredictorRegistry),
                      (CorrectorRegistry, JaxCorrectorRegistry)):
        assert sorted(ours.get_all_names()) == sorted(ref.get_all_names())


# ----------------------------------------------------------------------- SDEs


@pytest.mark.parametrize("name", sorted(SDE_KWARGS))
def test_sde_matches_jax(name):
    """sde, marginal_prob, _std, mean_coeffs, discretize (a host step and a
    device step) and the prior, on the same inputs and draw."""
    ours, ref = sde_pair(name)
    rng = np.random.default_rng(0)
    t = np.asarray([0.03, 0.2, 0.5, 0.9, ours.T], np.float32)
    x, y = (cspec(rng, (5, 1, 8, 6), 0.3) for _ in range(2))
    tt, xt, yt = torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y)
    tj, xj, yj = jnp.asarray(t), jnp.asarray(x), jnp.asarray(y)
    pairs = [(ours._std(tt), ref._std(tj))]
    pairs += list(zip(ours.sde(xt, tt, yt), ref.sde(xj, tj, yj)))
    pairs += list(zip(ours.marginal_prob(xt, tt, yt), ref.marginal_prob(xj, tj, yj)))
    pairs += list(zip(ours.mean_coeffs(tt), ref.mean_coeffs(tj)))
    for step in (0.0333, torch.tensor(0.0333)):
        pairs += list(zip(ours.discretize(xt, tt, yt, step), ref.discretize(xj, tj, yj, 0.0333)))
    key = jax.random.PRNGKey(1)
    draw = np.asarray(jax_randn_like(key, yj))
    pairs.append((ours.prior_sampling(lambda like: torch.from_numpy(draw.copy()), yt)[0],
                  ref.prior_sampling(key, yj)[0]))
    for i, (a, b) in enumerate(pairs):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert np.isfinite(a).all() and rel_err(a, b) < 1e-6, i


@pytest.mark.parametrize("probability_flow", [False, True], ids=["sde", "flow"])
@pytest.mark.parametrize("name", sorted(SDE_KWARGS))
def test_reverse_sde_matches_jax(name, probability_flow):
    ours, ref = sde_pair(name)
    rng = np.random.default_rng(1)
    t = np.asarray([0.1, 0.6, 0.95], np.float32)
    x, y = (cspec(rng, (3, 1, 8, 6), 0.3) for _ in range(2))
    tt, xt, yt = torch.from_numpy(t), torch.from_numpy(x), torch.from_numpy(y)
    tj, xj, yj = jnp.asarray(t), jnp.asarray(x), jnp.asarray(y)
    rev = ours.reverse(analytic_score, probability_flow=probability_flow)
    rev_ref = ref.reverse(analytic_score, probability_flow=probability_flow)
    assert (rev.T, rev.N) == (rev_ref.T, rev_ref.N)
    parts, parts_ref = rev.rsde_parts(xt, tt, yt), rev_ref.rsde_parts(xj, tj, yj)
    assert parts.keys() == parts_ref.keys()
    pairs = [(parts[k], parts_ref[k]) for k in parts]
    pairs += list(zip(rev.sde(xt, tt, yt), rev_ref.sde(xj, tj, yj)))
    pairs += list(zip(rev.discretize(xt, tt, yt, 0.05), rev_ref.discretize(xj, tj, yj, 0.05)))
    for i, (a, b) in enumerate(pairs):
        if probability_flow and not np.asarray(b).any():  # the flow's zero diffusion
            assert not a.numpy().any(), i
        else:
            assert rel_err(a.numpy(), b) < 1e-6, i


def test_default_config_builds_with_ouve():
    """The default ScoreModelConfig (sde "ouve"): the model builds, its SDE
    is the JAX package's OUVE at the same settings."""
    model = ScoreModel(ScoreModelConfig(), backbone_kwargs=ARCH, device="cpu")
    ref_cfg = JaxScoreModelConfig()
    assert model.cfg.sde == ref_cfg.sde == "ouve"
    ref_sde = JaxSDERegistry.get_by_name(ref_cfg.sde)()
    assert type(model.sde).__name__ == type(ref_sde).__name__ == "OUVESDE"
    assert dataclasses.astuple(model.sde) == dataclasses.astuple(ref_sde)
    assert model._branch() == "sebridge"


# ---------------------------------------------------------------- time grids


@pytest.mark.parametrize("n", [2, 20, 30])
@pytest.mark.parametrize("grid", GRIDS + ["cosine"])
def test_timesteps_space_matches_jax(grid, n):
    """The numpy grids bit for bit; an unknown name falls through to the
    linear grid in both packages."""
    out = timesteps_space(0.999, n, 0.03, grid)
    np.testing.assert_array_equal(out, jax_timesteps_space(0.999, n, 0.03, grid))
    assert out.dtype == np.float32
    if grid == "cosine":
        np.testing.assert_array_equal(out, timesteps_space(0.999, n, 0.03, "linear"))


@pytest.mark.parametrize("grid", ["logit", "bridge_geom"])
@pytest.mark.parametrize("t_end, n, eps", [(0.999, 1, 0.03), (1.0, 20, 0.03), (0.999, 20, 0.0),
                                           (0.5, 20, 0.6)])
def test_timesteps_space_rejects_what_jax_rejects(grid, t_end, n, eps):
    with pytest.raises(ValueError, match="grid needs N>=2"):
        jax_timesteps_space(t_end, n, eps, grid)
    with pytest.raises(ValueError, match="grid needs N>=2"):
        timesteps_space(t_end, n, eps, grid)


def _recording_score(times):
    def score(x, t, y):
        times.append(np.asarray(t, dtype=np.float32)[0])
        return analytic_score(x, t, y)

    return score


@pytest.mark.parametrize("n", [6, 20])
@pytest.mark.parametrize("grid", GRIDS)
def test_step_times_match_jax(grid, n):
    """Each step's time as the JAX sampler computes it on the device, float32
    (``t_of``): within 2 float32 ulp; and the grid's step sizes are the
    differences its closed forms give (the last step integrates t_last to 0)."""
    sde_ours, sde_ref = sde_pair("bbed", N=n)
    jax_times = []
    with jax.disable_jit():
        jax_get_pc_sampler("heun", "none", sde_ref, _recording_score(jax_times),
                           jnp.ones(SHAPE, jnp.complex64), eps=0.03,
                           timestep_type=grid)(jax.random.PRNGKey(0))
    jax_times = np.asarray(jax_times[::2])  # heun's first evaluation is at t
    timesteps = timesteps_space(sde_ours.T, n, 0.03, grid)
    times, steps = (a.numpy() for a in step_grid(timesteps, grid, "cpu"))
    assert times.dtype == steps.dtype == np.float32 and len(jax_times) == n
    ulp = np.spacing(np.abs(jax_times).astype(np.float32))
    assert np.max(np.abs(times - jax_times) / ulp) <= 2
    assert steps[-1] == timesteps[-1] and np.all(steps > 0)
    if grid == "logit":
        np.testing.assert_array_equal(steps[:-1], times[:-1] - times[1:])
    np.testing.assert_allclose(times, timesteps, rtol=1e-5)


# --------------------------------------------------------- the PC sampler


def _pc_case(predictor, corrector, grid, sde_name="bbed", n=6, seed=3, **options):
    """(port sample, port nfe, JAX sample, JAX nfe) on the analytic score."""
    rng = np.random.default_rng(seed)
    y = cspec(rng, SHAPE, 0.5)
    y_prior = options.pop("Y_prior", None)
    sde_ours, sde_ref = sde_pair(sde_name, N=n)
    key = jax.random.PRNGKey(seed)
    with jax.disable_jit():
        ref, nfe_ref = jax_get_pc_sampler(
            predictor, corrector, sde_ref, analytic_score, jnp.asarray(y),
            Y_prior=None if y_prior is None else jnp.asarray(y_prior), snr=0.5, eps=0.03,
            timestep_type=grid, **options)(key)
    corrector_steps = 0 if corrector == "none" else 1
    noise = noise_from(replay_draws(key, n, SHAPE, corrector_steps, predictor in STOCHASTIC))
    out, nfe = get_pc_sampler(predictor, corrector, sde_ours, analytic_score,
                              torch.from_numpy(y), noise,
                              Y_prior=None if y_prior is None else torch.from_numpy(y_prior),
                              snr=0.5, eps=0.03, timestep_type=grid, **options)()
    assert noise.left() == 0  # every draw taken, in order
    return out.numpy(), nfe, np.asarray(ref), int(nfe_ref)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("corrector", CORRECTORS)
@pytest.mark.parametrize("predictor", PREDICTORS)
def test_pc_sampler_matches_jax(predictor, corrector, grid):
    out, nfe, ref, nfe_ref = _pc_case(predictor, corrector, grid)
    assert nfe == nfe_ref
    assert np.isfinite(out).all() and rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("predictor, corrector, grid", [
    ("reverse_diffusion", "ald", "linear"), ("exp_heun", "langevin", "linear"),
    ("heun", "none", "linear"), ("euler_maruyama", "ald", "linear"),
    ("exp_euler", "none", "logit"), ("reverse_diffusion", "langevin", "bridge_geom")])
@pytest.mark.parametrize("sde_name", ["ouve", "proposed_1"])
def test_pc_sampler_other_sdes_match_jax(sde_name, predictor, corrector, grid):
    """OUVE (T = 1: the linear grid only) and PROPOSED_1 under the sampler."""
    if sde_name == "ouve" and grid != "linear":
        with pytest.raises(ValueError):
            _pc_case(predictor, corrector, grid, sde_name)
        return
    out, nfe, ref, nfe_ref = _pc_case(predictor, corrector, grid, sde_name)
    assert nfe == nfe_ref
    assert np.isfinite(out).all() and rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("options", [dict(denoise=False), dict(intermediate=True),
                                     dict(intermediate=True, denoise=False), dict(Y_prior=True),
                                     dict(corrector_steps=2)],
                         ids=["no_denoise", "intermediate", "intermediate_raw", "y_prior",
                              "two_corrector_steps"])
def test_pc_sampler_options_match_jax(options):
    options = dict(options)
    if options.get("Y_prior"):
        options["Y_prior"] = cspec(np.random.default_rng(4), SHAPE, 0.5)
    if options.get("corrector_steps") == 2:
        rng = np.random.default_rng(5)
        y = cspec(rng, SHAPE, 0.5)
        key = jax.random.PRNGKey(5)
        sde_ours, sde_ref = sde_pair("bbed", N=4)
        with jax.disable_jit():
            ref, nfe_ref = jax_get_pc_sampler("reverse_diffusion", "langevin", sde_ref,
                                              analytic_score, jnp.asarray(y), snr=0.5, eps=0.03,
                                              corrector_steps=2)(key)
        noise = noise_from(replay_draws(key, 4, SHAPE, 2, True))
        out, nfe = get_pc_sampler("reverse_diffusion", "langevin", sde_ours, analytic_score,
                                  torch.from_numpy(y), noise, snr=0.5, eps=0.03,
                                  corrector_steps=2)()
        out, ref = out.numpy(), np.asarray(ref)
    else:
        out, nfe, ref, nfe_ref = _pc_case("reverse_diffusion", "ald", "logit", **options)
    assert nfe == int(nfe_ref) and out.shape == ref.shape
    if options.get("intermediate"):
        assert out.shape == (6,) + SHAPE
    assert rel_err(out, ref) < 1e-5


def test_update_mean_matches_update_fn():
    """``update_mean`` is ``update_fn``'s denoised mean; reverse_diffusion's
    takes no draw."""
    rng = np.random.default_rng(6)
    x, y = (torch.from_numpy(cspec(rng, SHAPE, 0.4)) for _ in range(2))
    sde = SDERegistry.get_by_name("bbed")(**SDE_KWARGS["bbed"])
    t = torch.full((2,), 0.5)
    std = (sde._std(t), sde._std(t - 0.05))
    z = torch.from_numpy(cspec(rng, SHAPE, 1.0))
    for name in PREDICTORS:
        predictor = PredictorRegistry.get_by_name(name)(sde, analytic_score)
        kw = dict(std=std) if predictor.uses_std else {}
        mean = predictor.update_mean(lambda like: z, x, t, y, 0.05, **kw)
        assert torch.equal(mean, predictor.update_fn(lambda like: z, x, t, y, 0.05, **kw)[1])
    rd = ReverseDiffusionPredictor(sde, analytic_score)
    rd.update_mean(lambda like: pytest.fail("a draw"), x, t, y, 0.05)


# ------------------------------------------------------------------- enhance


@pytest.fixture(scope="module")
def jax_params():
    return random_jax_params(ARCH, seed=5)


def bbed_pair(jax_params, window="hann"):
    """The JAX model and the port's on the same weights."""
    jax_cfg = JaxScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                  window=window, t_eps=3e-2)
    ref = JaxScoreModel(jax_cfg, backbone_kwargs=dict(ARCH, **JAX_FLAGS),
                        sde_kwargs=dict(SDE_KWARGS["bbed"], N=30))
    cfg = ScoreModelConfig(**{f: getattr(jax_cfg, f)
                              for f in ScoreModelConfig.__dataclass_fields__})
    ours = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=dict(SDE_KWARGS["bbed"], N=30),
                      device="cpu")
    ours.backbone.load_state_dict(state_dict_from_jax(jax_params, **ARCH), strict=True)
    return ref, ours


def noisy_wav(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, T_ORIG)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("predictor, corrector, grid, n, window", [
    ("reverse_diffusion", "ald", "logit", 4, "hann"),
    ("heun", "none", "bridge_geom", 4, "hann"),
    ("reverse_diffusion", "ald", "linear", 3, "sqrthann"),
], ids=["rd_ald_logit_N4", "heun_none_bridge_geom_N4", "rd_ald_sqrthann_N3"])
def test_enhance_samplers_match_jax(jax_params, predictor, corrector, grid, n, window):
    """``enhance`` with a grid, a predictor and a window beside the main
    path's: the same NFE, the waveform within 1e-4."""
    ref_model, ours = bbed_pair(jax_params, window)
    y = noisy_wav(n)
    key = jax.random.PRNGKey(11)
    kw = dict(predictor=predictor, corrector=corrector, N=n, timestep_type=grid, timeit=True)
    ref, nfe_ref, _ = ref_model.enhance({"params": jax_params}, y, y, key=key, **kw)
    draws = replay_draws(key, n, SPEC_SHAPE, 0 if corrector == "none" else 1,
                         predictor in STOCHASTIC)
    out, nfe, _ = ours.enhance(y, y, noise=noise_from(draws), **kw)
    assert nfe == nfe_ref == n * (2 if predictor == "heun" or corrector == "ald" else 1)
    assert out.shape == ref.shape == (T_ORIG,)
    assert rel_err(out, ref) < 1e-4


def test_exp_heun_at_the_floor_matches_jax_op_by_op(jax_params):
    """exp_heun's last step reads BBED's std at t = 1e-5, an Ei difference
    ~4e4 times smaller than its terms, which float32 gets a few per cent
    wrong, differently wherever Ei rounds differently. The port's CPU path
    takes the JAX package's operations in its order: it follows the op-by-op
    JAX program within 1e-5, while the jitted JAX program (XLA's fusions)
    strays from both by more (printed); within the 2e-3 that chip_smoke
    holds the card to for these samplers."""
    ref_model, ours = bbed_pair(jax_params)
    y = noisy_wav(3)
    key = jax.random.PRNGKey(11)
    kw = dict(predictor="exp_heun", corrector="none", N=2, timestep_type="logit")
    jitted = ref_model.enhance({"params": jax_params}, y, y, key=key, **kw)
    with jax.disable_jit():
        op_by_op = ref_model.enhance({"params": jax_params}, y, y, key=key, **kw)
    out = ours.enhance(y, y, noise=noise_from(replay_draws(key, 2, SPEC_SHAPE, 0, False)), **kw)
    gaps = rel_err(out, op_by_op), rel_err(jitted, op_by_op)
    print(f"exp_heun + none, logit, N = 2: port vs op-by-op JAX {gaps[0]:.3e}; jitted vs "
          f"op-by-op JAX {gaps[1]:.3e}")
    assert gaps[0] < 1e-5 and gaps[1] < 2e-3


@pytest.mark.parametrize("n_fft", [510, 64])
def test_sqrthann_window_matches_jax(n_fft):
    out = get_window("sqrthann", n_fft)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_get_window("sqrthann", n_fft)))
    np.testing.assert_array_equal(get_window("hann", n_fft).numpy(),
                                  np.asarray(jax_get_window("hann", n_fft)))
    with pytest.raises(NotImplementedError):
        get_window("kaiser", n_fft)


@pytest.mark.parametrize("predictor, corrector, grid", [
    ("heun", "none", "bridge_geom"), ("exp_euler", "ald", "logit"),
    ("exp_heun", "langevin", "logit"), ("euler_maruyama", "langevin", "linear")])
def test_pc_samplers_read_nothing_back(monkeypatch, predictor, corrector, grid):
    """The captured program of each sampler takes no value back to the host:
    heun's Euler fallback is a ``torch.where``, the exponential predictors
    read tabulated stds, langevin's norms stay on the device."""
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS["bbed"], device="cpu",
                       generator=torch.Generator().manual_seed(1))
    y = torch.from_numpy(noisy_wav(9))
    gen = torch.Generator().manual_seed(2)
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__float__", "__bool__", "__int__"):
            m.setattr(torch.Tensor, name, lambda *a, _n=name, **k: pytest.fail(
                f"Tensor.{_n} in the device program"))
        out, nfe = model._enhance_on_device(
            "bbed_pc", lambda like: randn_like(like, gen), 3, predictor, corrector, 1, y=y,
            snr=torch.tensor(0.5), timestep_type=grid)
    assert out.shape == (1, T_ORIG) and torch.isfinite(out).all()
    assert nfe == 3 * (PredictorRegistry.get_by_name(predictor).nfe_per_step
                       + (corrector != "none"))


def test_score_model_samplers_are_the_module_samplers_over_its_score():
    """``ScoreModel.get_pc_sampler`` / ``get_ode_sampler``: the sampling
    module's samplers over the model's score with its ``t_eps``, N replaced;
    with ``minibatch`` the rows in chunks, drawing chunk after chunk."""
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS["bbed"], device="cpu",
                       generator=torch.Generator().manual_seed(3))
    Y = torch.from_numpy(cspec(np.random.default_rng(10), (2,) + SPEC_SHAPE[1:], 0.3))

    def noise():
        gen = torch.Generator().manual_seed(4)
        return lambda like: randn_like(like, gen)

    sde = model.sde.replace(N=2)
    with torch.no_grad():
        out, nfe = model.get_pc_sampler("reverse_diffusion", "ald", Y, noise(), N=2,
                                        timestep_type="logit")()
        ref, nfe_ref = get_pc_sampler("reverse_diffusion", "ald", sde, model.forward, Y, noise(),
                                      eps=cfg.t_eps, timestep_type="logit")()
        assert nfe == nfe_ref == 4 and torch.equal(out, ref)
        chunks, ns = model.get_pc_sampler("reverse_diffusion", "ald", Y, noise(), N=2,
                                          minibatch=1)()
        draw = noise()
        rows = [get_pc_sampler("reverse_diffusion", "ald", sde, model.forward, Y[i:i + 1], draw,
                               eps=cfg.t_eps)()[0] for i in range(2)]
        assert ns == [4, 4] and torch.equal(chunks, torch.cat(rows))
        out, nfev = model.get_ode_sampler(Y[:1], noise())()
        ref, nfev_ref = get_ode_sampler(model.sde, model.forward, Y[:1], noise(),
                                        eps=cfg.t_eps)()
        assert int(nfev) == int(nfev_ref) and torch.equal(out, ref)
