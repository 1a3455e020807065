"""The port's RK45 solver, probability-flow ODE sampler and ``bbed_ode``
enhance against the JAX package, and the captured loop around them.

The solvers take the same float32 steps in another order of operations, so
an accept/reject decision at an error norm near 1 could flip between them;
on these problems and seeds none does: ``nfev`` and ``status`` are equal,
the states within 1e-5 (max |diff| / max |ref|; 1e-3 where the solve stops
at ``max_steps``, ``STOPPED_EARLY_TOL``), and ``enhance`` within 1e-4 as
every enhance test. Once the solver is done an attempt changes
nothing, so 1, 4 or 16 attempts between two reads of ``done`` give the same
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.sampling import get_ode_sampler as jax_get_ode_sampler
from diffse_tpu.sampling.ode import solve_ivp_rk45 as jax_solve_ivp_rk45
from diffse_tpu.sde import BBED as JaxBBED
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch import capture
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import score_model
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.sampling import get_ode_sampler
from diffse_tpu_torch.sampling.ode import solve_ivp_rk45
from diffse_tpu_torch.sde import BBED
from diffse_tpu_torch.utils import randn_like
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

# three levels (the JAX package's tiny NCSN++ has five): every kind of block,
# attention at the deepest, and a shorter compile of the JAX program
ARCH = dict(nf=4, ch_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(64,),
            image_size=256)
JAX_FLAGS = dict(use_pallas_groupnorm=True, fuse_pyramid=True)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
HOP = 128
T_ORIG = 63 * HOP
SPEC_SHAPE = (1, 1, 256, 64)


def rel_err(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    return float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))


def cspec(rng, shape, scale):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


def analytic_score(x, t, y):
    return (y - x) * (1.0 + t[:, None, None, None])


def bridge_flow(sde, y):
    """The BBED probability flow on the analytic score, as ``f(t, x)``."""
    rsde = sde.reverse(analytic_score, probability_flow=True)

    def f(t, x):
        vec_t = t * (jnp.ones((x.shape[0],), jnp.float32) if isinstance(x, jax.Array)
                     else torch.ones(x.shape[0]))
        return rsde.sde(x, vec_t, y)[0]

    return f


def _problems():
    rng = np.random.default_rng(0)
    lam = (-rng.uniform(1, 3, (4, 8)) + 1j * rng.uniform(2, 5, (4, 8))).astype(np.complex64)
    y0 = cspec(rng, (4, 8), 1.0)
    cond = cspec(rng, (2, 1, 8, 6), 0.5)
    x0 = cond + cspec(rng, (2, 1, 8, 6), 0.05)
    linear = (lambda lam_: lambda t, y: lam_ * y)
    return {
        # a complex linear ODE, forward and backward in time: y0 exp(lam dt)
        "linear_forward": (linear, lam, (0.0, 1.0), y0, {}),
        "linear_backward": (linear, lam, (1.0, 0.0), y0, {}),
        # the bridge's probability flow from eps up to T: stiff at t -> 1
        "bridge": ("bridge", cond, (0.03, 0.999), x0, {}),
        # a jump of 1e12 just after t0: every step is rejected until the step
        # size underflows (status 1)
        "underflow": ((lambda c: lambda t, y: y * 0 + (t > c) * 1e12), 0.0, (0.0, 1.0), y0, {}),
        # max_steps reached first
        "max_steps": (linear, lam, (0.0, 1.0), y0, dict(max_steps=3)),
    }


# The solve stops short of t1 (max_steps) at a time that is the sum of the
# step sizes, and each step size follows the error estimate, a sum that
# cancels to ~1e-4 of its terms, so float32 rounding moves it by ~1e-3
# relative in either package: y there is compared to 1e-3.
STOPPED_EARLY_TOL = 1e-3


PROBLEMS = _problems()


def _rhs(name, framework):
    make, arg, _, _, _ = PROBLEMS[name]
    if make == "bridge":
        if framework == "jax":
            return bridge_flow(JaxBBED(**SDE_KWARGS), jnp.asarray(arg))
        return bridge_flow(BBED(**SDE_KWARGS), torch.from_numpy(arg))
    if isinstance(arg, np.ndarray):
        arg = jnp.asarray(arg) if framework == "jax" else torch.from_numpy(arg)
    return make(arg)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_rk45_matches_jax(name):
    _, _, t_span, y0, kw = PROBLEMS[name]
    ref = jax_solve_ivp_rk45(_rhs(name, "jax"), t_span, jnp.asarray(y0), **kw)
    out = solve_ivp_rk45(_rhs(name, "torch"), t_span, torch.from_numpy(y0), **kw)
    assert out.y.dtype == torch.complex64 and out.nfev.dtype == torch.int32
    assert int(out.nfev) == int(ref.nfev) and int(out.status) == int(ref.status)
    assert rel_err(out.y.numpy(), ref.y) < (STOPPED_EARLY_TOL if name == "max_steps" else 1e-5)
    expected_status = 1 if name == "underflow" else 0
    assert int(out.status) == expected_status
    if name == "max_steps":
        assert int(out.nfev) == 2 + 6 * 3
    if name.startswith("linear"):
        lam = PROBLEMS[name][1]
        exact = y0 * np.exp(lam * (t_span[1] - t_span[0]))
        assert rel_err(out.y.numpy(), exact) < 1e-3


@pytest.mark.parametrize("name", ["bridge", "linear_backward", "underflow"])
def test_frozen_attempts_change_nothing(name):
    """Attempts after ``done`` leave the state as it was: 1, 4 and 16
    attempts between two reads give the same bits."""
    _, _, t_span, y0, kw = PROBLEMS[name]
    results = [solve_ivp_rk45(_rhs(name, "torch"), t_span, torch.from_numpy(y0),
                              attempts_per_read=k, **kw) for k in (1, 4, 16)]
    for other in results[1:]:
        assert torch.equal(other.y, results[0].y)
        assert int(other.nfev) == int(results[0].nfev)
        assert int(other.status) == int(results[0].status)


def jax_ode_draws(key, shape=SPEC_SHAPE):
    """The JAX ODE sampler's draws: the prior's, then the denoising step's."""
    prior_key, denoise_key = jax.random.split(key)
    dummy = jnp.zeros(shape, jnp.complex64)
    return [np.array(jax_randn_like(k, dummy)) for k in (prior_key, denoise_key)]


def noise_from(draws):
    it = iter(draws)

    def noise(like):
        z = torch.from_numpy(next(it))
        assert tuple(z.shape) == tuple(like.shape)
        return z.to(like.device)

    noise.left = lambda: sum(1 for _ in it)
    return noise


@pytest.mark.parametrize("options", [{}, dict(denoise=False), dict(Y_prior=True)],
                         ids=["default", "no_denoise", "y_prior"])
def test_ode_sampler_matches_jax(options):
    rng = np.random.default_rng(1)
    shape = (2, 1, 16, 8)
    y = cspec(rng, shape, 0.5)
    y_prior = cspec(rng, shape, 0.5) if options.get("Y_prior") else None
    denoise = options.get("denoise", True)
    key = jax.random.PRNGKey(2)
    ref, nfev_ref = jax_get_ode_sampler(
        JaxBBED(**SDE_KWARGS), analytic_score, jnp.asarray(y),
        Y_prior=None if y_prior is None else jnp.asarray(y_prior), denoise=denoise)(key)
    draws = jax_ode_draws(key, shape)
    noise = noise_from(draws if denoise else draws[:1])
    out, nfev = get_ode_sampler(
        BBED(**SDE_KWARGS), analytic_score, torch.from_numpy(y), noise,
        Y_prior=None if y_prior is None else torch.from_numpy(y_prior), denoise=denoise)()
    assert noise.left() == 0
    assert int(nfev) == int(nfev_ref) > 8
    assert rel_err(out.numpy(), ref) < 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return random_jax_params(ARCH, seed=5)


def bbed_pair(jax_params):
    jax_cfg = JaxScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed", t_eps=3e-2)
    ref = JaxScoreModel(jax_cfg, backbone_kwargs=dict(ARCH, **JAX_FLAGS),
                        sde_kwargs=dict(SDE_KWARGS, N=30))
    cfg = ScoreModelConfig(**{f: getattr(jax_cfg, f)
                              for f in ScoreModelConfig.__dataclass_fields__})
    ours = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=dict(SDE_KWARGS, N=30),
                      device="cpu")
    ours.backbone.load_state_dict(state_dict_from_jax(jax_params, **ARCH), strict=True)
    return ref, ours


def noisy_wav(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, T_ORIG)) * 0.1).astype(np.float32)


def test_enhance_bbed_ode_matches_jax(jax_params):
    """``sampler_type="ode"`` on the tiny NCSN++: the JAX package's nfev, the
    waveform within 1e-4."""
    ref_model, ours = bbed_pair(jax_params)
    y = noisy_wav(1)
    key = jax.random.PRNGKey(7)
    ref, nfev_ref, _ = ref_model.enhance({"params": jax_params}, y, y, key=key,
                                         sampler_type="ode", timeit=True)
    noise = noise_from(jax_ode_draws(key))
    out, nfev, _ = ours.enhance(y, y, noise=noise, sampler_type="ode", timeit=True)
    assert noise.left() == 0
    assert nfev == nfev_ref and (nfev - 2) % 6 == 0
    assert out.shape == ref.shape == (T_ORIG,)
    assert rel_err(out, ref) < 1e-4


def _tiny_bbed(seed=3):
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-zero weights, so that the network steers the flow
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.backbone.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def test_ode_parts_read_nothing_back(monkeypatch):
    """The three parts of ``bbed_ode`` (what the captured programs record)
    take no value back to the host."""
    model = _tiny_bbed()
    y = torch.from_numpy(noisy_wav(2))
    gen = torch.Generator().manual_seed(4)
    noise = lambda like: randn_like(like, gen)  # noqa: E731
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__float__", "__bool__", "__int__"):
            m.setattr(torch.Tensor, name, lambda *a, _n=name, **k: pytest.fail(
                f"Tensor.{_n} in the device program"))
        carry = model._ode_start(noise, 30, y)
        for _ in range(3):
            carry = model._ode_attempt(30, carry)
        out = model._ode_finish(noise, 30, carry)
    assert out.shape == (1, T_ORIG) and torch.isfinite(out).all()
    assert carry["flags"].tolist() == [0, 2 + 6 * 3, 3, 0]


class EagerProgram:
    """Stands for capture.Program on the CPU: a warm-up run, then each call
    runs the function again, as a replay runs its graph."""

    def __init__(self, fn, inputs, device):
        self.fn, self.replays = fn, 0
        fn(torch.Generator(), **inputs)  # the warm-up

    def __call__(self, generator, **inputs):
        self.replays += 1
        return self.fn(generator, **inputs)


@pytest.fixture(scope="module")
def captured_loop():
    """``bbed_ode`` of one utterance on the tiny model, eagerly and then
    through its ``LoopProgram`` (here on stand-in programs that run eagerly
    on the CPU): its capture and first run, which reads the flags after
    every attempt. Yields the runner, the program, and the eager and first
    results; the stand-ins stay in place until the module's tests end."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(capture, "Program", EagerProgram)
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        model = _tiny_bbed()
        y = noisy_wav(3)

        def run():
            return model.enhance(y, y, generator=torch.Generator().manual_seed(5),
                                 sampler_type="ode", timeit=True)[:2]

        eager, nfev = run()
        model.device = torch.device("cuda")  # only the dispatch and the capture check read it
        mp.setattr(score_model, "Program", EagerProgram)
        first, _ = run()  # captures, then runs once reading after every attempt
        key = model._graph_key("bbed_ode", 64, 30, "reverse_diffusion", "ald", 1, False, batch=1)
        program = model._graphs[key][1]
        yield run, program, (eager, nfev), first


@pytest.mark.parametrize("steps_per_read", [1, 3])
def test_captured_ode_loop_equals_eager(captured_loop, steps_per_read):
    """``bbed_ode`` through its ``LoopProgram``: the eager path's waveform
    and nfev, one read of the flags per ``steps_per_read`` attempts, and the
    same result whatever that number (each case one run of the program
    captured once, ``captured_loop``)."""
    run, program, (eager, nfev), first = captured_loop
    assert isinstance(program, capture.LoopProgram) and np.array_equal(first, eager)
    before = program.step.replays, program.start.replays, program.finish.replays
    program.steps_per_read = steps_per_read
    graphed, nfev_graphed = run()
    assert np.array_equal(graphed, eager) and nfev_graphed == nfev > 8
    done, flags_nfev, attempts, status = program.flags
    assert done == 1 and flags_nfev == nfev and status == 0 and nfev == 2 + 6 * attempts
    reads = -(-attempts // steps_per_read)
    assert program.reads == reads
    # the capture's first run replayed the step once an attempt, this one
    # steps_per_read times a read; start and finish once a run
    assert before == (attempts, 1, 1)
    assert program.step.replays - before[0] == reads * steps_per_read
    assert program.start.replays - before[1] == program.finish.replays - before[2] == 1
    program.step.replays, program.start.replays, program.finish.replays = before
