"""The port's captured, host-sync-free ``enhance`` (``capture.Program``,
``ScoreModel._enhance_graph``) and the sync-free main path under it.

On the CPU: each step that no longer waits on the device computes the same
bits as the formulation it replaces (the FIR filters kept on the device, the
SDE's ``dt`` and ``Ei(-2 log k)``, the marginal std for the whole time grid,
the corrector's ``snr`` as a device scalar, the iSTFT without a host check,
the bf16 casts kept); the sampler still agrees with ``diffse_tpu``; the
enhance program reads nothing back to the host; the cache key of a captured
program holds every field of the JAX package's ``_enhance_jit`` key, and a
parameter updated in place invalidates it; what outlives a call is never
made during a capture. The tests marked ``gpu`` run on the card only (they
skip without one): a replay against the eager path on the same generator
state, and ``torch.cuda.set_sync_debug_mode("error")`` through the eager
program and a replay.
"""

import copy
import math
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.sampling import get_pc_sampler as jax_get_pc_sampler
from diffse_tpu.sde import BBED as JaxBBED
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.models import layers, score_model
from diffse_tpu_torch.models.ncsnpp import NCSNpp
from diffse_tpu_torch.models.score_model import EnhanceKey, ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.ops import fir
from diffse_tpu_torch.ops.expi import expi
from diffse_tpu_torch.ops.upfirdn2d import upfirdn2d
from diffse_tpu_torch.sampling import get_pc_sampler, timesteps_space
from diffse_tpu_torch.sampling.correctors import AnnealedLangevinDynamics
from diffse_tpu_torch.sde import BBED
from diffse_tpu_torch.transforms.stft import hann_window, istft
from diffse_tpu_torch.utils import forbid_capture, randn_like

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
ARCH = dict(nf=4, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(16,),
            image_size=256)
BF16_TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
# The smallest NCSN++ the card's kernels take (Cin a multiple of 8 in float32).
GPU_ARCH = dict(nf=16, ch_mult=(1, 1, 1, 1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(16,),
                image_size=256)
HOP = 128


def _cspec(rng, shape, scale=0.3):
    return torch.from_numpy(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                             * scale).astype(np.complex64))


def _equal(a, b):
    return torch.equal(a, b) if torch.is_tensor(a) else all(map(torch.equal, a, b))


# ------------------------------------------------- sync-free steps, bit for bit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up", [True, False], ids=["up", "down"])
def test_fir_kept_filter_equals_the_per_call_filter(dtype, up):
    """The FIR filter made once and kept on the device gives the bits of the
    filter built from numpy and copied on every call, and is made once."""
    x = torch.randn((2, 8, 16, 12), generator=torch.Generator().manual_seed(0)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    k = fir.setup_fir_kernel(layers.FIR_KERNEL) * (4.0 if up else 1.0)
    pad = (2, 1) if up else (1, 1)
    ref = upfirdn2d(x, torch.from_numpy(k), up=2 if up else 1, down=1 if up else 2, pad=pad)
    resample = fir.upsample_2d if up else fir.downsample_2d
    fir._weights.clear()
    out = resample(x, layers.FIR_KERNEL, factor=2)
    kept = list(fir._weights.values())
    again = resample(x, layers.FIR_KERNEL, factor=2)
    assert out.dtype == dtype and torch.equal(out, ref) and torch.equal(again, ref)
    assert len(kept) == 1 and list(fir._weights.values())[0] is kept[0]


@pytest.mark.parametrize("stepsize", [0.033413794, 0.03, 0.0333, 1 / 3])
def test_discretize_host_scalars_equal_the_device_tensor(stepsize):
    """dt as the float32 value of the step and sqrt(dt) as that value's
    float32 root: the bits of the 0-d tensors they replace."""
    rng = np.random.default_rng(1)
    sde = BBED(**SDE_KWARGS)
    x, y = _cspec(rng, (3, 1, 8, 6)), _cspec(rng, (3, 1, 8, 6))
    t = torch.tensor([0.2, 0.5, 0.9], dtype=torch.float32)
    drift, diffusion = sde.sde(x, t, y)
    dt = torch.tensor(stepsize, dtype=torch.float32)
    assert _equal(sde.discretize(x, t, y, stepsize), (drift * dt, diffusion * torch.sqrt(dt)))


def test_std_device_constant_equals_the_copied_tensor():
    """Ei(-2 log k) from a filled 0-d tensor, as from the tensor copied from
    the host before."""
    sde = BBED(**SDE_KWARGS)
    t = torch.linspace(0.03, 0.999, 11)
    logk = sde.logk
    eilog = expi(torch.tensor(-2.0 * logk, dtype=torch.float32))
    eis = expi(2.0 * (t - 1.0) * logk) - eilog
    var = (sde.k ** (2.0 * t) - 1.0 + t) + 2.0 * sde.k ** 2 * logk * (1.0 - t) * eis
    assert torch.equal(sde._std(t), torch.sqrt(var * (1.0 - t) * sde.theta))


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("n_steps", [30, 6])
def test_std_table_equals_each_steps_own_call(batch, n_steps):
    """The marginal std of the whole grid in one call: each entry the bits
    of the step's own call on its [B] time vector, and the grid made on the
    device the same float32 times as the host loop's."""
    sde = BBED(**SDE_KWARGS, N=n_steps)
    ts = timesteps_space(sde.T, n_steps, 0.03)
    t0, delta = torch.tensor(float(ts[0])), float(ts[0] - ts[1])
    times = [t0 - torch.tensor(float(i)) * torch.tensor(delta) for i in range(n_steps)]
    grid = float(t0) - torch.arange(n_steps, dtype=torch.float32) * delta
    assert torch.equal(grid, torch.stack(times))
    table = sde._std(grid)
    for i, t in enumerate(times):
        own = sde._std(torch.full((batch,), float(t)))
        assert torch.equal(table[i].expand(batch), own)


@pytest.mark.parametrize("snr", [0.5, 0.33, 0.17])
def test_corrector_snr_device_scalar_equals_the_float(snr):
    """The corrector's snr as a float32 0-d tensor: the bits of the float."""
    rng = np.random.default_rng(2)
    sde = BBED(**SDE_KWARGS)
    x, y = _cspec(rng, (2, 1, 8, 6)), _cspec(rng, (2, 1, 8, 6))
    t = torch.tensor([0.5, 0.5])
    z = _cspec(rng, (2, 1, 8, 6), 1.0)

    def score(x_, t_, y_):
        return (y_ - x_) * (1.0 + t_[:, None, None, None])

    outs = []
    for s in (snr, torch.tensor(snr, dtype=torch.float32)):
        ald = AnnealedLangevinDynamics(sde, score, snr=s, n_steps=1)
        outs.append(ald.update_fn(lambda like: z, x, t, y, std=sde.marginal_prob(x, t, y)[1]))
    assert _equal(outs[0], outs[1])


def _loop_sampler(sde, score, Y, noise, eps, snr):
    """The sampler as the port ran it before: the time, the marginal std and
    dt made on the device at every step, snr a Python float."""
    ts = timesteps_space(sde.T, sde.N, eps)
    n = len(ts)
    t0, delta = torch.tensor(float(ts[0])), float(ts[0] - ts[1])
    x = Y + noise(Y) * sde._std(torch.full((Y.shape[0],), sde.T))[:, None, None, None]
    x_mean = x
    for i in range(n):
        t = t0 - torch.tensor(float(i)) * torch.tensor(delta)
        stepsize = delta if i < n - 1 else float(ts[-1])
        vec_t = torch.full((Y.shape[0],), float(t))
        std = sde._std(vec_t)
        grad, z = score(x, vec_t, Y), noise(x)
        step = (snr * std) ** 2 * 2
        x_mean = x + step[:, None, None, None] * grad
        x = x_mean + z * torch.sqrt(step * 2)[:, None, None, None]
        drift, diffusion = sde.sde(x, vec_t, Y)
        dt = torch.tensor(stepsize, dtype=torch.float32)
        f, g = drift * dt, diffusion * torch.sqrt(dt)
        f = f - (g ** 2)[:, None, None, None] * score(x, vec_t, Y)
        z = noise(x)
        x_mean = x - f
        x = x_mean + g[:, None, None, None] * z
    return x_mean


@pytest.mark.parametrize("batch", [1, 3])
def test_pc_sampler_equals_the_per_step_loop(batch):
    """The whole sync-free sampler, bit for bit the loop it replaces."""
    rng = np.random.default_rng(3)
    Y = _cspec(rng, (batch, 1, 16, 8), 0.5)
    sde = BBED(**SDE_KWARGS, N=8)

    def score(x, t, y):
        return (y - x) * (1.0 + t[:, None, None, None])

    def noise_source():
        g = torch.Generator().manual_seed(4)
        return lambda like: randn_like(like, g)

    ref = _loop_sampler(sde, score, Y, noise_source(), 0.03, 0.5)
    out, nfe = get_pc_sampler("reverse_diffusion", "ald", sde, score, Y, noise_source(),
                              eps=0.03, snr=0.5)()
    assert nfe == 16 and torch.equal(out, ref)


@pytest.mark.parametrize("snr", [0.5, 0.33])
def test_pc_sampler_with_snr_tensor_matches_jax(snr):
    """A float32 0-d ``snr`` still gives the JAX sampler's result (the
    tolerance of test_torch_enhance.py::test_pc_sampler_matches_jax)."""
    rng = np.random.default_rng(5)
    shape = (2, 1, 16, 8)
    y = _cspec(rng, shape, 0.5).numpy()
    sde_ref = JaxBBED(**SDE_KWARGS, N=6)

    def score(x, t, y_):
        return (y_ - x) * (1.0 + t[:, None, None, None])

    key = jax.random.PRNGKey(6)
    ref, _ = jax_get_pc_sampler("reverse_diffusion", "ald", sde_ref, score, jnp.asarray(y),
                                snr=snr, eps=0.03)(key)
    dummy = jnp.zeros(shape, jnp.complex64)
    prior_key, k = jax.random.split(key)
    draws = [np.asarray(jax_randn_like(prior_key, dummy))]
    for _ in range(6):
        k, kc, kp = jax.random.split(k, 3)
        draws += [np.asarray(jax_randn_like(jax.random.fold_in(kc, 0), dummy)),
                  np.asarray(jax_randn_like(kp, dummy))]
    it = iter(draws)
    out, _ = get_pc_sampler("reverse_diffusion", "ald", BBED(**SDE_KWARGS, N=6), score,
                            torch.from_numpy(y), lambda like: torch.from_numpy(np.array(next(it))),
                            snr=torch.tensor(snr, dtype=torch.float32), eps=0.03)()
    ref = np.asarray(ref)
    assert float(np.max(np.abs(out.numpy() - ref)) / np.max(np.abs(ref))) < 1e-5


@pytest.mark.parametrize("shape", [(1, 256, 64), (2, 256, 128), (3, 1, 256, 7)])
def test_istft_equals_torch_istft(shape):
    """The iSTFT without its host check: torch.istft's bits."""
    spec = _cspec(np.random.default_rng(7), shape, 1.0)
    window = hann_window(510)
    flat = spec.reshape((-1,) + shape[-2:])
    ref = torch.istft(flat, n_fft=510, hop_length=HOP, window=window, center=True)
    out = istft(spec, window, 510, HOP)
    assert out.shape == shape[:-2] + (HOP * (shape[-1] - 1),)
    assert torch.equal(out.reshape(ref.shape), ref)


def test_istft_checks_the_envelope_on_the_device():
    spec = _cspec(np.random.default_rng(8), (1, 256, 8), 1.0)
    with pytest.raises(RuntimeError, match="envelope"):
        istft(spec, torch.zeros(510), 510, HOP)


def test_residual_divisor_is_sqrt2_in_the_dtype():
    assert layers._sqrt2(torch.bfloat16) == 1.4140625
    assert layers._sqrt2(torch.float32) == float(np.float32(math.sqrt(2.0)))
    x = torch.randn(4, 3).bfloat16()
    ref = (x + x) / float(torch.tensor(math.sqrt(2.0), dtype=torch.bfloat16))
    assert torch.equal(layers.residual(x, x), ref)


def test_bf16_forward_casts_once_and_repeats_bit_for_bit():
    """The bf16 trunk casts its cuDNN convs' and dense layers' parameters in
    its first forward and in none after, with the same output; an in-place
    update of one weight casts that module again."""
    model = NCSNpp(**BF16_TINY, dtype="bf16", generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(9)
    x = _cspec(rng, (1, 2, 16, 16), 1.0)
    t = torch.tensor([0.5])
    with torch.no_grad():
        ck.reset_launch_counts()
        first = model(x, t)
        casts = dict(ck.weight_casts)
        ck.reset_launch_counts()
        second = model(x, t)
        assert casts["conv"] > 0 and casts["dense"] > 0
        assert ck.weight_casts["conv"] == ck.weight_casts["dense"] == 0
        assert torch.equal(first, second)
        stem = next(m for m in model.all_modules if isinstance(m, torch.nn.Conv2d))
        stem.weight.add_(0.0)
        model(x, t)
        assert ck.weight_casts["conv"] == 1 and ck.weight_casts["dense"] == 0


def test_enhance_program_reads_nothing_back(monkeypatch):
    """The device part of every branch of enhance (what a capture records)
    takes no value back to the host: no ``.item()``, ``float()``, ``bool()``
    or ``.tolist()`` of a tensor, no ``.cpu()`` or ``.numpy()``."""
    cases = [("bbed", "false", "ncsnpp"), ("sebridge", "false", "ncsnpp"),
             ("sebridge_v2", "false", "ncsnpp"), ("sebridge_v3", "true", "ncsnpp"),
             ("sebridge_v2", "true", "ncsnpp_snr")]
    rng = np.random.default_rng(10)
    y = torch.from_numpy((0.1 * rng.standard_normal((1, 63 * HOP))).astype(np.float32))
    for model_type, snr_conditioned, backbone in cases:
        cfg = ScoreModelConfig(backbone=backbone, sde="bbed", model_type=model_type,
                               snr_conditioned=snr_conditioned, fixed_snr=0.17783)
        model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=dict(SDE_KWARGS, N=2),
                           device="cpu", generator=torch.Generator().manual_seed(1))
        branch = model._branch()
        scalars = dict(bbed_pc=dict(snr=0.5), sebridge_v3_snr=dict(t_hat=0.3, normfac=1.2),
                       sebridge_v2_snr=dict(normfac=1.2)).get(branch, {})
        tensors = {k: torch.tensor(v, dtype=torch.float32) for k, v in scalars.items()}
        if branch == "sebridge_v2_snr":
            tensors["x"] = y * 0.5
        gen = torch.Generator().manual_seed(2)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__float__", "__bool__", "__int__"):
                m.setattr(torch.Tensor, name, lambda *a, _n=name, **k: pytest.fail(
                    f"{branch}: Tensor.{_n} in the device program"))
            out, nfe = model._enhance_on_device(branch, lambda like: randn_like(like, gen), 2,
                                                "reverse_diffusion", "ald", 1, y=y, **tensors)
        assert out.shape == (1, 63 * HOP) and torch.isfinite(out).all()
        assert nfe == (4 if branch == "bbed_pc" else 1)


# ------------------------------------------------------- the captured program


def _jax_cache_key_fields():
    """The names in ``_enhance_jit``'s cache key, read from the JAX package's
    source (importing it needs flax)."""
    src = (REPO / "diffse_tpu" / "models" / "score_model.py").read_text()
    body = src[src.index("def _enhance_jit"):]
    names = re.search(r"cache_key = \(([^)]*)\)", body).group(1)
    return [n.strip() for n in names.split(",") if n.strip()]


def test_graph_key_holds_every_field_of_enhance_jit():
    fields = _jax_cache_key_fields()
    assert {"branch", "t_pad", "n_steps", "oracle", "corrector_steps"} <= set(fields)
    assert set(fields) <= set(EnhanceKey._fields)
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu")
    key = model._graph_key("bbed_pc", 128, 30, "reverse_diffusion", "ald", 1, False, batch=1)
    assert (key.branch, key.t_pad, key.n_steps, key.predictor, key.corrector,
            key.corrector_steps, key.oracle, key.mesh_key, key.timestep_type) == (
        "bbed_pc", 128, 30, "reverse_diffusion", "ald", 1, False, None, "linear")
    assert (key.batch, key.dtype, key.device) == (1, torch.float32, torch.device("cpu"))
    others = [model._graph_key("bbed_pc", 192, 30, "reverse_diffusion", "ald", 1, False, 1),
              model._graph_key("bbed_pc", 128, 20, "reverse_diffusion", "ald", 1, False, 1),
              model._graph_key("bbed_pc", 128, 30, "reverse_diffusion", "none", 1, False, 1),
              model._graph_key("bbed_pc", 128, 30, "reverse_diffusion", "ald", 2, False, 1),
              model._graph_key("bbed_pc", 128, 30, "reverse_diffusion", "ald", 1, False, 2)]
    assert len({key, *others}) == 6
    bf16 = ScoreModel(cfg, backbone_kwargs=dict(ARCH, dtype="bf16"), sde_kwargs=SDE_KWARGS,
                      device="cpu")
    assert bf16._graph_key("bbed_pc", 128, 30, "reverse_diffusion", "ald", 1, False,
                           1).dtype == torch.bfloat16


class _FakeProgram:
    """Stands for capture.Program on the CPU: counts the captures."""

    made = 0

    def __init__(self, fn, inputs, device):
        type(self).made += 1
        self.fn, self.inputs = fn, inputs


def test_graph_cache_recaptures_when_a_parameter_changes(monkeypatch):
    """One capture per key; moving on with the same parameters reuses it; an
    in-place update (``_version``), ``load_state_dict`` or another key
    captures anew."""
    monkeypatch.setattr(score_model, "Program", _FakeProgram)
    _FakeProgram.made = 0
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu")
    inputs = {"y": torch.zeros(1, 63 * HOP), "snr": 0.5}
    args = ("bbed_pc", 64, 30, "reverse_diffusion", "ald", 1, False)
    first = model._enhance_graph(*args, inputs)
    assert model._enhance_graph(*args, inputs) is first and _FakeProgram.made == 1
    assert [key.batch for key in model._graphs] == [1]
    with torch.no_grad():
        next(model.backbone.parameters()).add_(0.0)
    second = model._enhance_graph(*args, inputs)
    assert second is not first and _FakeProgram.made == 2
    model.backbone.load_state_dict(copy.deepcopy(model.backbone.state_dict()))
    assert model._enhance_graph(*args, inputs) is not second and _FakeProgram.made == 3
    model._enhance_graph("bbed_pc", 128, 30, "reverse_diffusion", "ald", 1, False, inputs)
    assert _FakeProgram.made == 4 and len(model._graphs) == 2


def test_enhance_on_the_card_takes_the_captured_program(monkeypatch):
    """With noise from a generator, enhance on the card replays the branch's
    program (here a stand-in that runs it on the CPU), which computes what
    the eager path computes; on the CPU it runs eagerly."""
    calls = []

    class Replay(_FakeProgram):
        def __call__(self, generator, **inputs):
            calls.append(sorted(inputs))
            tensors = {k: v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float32)
                       for k, v in inputs.items()}
            return self.fn(generator, **tensors)

    monkeypatch.setattr(score_model, "Program", Replay)
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed")
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    y = (0.1 * np.random.default_rng(11).standard_normal((1, 63 * HOP))).astype(np.float32)
    eager = model.enhance(y, y, generator=torch.Generator().manual_seed(4), N=2)
    assert calls == []
    model.device = torch.device("cuda")  # only the dispatch reads it
    g = torch.Generator().manual_seed(4)
    graphed = model.enhance(y, y, generator=g, N=2)
    assert calls == [["snr", "y"]] and np.array_equal(graphed, eager)


# ------------------------------------------- nothing persistent inside a capture


@pytest.fixture
def capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)


def test_forbid_capture_raises_only_for_a_capturing_card(monkeypatch, capturing):
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        forbid_capture(torch.device("cuda", 0), "a cache")
    forbid_capture(torch.device("cpu"), "a cache")  # never asks on the CPU
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    forbid_capture(torch.device("cuda", 0), "a cache")


def test_ticket_counters_are_made_before_a_capture(monkeypatch, capturing):
    """The statistics pass's counters: made before a capture (by the warm-up
    run on the capture's stream); a wrapper that would make them (or grow
    them) during one raises, and uses them as they are otherwise."""
    cuda0, stream = torch.device("cuda", 0), 987654321
    monkeypatch.setattr(ck, "_tickets", {})
    with pytest.raises(RuntimeError, match="ticket counters"):
        ck._ticket_counters(cuda0, stream, 16)
    ck._tickets[(0, stream)] = made = torch.zeros(64, dtype=torch.int32)
    assert ck._ticket_counters(cuda0, stream, 16) is made
    assert ck._ticket_counters(cuda0, stream, 64) is made
    with pytest.raises(RuntimeError, match="ticket counters"):
        ck._ticket_counters(cuda0, stream, 65)


def test_grown_ticket_counters_keep_the_old_ones(monkeypatch):
    """Programs share their capture stream, so a later warm-up at a larger
    batch grows that stream's counters: the old ones, which an earlier
    program's graph holds, stay allocated."""
    cpu, stream = torch.device("cpu"), 123456789
    monkeypatch.setattr(ck, "_tickets", {})
    monkeypatch.setattr(ck, "_retired_tickets", [])
    small = ck._ticket_counters(cpu, stream, 16)
    assert small.numel() == 64 and ck._ticket_counters(cpu, stream, 64) is small
    large = ck._ticket_counters(cpu, stream, 65)
    assert large.numel() == 65 and ck._retired_tickets == [small]
    assert ck._ticket_counters(cpu, stream, 1) is large


def test_fir_filter_and_cast_weights_are_not_made_in_a_capture(capturing):
    fake_x = types.SimpleNamespace(shape=(1, 8, 4, 4), dtype=torch.float32,
                                   device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="FIR filter"):
        fir._fir_weight(layers.FIR_KERNEL, 1.0, 2, True, fake_x)

    class CardParam:
        device = torch.device("cuda", 0)
        _version = 0
        requires_grad = False  # the cached cast is for weights autograd does not record

        def data_ptr(self):
            return 4096

    conv = types.SimpleNamespace(weight=CardParam(), bias=CardParam())
    with pytest.raises(RuntimeError, match="cast weight"):
        layers.cast_params(conv, torch.bfloat16)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_model(cuda, model_type="bbed", snr_conditioned="false", **kw):
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type=model_type,
                           snr_conditioned=snr_conditioned, fixed_snr=0.17783, sigma_max=0.5)
    return ScoreModel(cfg, backbone_kwargs=dict(GPU_ARCH, **kw), sde_kwargs=dict(SDE_KWARGS, N=4),
                      device=cuda, generator=torch.Generator().manual_seed(5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_graphed_enhance_matches_eager_on_the_card(cuda, dtype):
    """A replay against the eager path from the same generator state: the
    same waveform, the generator left where the eager path leaves it, the
    launch counts made at capture only."""
    model = _card_model(cuda, dtype=dtype)
    rng = np.random.default_rng(12)
    for samples in (63 * HOP, 100 * HOP):
        y = (0.1 * rng.standard_normal((1, samples))).astype(np.float32)
        ge, gg = (torch.Generator(cuda).manual_seed(6) for _ in range(2))
        ck.reset_launch_counts()
        eager = model.enhance(y, y, noise=lambda like: randn_like(like, ge), N=4)
        eager_counts = dict(ck.launch_counts)
        graphed = model.enhance(y, y, generator=gg, N=4)
        assert np.max(np.abs(graphed - eager)) <= 1e-6 * np.max(np.abs(eager))
        assert torch.equal(ge.get_state(), gg.get_state())
        ck.reset_launch_counts()
        again = model.enhance(y, y, generator=torch.Generator(cuda).manual_seed(6), N=4)
        assert np.array_equal(again, graphed) and not any(ck.launch_counts.values())
        program = [prog for key, (_, prog) in model._graphs.items()
                   if key.t_pad == 1 + samples // HOP + (-(1 + samples // HOP)) % 64][0]
        assert program.launch_counts == eager_counts and eager_counts["gn_silu_conv3x3"] > 0
        assert not any(program.weight_casts.values())
        assert program.capture_seconds > 0


@pytest.mark.gpu
def test_enhance_never_syncs_on_the_card(cuda):
    """``torch.cuda.set_sync_debug_mode("error")`` through the eager device
    program and through a replay (the final copy to the host is outside)."""
    model = _card_model(cuda)
    y = torch.from_numpy((0.1 * np.random.default_rng(13).standard_normal((1, 63 * HOP)))
                         .astype(np.float32))
    gen = torch.Generator(cuda).manual_seed(7)
    program = model._enhance_graph("bbed_pc", 64, 4, "reverse_diffusion", "ald", 1, False,
                                   {"y": y, "snr": 0.5})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            tensors = {"y": y.pin_memory().to(cuda, non_blocking=True),
                       "snr": torch.full((), 0.5, device=cuda)}
            eager, _ = model._enhance_on_device("bbed_pc", lambda like: randn_like(like, gen), 4,
                                                "reverse_diffusion", "ald", 1, **tensors)
            graphed, _ = program(torch.Generator(cuda).manual_seed(7), y=y, snr=0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(eager, graphed)
