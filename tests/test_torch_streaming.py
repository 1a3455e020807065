"""The port's eval harness core and streaming engines against the JAX
package: ``spec_sample`` over the 7 eval branches, ``eval_enhance_file``,
``enhance_streamed``, ``enhance_streamed_spec`` and the packed fleet engine
``enhance_streamed_packed``, on identical weights (the bridge) and the JAX
package's own draws, fed to the port through its ``noise`` callable in the
port's draw order. Waveforms and spectrograms must agree to a relative error
below 1e-4 (the bound of tests/test_torch_enhance.py).

The JAX models here run the NCSN++ through its plain path (flax's GroupNorm
and convs, no Pallas flags), which compiles faster on the CPU; the Pallas
path is held to the port by tests/test_torch_enhance.py and the kernel
tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.evaluation import inference as jax_inference
from diffse_tpu.evaluation import streaming as jax_streaming
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.evaluation import inference, streaming
from diffse_tpu_torch.utils import generator_noise
import test_torch_enhance
from test_torch_enhance import ARCH, FIXED_SNR, _model_pair, noise_from, replay_pc_draws
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

REL_TOL = 1e-4
LENGTHS = [11000, 30000, 7000, 22000]  # 2, 4, 1 and 3 chunks of 64 frames at overlap 2
CHUNK = 64
F_BINS = 256
# each eval branch's model: (snr_conditioned, model_type, sigma_max, backbone)
BRANCH_MODELS = {
    "bbed": ("false", "bbed", 0.5, "ncsnpp"),
    "sebridge": ("false", "sebridge", 0.5, "ncsnpp"),
    "sebridge_v2": ("false", "sebridge_v2", 1.0, "ncsnpp"),
    "sebridge_v2_fixed": ("fixed", "sebridge_v2", 0.5, "ncsnpp"),
    "sebridge_v3_fixed": ("fixed", "sebridge_v3", 1.0, "ncsnpp"),
    "sebridge_v2_snr": ("true", "sebridge_v2", 0.5, "ncsnpp_snr"),
    "sebridge_v3_snr": ("true", "sebridge_v3", 1.0, "ncsnpp"),
}
# SNR estimates inside the Karras grid (est / (10^0.25 * FIXED_SNR) in (0.001, 1))
EST_SNRS = [0.12, 0.3, 0.05, 0.2]


def _rel_err(out, ref):
    return float(np.max(np.abs(np.asarray(out) - np.asarray(ref))) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def models():
    """The JAX model and the port's of each branch on the same random
    weights, made on first use; ``models(branch) -> (ref, ours, variables)``."""
    params = {False: random_jax_params(ARCH, seed=5), True: random_jax_params(ARCH, seed=6,
                                                                              snr=True)}
    made = {}

    def get(branch):
        if branch not in made:
            snr_conditioned, model_type, sigma_max, backbone = BRANCH_MODELS[branch]
            p = params[backbone == "ncsnpp_snr"]
            with pytest.MonkeyPatch.context() as mp:  # the JAX package's plain path
                mp.setattr(test_torch_enhance, "JAX_FLAGS", {})
                ref, ours = _model_pair(p, model_type, sigma_max,
                                        snr_conditioned=snr_conditioned, backbone=backbone)
            made[branch] = (ref, ours, {"params": p})
        return made[branch]

    return get


def keyed_noise(keys):
    """The JAX draws ``randn_like(key, like)`` of the 1-NFE branches, one
    per key in turn, shaped like what the port asks for."""
    it = iter(keys)

    def noise(like):
        z = jax_randn_like(next(it), jnp.zeros(tuple(like.shape), jnp.complex64))
        return torch.from_numpy(np.array(z)).to(like.device)

    return noise


def _wavs(seed, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths)) / 16000
    clean = 0.3 * np.sin(2 * np.pi * 190 * t) * (0.2 + np.abs(np.sin(2 * np.pi * 3 * t)))
    return [(clean[:n] + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _cspec(rng, shape, scale):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


# ------------------------------------------------------------ host geometry


@pytest.mark.parametrize("chunk_len,overlap,position", [
    (100, 20, "first"), (100, 20, "mid"), (100, 20, "last"), (100, 20, "only"),
    (8064, 2048, "mid"), (50, 0, "mid")])
def test_crossfade_weights_match_jax(chunk_len, overlap, position):
    np.testing.assert_array_equal(
        streaming._crossfade_weights(chunk_len, overlap, position),
        jax_streaming._crossfade_weights(chunk_len, overlap, position))


@pytest.mark.parametrize("n,chunk,overlap", [(1, 64, 2), (2, 64, 2), (4, 64, 16), (3, 128, 0)])
def test_frame_crossfade_weights_match_jax(n, chunk, overlap):
    w = streaming._frame_crossfade_weights(n, chunk, overlap)
    np.testing.assert_array_equal(w, jax_streaming._frame_crossfade_weights(n, chunk, overlap))
    # adjacent chunks' ramps sum to 1 over the overlap
    if n > 1 and overlap:
        np.testing.assert_allclose(w[0, -overlap:] + w[1, :overlap], 1.0, atol=1e-6)


@pytest.mark.parametrize("t_orig", [1, 7000, 7936, 8064, 30000, 160000])
def test_packed_geometry_matches_jax(t_orig):
    for chunk, overlap in ((64, 2), (128, 16)):
        assert streaming._packed_geometry(t_orig, 128, chunk, overlap) == \
            jax_streaming._packed_geometry(t_orig, 128, chunk, overlap)


# ------------------------------------------------------------- spec_sample


def _branch_draws(branch, key, shape, n_steps=30):
    """The draws ``spec_sample`` takes from ``key`` on one batch of ``shape``."""
    if branch == "bbed":
        return replay_pc_draws(key, n_steps, shape)
    if branch == "sebridge":
        return []
    return [np.asarray(jax_randn_like(key, jnp.zeros(shape, jnp.complex64)))]


@pytest.mark.parametrize("branch", inference.BRANCHES)
def test_spec_sample_matches_jax(models, branch):
    """Each eval branch on a batch of two compressed spectrograms: the
    reference sampler for bbed (30 PC steps), t = 1.0 for sebridge_v2, the
    per-row noise size of sebridge_v2_fixed, calculate_snr_direct for the
    _snr branches and the per-row Karras snap of sebridge_v3_snr."""
    ref_model, ours, variables = models(branch)
    rng = np.random.default_rng(3)
    shape = (2, 1, F_BINS, CHUNK)
    X, Y = _cspec(rng, shape, 0.2), _cspec(rng, shape, 0.3)
    est = np.asarray(EST_SNRS[:2], np.float32)
    noise_size = np.max(np.abs(X - Y), axis=(1, 2, 3), keepdims=True) * np.asarray(
        [1.0, 0.5], np.float32)[:, None, None, None]
    key = jax.random.PRNGKey(11)
    kw = dict(noise_size=noise_size) if branch == "sebridge_v2_fixed" else {}
    ref = jax_inference.spec_sample(ref_model, variables, branch, jnp.asarray(X), jnp.asarray(Y),
                                    key, jnp.asarray(est), FIXED_SNR,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = inference.spec_sample(ours, branch, torch.from_numpy(X), torch.from_numpy(Y),
                                    noise_from(_branch_draws(branch, key, shape)),
                                    torch.from_numpy(est), FIXED_SNR,
                                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert out.shape == shape
    assert _rel_err(out.numpy(), ref) < REL_TOL


@pytest.mark.parametrize("branch", ["sebridge_v3_snr", "sebridge_v3_fixed"])
def test_eval_enhance_file_matches_jax(models, branch):
    """The whole-utterance eval path: per-row normalisation (for _snr with
    the unsnapped estimate's factor), the v3_fixed noise rescale, padding to
    the 64-frame bucket and back to the input's length."""
    ref_model, ours, variables = models(branch)
    x, y = _wavs(4, [9000, 9000])
    key = jax.random.PRNGKey(5)
    ref = jax_inference.eval_enhance_file(ref_model, variables, x, y, branch, key,
                                          est_snr=EST_SNRS[1], fixed_snr=FIXED_SNR)
    out = inference.eval_enhance_file(ours, x, y, branch, est_snr=EST_SNRS[1],
                                      fixed_snr=FIXED_SNR, noise=keyed_noise([key]))
    assert out.shape == ref.shape == (9000,)
    assert _rel_err(out, ref) < REL_TOL


# ---------------------------------------------------------------- streaming


@pytest.mark.parametrize("length", LENGTHS)
def test_enhance_streamed_matches_jax(models, length):
    """Waveform chunking (overlap 16 frames): all chunks one batch of the
    eval function, one draw for the batch, the linear cross-fade OLA."""
    ref_model, ours, variables = models("sebridge_v2")
    y = _wavs(1, [length])[0]
    key = jax.random.PRNGKey(2)
    ref = jax_streaming.enhance_streamed(ref_model, variables, y, "sebridge_v2", key)
    out = streaming.enhance_streamed(ours, y, "sebridge_v2", noise=keyed_noise([key]))
    assert out.shape == ref.shape == (length,)
    assert _rel_err(out, ref) < REL_TOL


@pytest.mark.parametrize("length", LENGTHS)
def test_enhance_streamed_spec_matches_jax(models, length):
    """Spec-domain chunking of one utterance: its n chunks one batch, the
    frame-domain cross-fade and one iSTFT."""
    ref_model, ours, variables = models("sebridge_v2")
    y = _wavs(2, [length])[0]
    key = jax.random.PRNGKey(3)
    ref = jax_streaming.enhance_streamed_spec(ref_model, variables, y, "sebridge_v2", key)
    out = streaming.enhance_streamed_spec(ours, y, "sebridge_v2", noise=keyed_noise([key]))
    assert out.shape == ref.shape == (length,)
    assert _rel_err(out, ref) < REL_TOL


def _packed_keys(key, lengths, batch_size):
    chunks = sum(streaming._packed_geometry(n, 128, CHUNK, 2)[1] for n in lengths)
    return [jax.random.fold_in(key, b) for b in range(-(-chunks // batch_size))]


@pytest.mark.parametrize("batch_size", [2, 3, 16])
def test_enhance_streamed_packed_matches_jax(models, batch_size):
    """The fleet engine on mixed lengths, with batches that split
    utterances (2, 3) and one padded batch (16): batch b draws from
    ``fold_in(key, b)`` in the JAX package, in turn here."""
    ref_model, ours, variables = models("sebridge_v2")
    ys = _wavs(3)
    key = jax.random.PRNGKey(4)
    refs = jax_streaming.enhance_streamed_packed(ref_model, variables, ys, "sebridge_v2", key,
                                                 batch_size=batch_size)
    outs = streaming.enhance_streamed_packed(
        ours, ys, "sebridge_v2", batch_size=batch_size,
        noise=keyed_noise(_packed_keys(key, LENGTHS, batch_size)))
    for out, ref, y in zip(outs, refs, ys):
        assert out.shape == np.asarray(ref).shape == y.shape
        assert _rel_err(out, ref) < REL_TOL


def test_packed_snr_branch_matches_jax(models):
    """sebridge_v3_snr packed: each utterance's estimate normalises its
    chunks and conditions their rows (snapped per row on the device)."""
    ref_model, ours, variables = models("sebridge_v3_snr")
    ys = _wavs(5)
    key = jax.random.PRNGKey(6)
    refs = jax_streaming.enhance_streamed_packed(ref_model, variables, ys, "sebridge_v3_snr",
                                                 key, batch_size=4, est_snrs=EST_SNRS,
                                                 fixed_snr=FIXED_SNR)
    outs = streaming.enhance_streamed_packed(ours, ys, "sebridge_v3_snr", batch_size=4,
                                             est_snrs=EST_SNRS, fixed_snr=FIXED_SNR,
                                             noise=keyed_noise(_packed_keys(key, LENGTHS, 4)))
    for out, ref in zip(outs, refs):
        assert _rel_err(out, ref) < REL_TOL


def test_sampler_kwargs_override_matches_jax(models):
    """The bbed sampler overrides reach the chunk sampler: the logit grid at
    N = 3 matches the JAX package, and differs from the linear grid on the
    same draws."""
    ref_model, ours, variables = models("bbed")
    ys = _wavs(6, [9000, 14000])
    sk = {"timestep_type": "logit", "N": 3}
    key = jax.random.PRNGKey(8)
    refs = jax_streaming.enhance_streamed_packed(ref_model, variables, ys, "bbed", key,
                                                 batch_size=4, sampler_kwargs=sk)
    draws = [d for k in _packed_keys(key, [9000, 14000], 4)
             for d in replay_pc_draws(k, 3, (4, 1, F_BINS, CHUNK))]
    outs = streaming.enhance_streamed_packed(ours, ys, "bbed", batch_size=4, sampler_kwargs=sk,
                                             noise=noise_from(draws))
    for out, ref in zip(outs, refs):
        assert _rel_err(out, ref) < REL_TOL
    linear = streaming.enhance_streamed_packed(ours, ys, "bbed", batch_size=4,
                                               sampler_kwargs={"N": 3}, noise=noise_from(draws))
    assert not np.allclose(linear[0], outs[0])


# ------------------------------------------------------- the port on its own


@pytest.mark.parametrize("batch_size", [3, 16])
def test_packed_equals_per_utterance(models, batch_size):
    """On the deterministic sebridge branch the packed engine gives what
    spec streaming gives per utterance, whatever the batch geometry."""
    _, ours, _ = models("sebridge")
    ys = _wavs(7)
    refs = [streaming.enhance_streamed_spec(ours, y, "sebridge") for y in ys]
    outs = streaming.enhance_streamed_packed(ours, ys, "sebridge", batch_size=batch_size)
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("entry, programs", [("spec", []), ("packed", [16])])
def test_only_the_packed_engine_captures(models, monkeypatch, entry, programs):
    """Where the engines capture (on the card, drawing from a generator),
    the packed engine runs its fixed-shape chunk program; spec streaming,
    whose batch is the utterance's own chunk count, runs eagerly, so that no
    program is captured per length."""
    _, ours, _ = models("sebridge")
    made = []

    def chunk_program(model, model_type, batch_size, chunk, fixed_snr, sampler_kwargs, inputs):
        made.append(batch_size)
        fn = streaming._chunk_fn(model, model_type, model.cfg.fixed_snr, {})
        return lambda gen, **t: fn(generator_noise(gen), **t)

    monkeypatch.setattr(streaming, "captures", lambda model, noise: noise is None)
    monkeypatch.setattr(streaming, "chunk_program", chunk_program)
    y = _wavs(11, [30000])[0]
    if entry == "spec":
        out = streaming.enhance_streamed_spec(ours, y, "sebridge")
    else:
        out = streaming.enhance_streamed_packed(ours, [y], "sebridge", batch_size=16)[0]
    assert made == programs
    monkeypatch.undo()
    np.testing.assert_allclose(out, streaming.enhance_streamed_spec(ours, y, "sebridge"),
                               rtol=2e-4, atol=2e-5)


def test_program_cache_drops_the_least_recently_used(models):
    """``cached_program`` with a limit keeps the most recently used
    programs, dropping the least recently used before it makes another."""
    _, ours, _ = models("sebridge")
    cache, made = {}, []
    for key in ("a", "b", "a", "c", "a", "b"):
        assert ours.cached_program(cache, key, lambda: made.append(key) or key, limit=2) == key
    assert made == ["a", "b", "c", "b"]
    assert list(cache) == ["a", "b"]


def test_packed_v2_fixed_takes_noise_size_per_utterance(models):
    """sebridge_v2_fixed rescales each utterance by its own |X - Y| max,
    even where a quiet utterance shares batches with a louder one: with the
    draws zeroed, packed equals per utterance, and the JAX package."""
    ref_model, ours, variables = models("sebridge_v2_fixed")
    rng = np.random.default_rng(9)
    xs, ys = [], []
    for ratio, t in ((0.05, 17000), (1.5, 24000)):
        x = rng.standard_normal(t).astype(np.float32) * 0.1
        xs.append(x)
        ys.append(x + rng.standard_normal(t).astype(np.float32) * 0.1 * ratio)
    zeros = lambda like: torch.zeros_like(like)  # noqa: E731
    refs = [streaming.enhance_streamed_spec(ours, y, "sebridge_v2_fixed", x_wav=x,
                                            fixed_snr=0.3, noise=zeros)
            for x, y in zip(xs, ys)]
    outs = streaming.enhance_streamed_packed(ours, ys, "sebridge_v2_fixed", batch_size=3,
                                             x_wavs=xs, fixed_snr=0.3, noise=zeros)
    key = jax.random.PRNGKey(1)
    jax_outs = jax_streaming.enhance_streamed_packed(
        ref_model, variables, ys, "sebridge_v2_fixed", key, batch_size=3, x_wavs=xs,
        fixed_snr=0.3)
    ported = streaming.enhance_streamed_packed(
        ours, ys, "sebridge_v2_fixed", batch_size=3, x_wavs=xs, fixed_snr=0.3,
        noise=keyed_noise(_packed_keys(key, [17000, 24000], 3)))
    for out, ref, j, p in zip(outs, refs, jax_outs, ported):
        scale = np.max(np.abs(ref))
        np.testing.assert_allclose(out / scale, ref / scale, atol=2e-5)
        assert _rel_err(p, j) < REL_TOL


def test_spec_streaming_identity_reconstructs(models, monkeypatch):
    """With the branch replaced by identity (return Y), prep -> chunks ->
    cross-fade OLA -> iSTFT reconstructs the input: the chunks tile the
    spectrogram and the weights sum to 1."""
    _, ours, _ = models("sebridge_v2")
    monkeypatch.setattr(streaming, "spec_sample", lambda model, branch, X, Y, *a, **k: Y)
    y = _wavs(8, [30000])[0]
    out = streaming.enhance_streamed_spec(ours, y, "sebridge_v2", overlap_frames=4)
    np.testing.assert_allclose(out, y, atol=1e-4)


@pytest.mark.parametrize("branch", inference.BRANCHES)
def test_padding_rows_stay_finite(models, branch):
    """The last batch is padded with zero chunks, est 1.0 and (v2_fixed)
    noise size 1.0: every branch gives finite padding rows, which stage 3
    discards."""
    _, ours, _ = models(branch)
    ys = _wavs(10, [9000, 3000])  # 2 + 1 chunks in a batch of 4: one padding row
    xs = [0.8 * y for y in ys]  # a clean reference apart from y (v2_fixed divides by |X - Y|)
    pool = streaming.pack_chunks(ours, ys, branch, batch_size=4, x_wavs=xs,
                                 est_snrs=EST_SNRS[:2], fixed_snr=FIXED_SNR)
    assert pool.chunks == 3 and pool.batches == 1
    assert torch.count_nonzero(pool.Y[3:]) == 0 and torch.all(pool.est[3:] == 1.0)
    samples = streaming.run_chunks(ours, pool, branch, torch.Generator().manual_seed(0),
                                   fixed_snr=FIXED_SNR, sampler_kwargs=(
                                       {"N": 2} if branch == "bbed" else None))
    assert torch.isfinite(torch.view_as_real(samples)).all()
    outs = streaming.finish_chunks(ours, pool, samples)
    assert [o.shape for o in outs] == [(9000,), (3000,)]
    assert all(np.isfinite(o).all() for o in outs)
