"""The port's training loss against the JAX package's, on the CPU.

Both packages get the same redrawn weights (the bridge,
``convert.state_dict_from_jax``), the same spectrograms and the same draws:
the JAX ``loss_fn``'s own time (or Karras index) and noise, replayed from
its key and fed to the port's ``loss_from_draws``. The JAX loss and its
gradients come from ``jax.value_and_grad(model.loss_fn)`` op by op (no
``jit``: the primitives compile once for the file and each branch reuses
them). The JAX side is its package's training configuration (the flags of
tests/test_train.py: flax's GroupNorm and XLA's convolutions, the maths of
the Pallas kernels the port's kernels follow). The gradient trees map
through the bridge too, since they have the params' structure.

Tolerances: the loss within 1e-5 relative; each parameter's gradient within
1e-4 of its largest magnitude. ``sqrt_mse`` (sqrt(|f|) with f's phase) has no
gradient where |f| = 0: its inputs keep |X| and |Y| in [0.5, 1], away from
zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.data.dataset import DataLoader as JaxDataLoader
from diffse_tpu.data.dataset import Specs as JaxSpecs
from diffse_tpu.data.dataset import Specs_SNR as JaxSpecsSNR
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.data.dataset import DataLoader, Specs, Specs_SNR
from diffse_tpu_torch.data.wavio import read_wav, write_wav
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

# the JAX package's training-test network and STFT (tests/test_train.py):
# 16 frequency bins (n_fft 30), 16 frames, two levels, attention at 8
TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
STFT = dict(n_fft=30, hop_length=8, num_frames=16)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52)
FIXED_SNR = 0.17783
SPEC_SHAPE = (2, 1, 16, 16)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def make_models(snr_conditioned, model_type, loss_type="mse", backbone="ncsnpp", seed=1,
                **config):
    """The JAX and the port's ScoreModel of one branch, with the same
    redrawn weights; returns (jax model, its params, port model)."""
    kw = dict(backbone=backbone, sde="bbed", model_type=model_type,
              snr_conditioned=snr_conditioned, fixed_snr=FIXED_SNR, sigma_max=1.0,
              loss_type=loss_type, **STFT, **config)
    snr = backbone == "ncsnpp_snr"
    jax_model = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs=TINY,
                              sde_kwargs=SDE_KWARGS)
    params = random_jax_params(TINY, seed, frames=16, snr=snr)
    port = ScoreModel(ScoreModelConfig(**kw), backbone_kwargs=TINY, sde_kwargs=SDE_KWARGS,
                      device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(params, **TINY, snr_conditioning=snr),
                                  strict=True)
    return jax_model, params, port


def jax_loss_draws(jax_model, key, x):
    """The draws of the JAX ``loss_fn(variables, (x, ...), key)``, by the
    port's names: the time "t" (bbed) or the Karras index "n", and "z"."""
    cfg = jax_model.cfg
    kt, kz = jax.random.split(key)
    b = x.shape[0]
    if (cfg.snr_conditioned, cfg.model_type) == ("false", "bbed"):
        T = jax_model.sde.T
        draws = {"t": jnp.minimum(jax.random.uniform(kt, (b,)) * (T - cfg.t_eps) + cfg.t_eps, T)}
    else:
        draws = {"n": jax.random.randint(kt, (b,), 1, 30).astype(jnp.float32)}
    draws["z"] = jax_randn_like(kz, x)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def spec_pair(seed, shape=SPEC_SHAPE):
    """Clean and noisy complex spectrograms with magnitudes in [0.5, 1]."""
    rng = np.random.default_rng(seed)

    def spec():
        mag = rng.uniform(0.5, 1.0, shape)
        return (mag * np.exp(1j * rng.uniform(-np.pi, np.pi, shape))).astype(np.complex64)

    return spec(), spec()


def port_grads(port) -> dict:
    return {name: p.grad.numpy() for name, p in port.backbone.named_parameters()
            if p.requires_grad}


def jax_grads_by_name(grads, snr) -> dict:
    return {k: v.numpy() for k, v in
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), **TINY,
                                snr_conditioning=snr).items()}


def gradient_scale(ref: dict, name: str) -> float:
    """What a parameter's gradient error is measured against: its largest
    magnitude; for an attention's key bias (``NIN_1.b``), whose gradient is
    zero but for rounding (the softmax over keys is unchanged by a shift
    common to all keys), that of the key weight ``NIN_1.W``."""
    if name.endswith("NIN_1.b"):
        name = name[:-1] + "W"
    return float(np.max(np.abs(ref[name])))


def assert_grads_close(ours: dict, ref: dict, tol=GRAD_TOL):
    """Each parameter's gradient within ``tol`` of its largest magnitude
    (``gradient_scale``); every parameter that requires grad has one."""
    assert set(ours) <= set(ref)
    worst = {}
    for name, g in ours.items():
        scale = gradient_scale(ref, name)
        assert scale > 0, name
        worst[name] = float(np.max(np.abs(g - ref[name])) / scale)
    name = max(worst, key=worst.get)
    assert worst[name] <= tol, f"{name}: {worst[name]:.3e} of its max"
    return worst


CASES = [("false", "bbed", "mse", "ncsnpp"), ("false", "bbed", "mae", "ncsnpp"),
         ("false", "bbed", "sqrt_mse", "ncsnpp"), ("false", "sebridge", "mse", "ncsnpp"),
         ("false", "sebridge_v2", "mse", "ncsnpp"), ("fixed", "sebridge_v2", "mse", "ncsnpp"),
         ("fixed", "sebridge_v3", "mse", "ncsnpp"), ("true", "sebridge_v2", "mse", "ncsnpp"),
         ("true", "sebridge_v2", "mse", "ncsnpp_snr"), ("true", "sebridge_v3", "mse", "ncsnpp"),
         ("true", "sebridge_v3", "sqrt_mse", "ncsnpp")]


@pytest.mark.parametrize("snr_conditioned,model_type,loss_type,backbone", CASES,
                         ids=["-".join(c) for c in CASES])
def test_loss_and_gradients_match_jax(snr_conditioned, model_type, loss_type, backbone):
    jax_model, params, port = make_models(snr_conditioned, model_type, loss_type, backbone)
    x, y = spec_pair(2)
    key = jax.random.PRNGKey(3)

    def jax_loss(p):
        return jax_model.loss_fn({"params": p}, (jnp.asarray(x), jnp.asarray(y)), key)[0]

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
    draws = jax_loss_draws(jax_model, key, jnp.asarray(x))
    loss = port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)), draws)
    loss.backward()
    rel = abs(loss.item() - float(ref_loss)) / abs(float(ref_loss))
    assert rel <= LOSS_RTOL, (loss.item(), float(ref_loss))
    assert_grads_close(port_grads(port), jax_grads_by_name(ref_grads, backbone == "ncsnpp_snr"))


def test_draws_are_those_loss_fn_takes():
    """``loss_fn`` draws t in [t_eps, T) (bbed) or n in 1..29 and CN(0, 1)
    noise from the generator, and gives ``loss_from_draws`` of them."""
    x, y = spec_pair(4)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for model_type, key in (("bbed", "t"), ("sebridge_v2", "n")):
        _, _, port = make_models("false", model_type)
        draws = port.draw_loss_noise(batch[0], torch.Generator().manual_seed(5))
        assert set(draws) == {key, "z"} and draws["z"].dtype == torch.complex64
        if key == "t":
            assert ((draws["t"] >= port.cfg.t_eps) & (draws["t"] <= port.sde.T)).all()
        else:
            assert ((draws["n"] >= 1) & (draws["n"] <= 29)).all()
        with torch.no_grad():
            loss = port.loss_fn(batch, torch.Generator().manual_seed(5))
            again = port.loss_from_draws(batch, draws)
        assert torch.equal(loss, again)
    big = torch.zeros((4096,), dtype=torch.complex64)
    z = port.draw_loss_noise(big[None, None, None], torch.Generator().manual_seed(0))["z"]
    assert abs(float(z.real.var()) - 0.5) < 0.05 and abs(float(z.imag.var()) - 0.5) < 0.05


@pytest.mark.parametrize("normalize", ["noisy", "clean", "not"])
def test_prepare_batch_matches_jax(normalize):
    jax_model, _, port = make_models("true", "sebridge_v3", normalize=normalize)
    rng = np.random.default_rng(6)
    n = (STFT["num_frames"] - 1) * STFT["hop_length"]
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal((2, n))).astype(np.float32)
    rms = np.asarray([0.1, 0.2], np.float32)
    ref = jax_model.prepare_batch((jnp.asarray(x), jnp.asarray(y), rms))
    out = port.prepare_batch((x, y, rms))
    assert out[2] is rms
    for a, r in zip(out[:2], ref[:2]):
        assert tuple(a.shape) == tuple(r.shape) == (2, 1, 16, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5 * np.max(np.abs(np.asarray(r))))


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """A tiny VBD-style directory: train (crops longer than the target) and
    valid (shorter: centre padded) pairs, and valid's active_rms.txt."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(7)
    for subset, lengths in (("train", (300, 500, 260, 400)), ("valid", (100, 90))):
        for kind in ("clean", "noisy"):
            (root / subset / kind).mkdir(parents=True)
        lines = []
        for i, n in enumerate(lengths):
            x = (0.3 * rng.standard_normal(n)).astype(np.float32)
            y = x + (0.2 * rng.standard_normal(n)).astype(np.float32)
            write_wav(str(root / subset / "clean" / f"f{i}.wav"), x, 16000)
            write_wav(str(root / subset / "noisy" / f"f{i}.wav"), y, 16000)
            lines.append(f"f{i}.wav\t{0.1 * (i + 1):.8f}\t{0.2 * (i + 1):.8f}")
        (root / subset / "active_rms.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_wavio_reads_what_it_writes(wav_dir):
    data, sr = read_wav(f"{wav_dir}/train/clean/f0.wav")
    assert sr == 16000 and data.shape == (1, 300) and data.dtype == np.float32


@pytest.mark.parametrize("num_workers", [1, 2])
def test_crops_and_fixed_snr_match_jax(wav_dir, num_workers):
    """The same seeds give the same crops, the same fixed_snr remix and the
    same batches: one worker draws each crop from the dataset's generator,
    more pre-draw them from the loader's."""
    common = dict(data_dir=wav_dir, subset="train", dummy=False, shuffle_spec=True,
                  num_frames=STFT["num_frames"], hop_length=STFT["hop_length"],
                  fixed_snr=FIXED_SNR, seed=11)
    ours = DataLoader(Specs(**common), 2, shuffle=True, num_workers=num_workers, seed=12)
    ref = JaxDataLoader(JaxSpecs(**common), 2, shuffle=True, num_workers=num_workers, seed=12)
    batches, ref_batches = list(ours), list(ref)
    assert len(batches) == len(ref_batches) == 2
    for b, r in zip(batches, ref_batches):
        assert b[0].shape == (2, (STFT["num_frames"] - 1) * STFT["hop_length"])
        for a, e in zip(b, r):
            np.testing.assert_allclose(a, e, rtol=0, atol=1e-7)
    assert Specs(**common).load_item(1, u=0.25)[0].shape == batches[0][0].shape[1:]


def test_valid_set_pads_and_reads_rms_as_jax(wav_dir):
    common = dict(data_dir=wav_dir, subset="valid", dummy=False, shuffle_spec=False,
                  num_frames=STFT["num_frames"], hop_length=STFT["hop_length"])
    ours, ref = Specs_SNR(**common), JaxSpecsSNR(**common)
    for i in range(len(ref)):
        for a, e in zip(ours[i], ref[i]):
            np.testing.assert_allclose(a, e, rtol=0, atol=1e-7)
    assert ours[1][2] == np.float32(0.2) and ours[1][3] == np.float32(0.4)
