"""The port's SNR estimator (SNRNet, SNRModel, ``ScoreModel.estimate_snr``)
and the Karras-grid snap against the JAX package.

SNRNet runs at its production size (1,258,241 parameters in flax) with
seeded random weights carried over by ``convert.snrnet_state_dict_from_jax``
and loaded with ``strict=True``; outputs agree to 1e-5 (float32 through a
conv stack and an LSTM, sums in another order). SNRNet on the card is held
to the CPU by ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models import score_model as jax_score_model
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.models.snr_model import SNRModel as JaxSNRModel
from diffse_tpu.models.snrnet import SNRNet as JaxSNRNet
from diffse_tpu.transforms import spec as jspec
from diffse_tpu_torch.convert import snrnet_state_dict_from_jax
from diffse_tpu_torch.models import score_model
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.snr_model import SNRModel
from diffse_tpu_torch.models.snrnet import SNRNet
from diffse_tpu_torch.transforms import spec

torch.set_num_threads(2)

N_PARAMS_FLAX = 1_258_241
TINY_ARCH = dict(nf=4, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(16,),
                 image_size=256)


def snrnet_param_shapes(frames=32):
    x = jnp.zeros((1, 2, 256, frames), jnp.float32)
    return jax.eval_shape(JaxSNRNet().init, jax.random.PRNGKey(0), x)["params"]


def random_snrnet_params(seed, fc_bias=None):
    """Seeded random SNRNet params (kernels at 1/sqrt(fan_in), biases small);
    ``fc_bias`` sets the output's bias, to place g_hat where a test wants it."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return 0.1 * z
        return z / np.sqrt(np.prod(leaf.shape[:-1]))

    params = jax.tree_util.tree_map_with_path(draw, snrnet_param_shapes())
    if fc_bias is not None:
        params["fc"]["bias"] = np.full_like(params["fc"]["bias"], fc_bias)
    return params


def port_snrnet(params):
    net = SNRNet()
    net.load_state_dict(snrnet_state_dict_from_jax(params), strict=True)
    return net.eval()


@pytest.fixture(scope="module")
def snr_params():
    return random_snrnet_params(seed=11, fc_bias=-2.0)


def test_state_dict_names_from_flax_init():
    """The flax tree's names (read from its init, not assumed) map onto the
    reference's torch names, every key and shape of the port's module."""
    shapes = snrnet_param_shapes()
    assert sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes)) == N_PARAMS_FLAX
    lstm_cells = sorted(k for k in shapes if k.startswith("OptimizedLSTMCell"))
    assert lstm_cells == ["OptimizedLSTMCell_0", "OptimizedLSTMCell_1"]
    for cell in lstm_cells:
        assert sorted(shapes[cell]) == sorted(f"{a}{g}" for a in "ih" for g in "ifgo")
    assert {f"convt_{w}" for w in (1, 2, 4, 8)} <= set(shapes)
    params = jax.tree_util.tree_map(lambda l: np.zeros(l.shape, np.float32), shapes)
    sd = snrnet_state_dict_from_jax(params)
    model_sd = SNRNet().state_dict()
    assert set(sd) == set(model_sd)
    for k, v in model_sd.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # torch keeps two LSTM biases per direction where flax keeps one
    assert sum(v.numel() for v in model_sd.values()) == N_PARAMS_FLAX + 2 * 4 * 128


@pytest.mark.parametrize("frames", [32, 64])
def test_snrnet_matches_jax(snr_params, frames):
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((2, 2, 256, frames)).astype(np.float32)
    ref = np.asarray(JaxSNRNet().apply({"params": snr_params}, jnp.asarray(x)))
    with torch.no_grad():
        out = port_snrnet(snr_params)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1)
    assert 0.02 < ref.min() and ref.max() < 0.98  # away from the sigmoid's flat ends
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)


def test_pad_spec_16_matches_jax():
    x = np.arange(2 * 3 * 37, dtype=np.float32).reshape(2, 3, 37)
    out = spec.pad_spec_16(torch.from_numpy(x)).numpy()
    assert out.shape[-1] == 48
    np.testing.assert_array_equal(out, np.asarray(jspec.pad_spec_16(jnp.asarray(x))))
    assert spec.pad_spec_16(torch.zeros(1, 32)).shape[-1] == 32


def _noisy_wavs(seed, batch, samples):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    clean = 0.3 * np.sin(2 * np.pi * 180 * t) * (0.2 + np.abs(np.sin(2 * np.pi * 3 * t)))
    scales = np.linspace(0.02, 0.2, batch)[:, None]
    return (clean[None] + scales * rng.standard_normal((batch, samples))).astype(np.float32)


def test_estimate_snr_matches_jax(snr_params):
    """``ScoreModel.estimate_snr`` (per-row normalisation, raw STFT, pad to
    16) and ``SNRModel.estimate_from_wav`` (batch normalisation) on 37
    frames, against the JAX package's."""
    y = _noisy_wavs(1, 2, 36 * 128)
    cfg = JaxScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                              snr_conditioned="true")
    jax_model = JaxScoreModel(cfg, backbone_kwargs=TINY_ARCH,
                              snr_model=(JaxSNRNet(), {"params": snr_params}))
    ref = np.asarray(jax_model.estimate_snr(jnp.asarray(y)))
    ours = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                                       snr_conditioned="true"),
                      backbone_kwargs=TINY_ARCH, device="cpu", snr_model=port_snrnet(snr_params))
    out = ours.estimate_snr(y).numpy()
    assert out.shape == ref.shape == (2,)
    np.testing.assert_allclose(out, ref, rtol=1e-5)

    jax_snr = JaxSNRModel()
    ref = np.asarray(jax_snr.estimate_from_wav({"params": snr_params}, jnp.asarray(y)))
    out = SNRModel(device="cpu", dnn=port_snrnet(snr_params)).estimate_from_wav(y).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    spec2 = np.random.default_rng(2).standard_normal((1, 1, 256, 16)).astype(np.complex64)
    np.testing.assert_array_equal(
        SNRModel._complex_to_2ch(torch.from_numpy(spec2)).numpy(),
        np.asarray(JaxSNRModel._complex_to_2ch(jnp.asarray(spec2))))


@pytest.mark.parametrize("est_snr", [1e-4, 0.0317, 0.1, 0.25, 0.3, 0.5, 2.0])
@pytest.mark.parametrize("fixed_snr", [0.17783, 1.0])
def test_karras_snap_matches_jax(est_snr, fixed_snr):
    """t_hat and the normalisation factor as the JAX package computes them
    (``score_model.py:552-557``), from float32 scalars."""
    est = jnp.float32(est_snr)
    t_ = jax_score_model.calculate_snr_direct(1.0, est, fixed_snr)
    t30 = jnp.asarray(jax_score_model.t_30)
    t_hat_ref = t30[jnp.argmin(jnp.abs(t30 - t_))]
    normfac_ref = jax_score_model.calculate_normfac_direct(
        1.0, 10**0.25 * fixed_snr * t_hat_ref, fixed_snr)
    t_hat, normfac = score_model.snap_to_karras_grid(np.float32(est_snr), fixed_snr)
    assert t_hat == np.float32(t_hat_ref)
    np.testing.assert_allclose(normfac, np.asarray(normfac_ref), rtol=1e-6)
    np.testing.assert_array_equal(score_model.t_30, jax_score_model.t_30)
    for n in (1, 7, 30):
        assert score_model.karras_t(n) == jax_score_model.karras_t(n)


def test_noise_mag_matches_jax():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((1, 1, 8, 6)) + 1j * rng.standard_normal((1, 1, 8, 6)))
    b = (rng.standard_normal((1, 1, 8, 6)) + 1j * rng.standard_normal((1, 1, 8, 6)))
    a, b = a.astype(np.complex64), b.astype(np.complex64)
    for mode in ("mean", "max"):
        np.testing.assert_allclose(
            score_model.noise_mag(torch.from_numpy(a), torch.from_numpy(b), mode).numpy(),
            np.asarray(jax_score_model.noise_mag(jnp.asarray(a), jnp.asarray(b), mode)),
            rtol=1e-6)


def test_snr_model_runs_on_the_card_unless_told(monkeypatch):
    """``SNRModel`` defaults to the card; without one, the default raises and
    nothing falls back to the CPU. ``device="cpu"`` works as before."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNRModel()
    model = SNRModel(device="cpu")
    assert next(model.dnn.parameters()).device.type == "cpu"
    est = model.estimate_from_wav(_noisy_wavs(3, 1, 20 * 128))
    assert est.shape == (1,) and torch.isfinite(est).all()
