"""The port's DCUNet (and the complex layers of ``models/shared.py``) against
the JAX package's on the CPU, the weights and running statistics carried
over by ``convert.dcunet_state_dict_from_jax``.

Tolerances: float32 forwards within 1e-5 of max(1, max|ref|); the "bN"
running statistics after three training forwards within 2e-6 of max(1,
|ref|) (1e-6 on DCUNet-10; DilDCUNet-v2's decoder statistics come out
1.25e-6 apart: they take the training forward's float32 differences, 2e-6
relative at the output, and summing them in float64 moves them to 1.2e-6
only); the training loss within 1e-5 relative and each parameter's gradient
within 1e-4 of its largest magnitude (``test_torch_train_loss``'s measures).
Each architecture runs at the smallest frequency size its strides and
dilations take (DilDCUNet-v2's dilation-8 level needs F = 129). The JAX side
runs jitted, but with the "ds" embedding: its frequencies reach 1e4, and
under ``jit`` XLA folds their ``10 ** x`` at compile time with other
roundings than its own runtime ``pow``, which moves the embedding by 3.6e-3
(the JAX package against itself), so those cases run op by op.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models import shared as jax_shared
from diffse_tpu.models.dcunet import DCUNet as JaxDCUNet
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.ops.convt import conv_transpose2d as jax_conv_transpose2d
from diffse_tpu_torch.convert import dcunet_state_dict_from_jax, flax_tree_state_dict
from diffse_tpu_torch.models import shared
from diffse_tpu_torch.models.dcunet import DCUNet
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.shared import BackboneRegistry
from diffse_tpu_torch.ops.convt import conv_transpose2d
from test_torch_train_loss import (GRAD_TOL, LOSS_RTOL, SDE_KWARGS, assert_grads_close,
                                   jax_loss_draws, port_grads, spec_pair)

torch.set_num_threads(2)

FWD_TOL = 1e-5
STATS_TOL = {"DilDCUNet-v2": 2e-6, "DCUNet-10": 1e-6}
# (F, T) per architecture: F - 1 a multiple of the frequency strides, T - 1
# not one of the time strides (so the input is padded or trimmed)
SIZES = {"DilDCUNet-v2": (129, 18), "DCUNet-10": (33, 19), "DCUNet-16": (257, 19),
         "DCUNet-20": (257, 18)}
CASES = [
    ("DilDCUNet-v2", {}),
    ("DilDCUNet-v2", dict(dcunet_norm_type="CbN", dcunet_time_embedding_complex=True,
                          dcunet_activation="silu")),
    ("DilDCUNet-v2", dict(dcunet_time_embedding="none", dcunet_fix_length="trim",
                          dcunet_activation="leaky_relu", dcunet_temb_layers_global=1)),
    ("DilDCUNet-v2", dict(dcunet_time_embedding_complex=True, dcunet_temb_layers_local=2,
                          dcunet_temb_activation="relu")),
    ("DCUNet-10", dict(dcunet_time_embedding="ds")),
    ("DCUNet-10", dict(dcunet_time_embedding="ds", dcunet_time_embedding_complex=True,
                       dcunet_norm_type="CbN")),
    ("DCUNet-16", dict(dcunet_norm_type="CbN")),
    ("DCUNet-20", {}),
]
CASE_IDS = [f"{a}-{'-'.join(f'{k[7:]}={v}' for k, v in kw.items()) or 'defaults'}"
            for a, kw in CASES]


def _inputs(seed, arch, batch=2):
    f, t = SIZES[arch]
    rng = np.random.default_rng(seed)
    shape = (batch, 2, f, t)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x, rng.uniform(0.05, 0.99, size=(batch,)).astype(np.float32)


def jax_variables(module, x, t, seed):
    """The JAX DCUNet's variables, redrawn from a numpy seed: kernels at
    1/sqrt(fan_in), norm scales near 1, biases small, the running variances
    in [0.5, 1.5] and means small (the init's zeros and ones would hide a
    swapped statistic)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("scale", "Wrr", "Wii"):
            return 1.0 + 0.1 * z
        if name == "Wri":
            return 0.9 + 0.1 * z
        if leaf.ndim == 1:
            return 0.1 * z
        return z / np.sqrt(np.prod(leaf.shape[:-1]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_dcunet(variables, **kw):
    model = DCUNet(**kw)
    model.load_state_dict(dcunet_state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
def test_forward_matches_jax(arch, kw):
    kw = dict(dcunet_architecture=arch, **kw)
    x, t = _inputs(1, arch)
    jmod = JaxDCUNet(**kw)
    variables = jax_variables(jmod, x, t, seed=2)
    apply = jmod.apply if kw.get("dcunet_time_embedding") == "ds" else jax.jit(jmod.apply)
    ref = np.asarray(apply(variables, jnp.asarray(x), jnp.asarray(t)))
    model = port_dcunet(variables, **kw).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (2, 1, *SIZES[arch])
    assert np.max(np.abs(out - ref)) <= FWD_TOL * max(1.0, np.max(np.abs(ref)))


@pytest.mark.parametrize("arch,norm", [("DilDCUNet-v2", "bN"), ("DCUNet-10", "bN"),
                                       ("DCUNet-10", "CbN")])
def test_training_forwards_and_running_statistics_match_jax(arch, norm):
    """Three training forwards, one after another: each output by the batch's
    statistics, and the "bN" running statistics as flax updates them
    (momentum 0.9, the biased variance)."""
    kw = dict(dcunet_architecture=arch, dcunet_norm_type=norm)
    jmod = JaxDCUNet(**kw)
    x, t = _inputs(3, arch)
    variables = jax_variables(jmod, x, t, seed=4)
    model = port_dcunet(variables, **kw).train()
    apply = jax.jit(lambda v, x_, t_: jmod.apply(v, x_, t_, train=True, mutable=["batch_stats"]))
    for step in range(3):
        x, t = _inputs(10 + step, arch)
        ref, updates = apply(variables, jnp.asarray(x), jnp.asarray(t))
        variables = {**variables, **updates}
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
        ref = np.asarray(ref)
        assert np.max(np.abs(out - ref)) <= FWD_TOL * max(1.0, np.max(np.abs(ref)))
    stats = flax_tree_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        variables.get("batch_stats", {})))
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) and (len(buffers) > 0) == (norm == "bN")
    for name, ref in stats.items():
        err = np.max(np.abs(buffers[name].numpy() - ref))
        assert err <= STATS_TOL[arch] * max(1.0, np.max(np.abs(ref))), (name, err)


def test_state_dict_has_no_update_count():
    """The statistics buffers are the running mean and variance only (no
    ``num_batches_tracked``, which would change the captured programs' key at
    every training step)."""
    model = DCUNet()
    names = [n for n, _ in model.named_buffers()]
    assert names and all(n.endswith(("running_mean", "running_var")) for n in names)


# a ScoreModel on DCUNet-10 with a 64-point STFT: 33 bins, 16 frames
DCUNET10 = dict(dcunet_architecture="DCUNet-10")
STFT = dict(n_fft=64, hop_length=16, num_frames=16)


@pytest.mark.parametrize("model_type", ["bbed", "sebridge_v2"])
def test_loss_gradients_and_statistics_match_jax(model_type):
    """``loss_fn`` in training: the loss and gradients, and the running
    statistics after it, which for the consistency losses (two runs of the
    network) are the second run's, each updated from where the step began,
    as the JAX package merges its updates."""
    kw = dict(backbone="dcunet", sde="bbed", model_type=model_type, snr_conditioned="false",
              sigma_max=1.0, **STFT)
    jax_model = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs=DCUNET10,
                              sde_kwargs=SDE_KWARGS)
    port = ScoreModel(ScoreModelConfig(**kw), backbone_kwargs=DCUNET10, sde_kwargs=SDE_KWARGS,
                      device="cpu")
    x, y = spec_pair(5, shape=(2, 1, 33, 16))
    variables = jax_variables(jax_model.backbone, np.zeros((1, 2, 33, 16), np.complex64),
                              np.ones(1, np.float32), seed=6)
    port.backbone.load_state_dict(dcunet_state_dict_from_jax(variables), strict=True)
    key = jax.random.PRNGKey(7)

    def jax_loss(p):
        return jax_model.loss_fn({**variables, "params": p}, (jnp.asarray(x), jnp.asarray(y)),
                                 key)

    (ref_loss, updates), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    draws = jax_loss_draws(jax_model, key, jnp.asarray(x))
    loss = port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)), draws)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    ref = {k: v.numpy() for k, v in dcunet_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, ref_grads)}).items()}
    assert_grads_close(port_grads(port), ref, GRAD_TOL)
    stats = flax_tree_state_dict(jax.tree_util.tree_map(np.asarray, updates["batch_stats"]))
    buffers = dict(port.backbone.named_buffers())
    for name, value in stats.items():
        err = np.max(np.abs(buffers[name].numpy() - value))
        assert err <= STATS_TOL["DCUNet-10"] * max(1.0, np.max(np.abs(value))), (name, err)


def test_raises_where_jax_raises():
    """n_fft 510 (256 bins: 255 is no multiple of the strides' 8) raises the
    JAX package's TypeError at the forward; a mask bound raises as it does."""
    x = np.zeros((1, 2, 256, 16), np.complex64)
    t = np.ones(1, np.float32)
    with pytest.raises(TypeError) as jax_err:
        JaxDCUNet().init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    with pytest.raises(TypeError) as port_err:
        DCUNet()(torch.from_numpy(x), torch.from_numpy(t))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="mask bounding"):
        JaxDCUNet(dcunet_mask_bound="tanh").init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 jnp.asarray(t))
    with pytest.raises(NotImplementedError, match="mask bounding"):
        DCUNet(dcunet_mask_bound="tanh")
    with pytest.raises(TypeError):
        DCUNet(dtype="bf16")


def test_registry_and_defaults_match_jax():
    from diffse_tpu.models.shared import BackboneRegistry as JaxRegistry

    assert sorted(BackboneRegistry.get_all_names()) == sorted(JaxRegistry.get_all_names())
    import argparse
    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    DCUNet.add_argparse_args(ours)
    JaxDCUNet.add_argparse_args(theirs)
    assert vars(ours.parse_args([])) == vars(theirs.parse_args([]))
    model = DCUNet()
    assert model.temb_layers_global == 2 and hasattr(model, "embed_global_1")


@pytest.mark.parametrize("output_padding", [(0, 0), (1, 0), (-1, 2), (3, -2)])
def test_conv_transpose2d_matches_jax(output_padding):
    """Inside torch's output-padding range and outside it (negative, or past
    max(stride, dilation))."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 6, 3)).astype(np.float32)  # NHWC
    w = rng.standard_normal((4, 3, 3, 5)).astype(np.float32)  # HWIO
    args = dict(stride=(2, 1), padding=(2, 1), dilation=(2, 1))
    ref = np.asarray(jax_conv_transpose2d(jnp.asarray(x), jnp.asarray(w),
                                          output_padding=output_padding, **args))
    out = conv_transpose2d(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                           torch.from_numpy(w.transpose(2, 3, 0, 1)),
                           output_padding=output_padding, **args).numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.max(np.abs(ref)))


def _jax_leaves(rng, module, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                  shapes)


@pytest.mark.parametrize("complex_valued", [False, True])
def test_shared_embeddings_and_linear_match_jax(complex_valued):
    rng = np.random.default_rng(9)
    t = rng.uniform(0.05, 0.99, 3).astype(np.float32)
    tc = jnp.asarray(t).astype(jnp.complex64)
    jgfp = jax_shared.GaussianFourierProjection(embed_dim=16, complex_valued=complex_valued)
    v = _jax_leaves(rng, jgfp, tc)
    gfp = shared.GaussianFourierProjection(16, complex_valued=complex_valued)
    gfp.W.data.copy_(torch.from_numpy(np.asarray(v["params"]["W"])))
    np.testing.assert_allclose(gfp(torch.from_numpy(t)).numpy(),
                               np.asarray(jgfp.apply(v, tc)), rtol=0, atol=1e-5)
    ds = jax_shared.DiffusionStepEmbedding(embed_dim=16, complex_valued=complex_valued)
    np.testing.assert_allclose(
        shared.DiffusionStepEmbedding(16, complex_valued)(torch.from_numpy(t)).numpy(),
        np.asarray(ds.apply({}, tc)), rtol=0, atol=1e-5)
    xe = (rng.standard_normal((3, 8)) + 1j * rng.standard_normal((3, 8))).astype(np.complex64)
    if not complex_valued:
        xe = xe.real.copy()
    for jm, tm in ((jax_shared.ComplexLinear(5, complex_valued=complex_valued),
                    shared.ComplexLinear(8, 5, complex_valued)),
                   (jax_shared.FeatureMapDense(5, complex_valued=complex_valued),
                    shared.FeatureMapDense(8, 5, complex_valued))):
        v = _jax_leaves(rng, jm, jnp.asarray(xe))
        tm.load_state_dict({k: torch.from_numpy(a) for k, a in
                            flax_tree_state_dict(v["params"]).items()}, strict=True)
        ref = np.asarray(jm.apply(v, jnp.asarray(xe)))
        out = tm(torch.from_numpy(xe)).detach().numpy()
        if out.ndim == 4:  # NCHW [B, C, 1, 1] against NHWC [B, 1, 1, C]
            out = out.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.max(np.abs(ref))))


def test_shared_complex_convs_match_jax():
    """The shared complex conv (SAME, odd kernel) and transposed conv (flax's
    ``nn.ConvTranspose``, which does not flip its kernel: the port's weight
    is the flipped kernel)."""
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((2, 6, 5, 3)) + 1j * rng.standard_normal((2, 6, 5, 3)))
    x = x.astype(np.complex64)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    jconv = jax_shared.ComplexConv2d(4, (3, 3))
    v = _jax_leaves(rng, jconv, jnp.asarray(x))
    conv = shared.ComplexConv2d(3, 4, 3, padding=1)
    conv.load_state_dict({k: torch.from_numpy(a) for k, a in
                          flax_tree_state_dict(v["params"]).items()}, strict=True)
    ref = np.asarray(jconv.apply(v, jnp.asarray(x)))
    out = conv(xt).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.max(np.abs(ref)))

    jct = jax_shared.ComplexConvTranspose2d(4, (3, 3))
    v = _jax_leaves(rng, jct, jnp.asarray(x))
    ct = shared.ComplexConvTranspose2d(3, 4, 3, padding=1, bias=True)
    p = v["params"]
    sd = {}
    for part, name in (("re", "re"), ("im", "im")):
        k = np.asarray(p[part]["kernel"])[::-1, ::-1]  # flax does not flip
        sd[f"w_{name}"] = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    # flax adds each part's bias to its conv: re(a) - im(b) carries b_re - b_im
    sd["b_re"] = torch.from_numpy(np.asarray(p["re"]["bias"]) - np.asarray(p["im"]["bias"]))
    sd["b_im"] = torch.from_numpy(np.asarray(p["re"]["bias"]) + np.asarray(p["im"]["bias"]))
    ct.load_state_dict(sd, strict=True)
    ref = np.asarray(jct.apply(v, jnp.asarray(x)))
    out = ct(xt).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.max(np.abs(ref)))


def test_cli_train_then_eval_round_trip(tmp_path):
    """``cli.train --backbone dcunet --n_fft 512`` (DilDCUNet-v2 at the
    command line's defaults) takes a step on the synthetic set and writes a
    checkpoint whose ``hparams.json`` rebuilds the model; ``cli.eval``
    enhances and scores the test files from it."""
    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.cli.train import main as train_main
    from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
    from diffse_tpu_torch.train.restore import load_score_model

    data = make_synthetic_dataset(str(tmp_path / "data"), num_train=2, num_valid=1,
                                  num_valid2=1, num_test=1, duration_s=0.5)
    ckpt = str(tmp_path / "run")
    state = train_main(["--backbone", "dcunet", "--sde", "bbed", "--modeltype", "bbed",
                        "--n_fft", "512", "--batch_size", "2", "--num_frames", "16",
                        "--num_workers", "1", "--max_steps_per_epoch", "1",
                        "--num_eval_files", "0", "--device", "cpu", "--base_dir", data,
                        "--max_epochs", "1", "--ckpt_dir", ckpt])
    assert state.step == 1
    with open(os.path.join(ckpt, "hparams.json")) as f:
        hp = json.load(f)
    assert hp["config"]["backbone"] == "dcunet" and hp["config"]["n_fft"] == 512
    assert hp["backbone_kwargs"]["dcunet_activation"] == "leaky_relu"
    assert hp["backbone_kwargs"]["dcunet_temb_layers_global"] == 1
    model, restored = load_score_model(ckpt, device="cpu")
    assert isinstance(model.backbone, DCUNet)
    stats = [b for n, b in model.backbone.named_buffers() if n.endswith("running_var")]
    assert stats and not all(torch.equal(b, torch.ones_like(b)) for b in stats)
    out_dir = str(tmp_path / "enhanced")
    summary = eval_cli.main(["--destination_folder", out_dir, "--test_dir",
                             os.path.join(data, "test"), "--ckpt", ckpt, "--device", "cpu",
                             "--N", "2"])
    assert summary["files"] == 1
    with open(os.path.join(out_dir, "_results.csv")) as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 1 and np.isfinite(float(rows[0].split(",")[2]))
