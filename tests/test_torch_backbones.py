"""Every NCSN++ configuration of the JAX package's ``NCSNppBase`` in the port,
against ``diffse_tpu`` at tiny widths, the weights carried over by the
bridge (``convert.state_dict_from_jax``, whose correspondence is derived for
each configuration).

Forward parity (eval mode) is held to 1e-5 of max(1, max|ref|); the training
loss to 1e-5 relative and each parameter's gradient to 1e-4 of its largest
magnitude (``test_torch_train_loss``'s measures), with dropout's keep masks
shared: the masks are drawn from a numpy seed and fed to flax's ``Dropout``
through ``nn.intercept_methods`` (the JAX ``ScoreModel`` passes its network
no dropout key, so its own training with dropout > 0 raises) and to the
port through ``keep_mask``, in the order the network reaches them.
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
from diffse_tpu_torch import convert
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.models.ncsnpp import NCSNpp, NCSNppSNR
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import fir as torch_fir
from test_torch_ncsnpp import _flax_leaf_paths, jax_param_shapes, random_jax_params
from test_torch_train_loss import (FIXED_SNR, GRAD_TOL, LOSS_RTOL, SDE_KWARGS, STFT,
                                   assert_grads_close, jax_loss_draws, port_grads, spec_pair)

torch.set_num_threads(2)

TINY = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
FWD_TOL = 1e-5

# score_sde's DDPM++ (the configuration chip_smoke's backbones phase runs at
# full width), then each field away from the paper's default
DDPMPP = dict(resblock_type="ddpm", fir=False, resamp_with_conv=True, progressive="none",
              progressive_input="none", embedding_type="positional", dropout=0.1)
CONFIGS = {
    "ddpmpp": DDPMPP,
    "ddpm-fir-residual-noskiprescale": dict(resblock_type="ddpm", progressive="residual",
                                            progressive_input="residual", skip_rescale=False),
    "biggan-naive-residual-cat": dict(fir=False, progressive="residual",
                                      progressive_input="input_skip", progressive_combine="cat",
                                      dropout=0.1),
    "biggan-elu": dict(nonlinearity="elu"),
    "ddpm-lrelu-unconditional": dict(resblock_type="ddpm", nonlinearity="lrelu",
                                     conditional=False, fir=False),
    "ddpm-noconv-naive": dict(resblock_type="ddpm", resamp_with_conv=False, fir=False,
                              progressive_input="input_skip", progressive_combine="cat"),
    "ddpm-noconv-fir-relu": dict(resblock_type="ddpm", resamp_with_conv=False,
                                 nonlinearity="relu"),
    "biggan-noskiprescale-positional-none": dict(skip_rescale=False,
                                                 embedding_type="positional",
                                                 progressive="none", init_scale=0.1),
}


def arch_of(name):
    return {**TINY, **CONFIGS[name]}


def make_models(model_type, arch, seed):
    """The JAX and the port's ScoreModel (BBED SDE, the training tests'
    STFT) with the backbone ``arch`` and the same redrawn weights."""
    kw = dict(backbone="ncsnpp", sde="bbed", model_type=model_type, snr_conditioned="false",
              fixed_snr=FIXED_SNR, sigma_max=1.0, **STFT)
    jax_model = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs=arch,
                              sde_kwargs=SDE_KWARGS)
    params = random_jax_params(arch, seed, frames=16)
    port = ScoreModel(ScoreModelConfig(**kw), backbone_kwargs=arch, sde_kwargs=SDE_KWARGS,
                      device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(params, **arch), strict=True)
    return jax_model, params, port


def _inputs(seed, batch=2, size=16):
    rng = np.random.default_rng(seed)
    shape = (batch, 2, size, size)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    t = rng.uniform(0.05, 0.99, size=(batch,)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("snr", [False, True], ids=["ncsnpp", "ncsnpp_snr"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_correspondence_covers_full_tree(name, snr):
    """The derived correspondence names every flax leaf once, and the port's
    module tree takes the bridged state_dict with strict=True."""
    arch = arch_of(name)
    shapes = jax_param_shapes(arch, frames=16, snr=snr)
    corr = convert.ncsnpp_correspondence(
        **{k: v for k, v in arch.items() if k not in convert.NCSNPP_VALUE_FIELDS},
        snr_conditioning=snr)
    covered = []
    for _prefix, flax_path, _kind in corr:
        node = shapes
        for p in flax_path:
            node = node[p]
        covered += [flax_path + (leaf,) for leaf in node if not isinstance(node[leaf], dict)]
    assert sorted(covered) == sorted(_flax_leaf_paths(shapes))
    model = (NCSNppSNR if snr else NCSNpp)(**arch)
    sd = state_dict_from_jax(random_jax_params(arch, 0, frames=16, snr=snr), **arch,
                             snr_conditioning=snr)
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    arch = arch_of(name)
    params = random_jax_params(arch, seed=3, frames=16)
    x, t = _inputs(4)
    ref = np.asarray(jax.jit(JaxNCSNpp(**arch).apply)({"params": params}, jnp.asarray(x),
                                                       jnp.asarray(t)))
    model = NCSNpp(**arch).eval()
    model.load_state_dict(state_dict_from_jax(params, **arch), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (2, 1, 16, 16)
    assert np.max(np.abs(out - ref)) <= FWD_TOL * max(1.0, np.max(np.abs(ref)))


def test_snr_conditioned_ddpm_forward_matches_jax():
    arch = {**TINY, **DDPMPP}
    params = random_jax_params(arch, seed=5, frames=16, snr=True)
    x, t = _inputs(6)
    s = t[::-1].copy()
    ref = np.asarray(jax.jit(JaxNCSNppSNR(**arch).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(s)))
    model = NCSNppSNR(**arch).eval()
    model.load_state_dict(state_dict_from_jax(params, **arch, snr_conditioning=True),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(s)).numpy()
    assert np.max(np.abs(out - ref)) <= FWD_TOL * max(1.0, np.max(np.abs(ref)))


class MaskFeed:
    """Dropout keep masks from a numpy seed, drawn in flax's NHWC shape as the
    JAX network asks for them and recorded; ``port`` replays them, in the
    same order, in the port's NCHW layout."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []
        self.replayed = 0

    def jax_interceptor(self, next_fun, args, kwargs, context):
        module = context.module
        if isinstance(module, nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            if module.deterministic or module.rate == 0:
                return x
            keep = 1.0 - module.rate
            mask = self.rng.uniform(size=x.shape) < keep
            self.masks.append(mask)
            return jax.lax.select(jnp.asarray(mask), x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def port(self, shape, keep, device):
        mask = self.masks[self.replayed].transpose(0, 3, 1, 2)
        self.replayed += 1
        assert mask.shape == shape
        return torch.from_numpy(np.ascontiguousarray(mask)).to(device)


class _InterceptedBackbone:
    """The JAX backbone with flax's dropout fed by ``feed``."""

    def __init__(self, module, feed):
        self.module, self.feed = module, feed

    def apply(self, *args, **kwargs):
        with nn.intercept_methods(self.feed.jax_interceptor):
            return self.module.apply(*args, **kwargs)


TRAIN_CASES = [("ddpmpp", "bbed"), ("ddpmpp", "sebridge_v2"),
               ("biggan-naive-residual-cat", "bbed"), ("ddpm-fir-residual-noskiprescale", "bbed")]


@pytest.mark.parametrize("name,model_type", TRAIN_CASES, ids=["-".join(c) for c in TRAIN_CASES])
def test_loss_and_gradients_match_jax(name, model_type):
    """``loss_fn`` in training (dropout on where the configuration has it)
    and its gradients; the consistency losses run the network twice, each
    run with its own masks."""
    arch = arch_of(name)
    jax_model, params, port = make_models(model_type, arch, seed=7)
    feed = MaskFeed(8)
    jax_model.backbone = _InterceptedBackbone(jax_model.backbone, feed)
    x, y = spec_pair(9)
    key = jax.random.PRNGKey(10)

    def jax_loss(p):
        return jax_model.loss_fn({"params": p}, (jnp.asarray(x), jnp.asarray(y)), key)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = jax_loss_draws(jax_model, key, jnp.asarray(x))
    loss = port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)), draws,
                                keep_mask=feed.port)
    loss.backward()
    assert feed.replayed == len(feed.masks)
    assert (len(feed.masks) > 0) == (arch.get("dropout", 0) > 0)
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    ref = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_grads), **arch).items()}
    assert_grads_close(port_grads(port), ref, GRAD_TOL)


def test_loss_fn_draws_dropout_masks_from_its_generator():
    """``loss_fn`` in training draws the masks from its generator after the
    loss's own draws (so the same seed gives the same loss), in eval it
    draws none; a training forward without masks raises."""
    arch = arch_of("ddpmpp")
    _, _, port = make_models("bbed", arch, seed=0)
    x, y = spec_pair(11)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    with torch.no_grad():
        a = port.loss_fn(batch, torch.Generator().manual_seed(1))
        b = port.loss_fn(batch, torch.Generator().manual_seed(1))
        c = port.loss_fn(batch, torch.Generator().manual_seed(1), train=False)
        draws = port.draw_loss_noise(batch[0], torch.Generator().manual_seed(1))
        d = port.loss_from_draws(batch, draws, train=False)
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    port.backbone.train()
    with pytest.raises(ValueError, match="keep masks"):
        port.backbone(torch.zeros(1, 2, 16, 16, dtype=torch.complex64), torch.ones(1))


def test_remat_replays_dropout_masks():
    """With ``remat`` the backward recomputes each block with the masks its
    forward drew: the gradients equal those without remat."""
    arch = arch_of("ddpmpp")
    params = random_jax_params(arch, seed=12, frames=16)
    x, t = _inputs(13)
    grads = []
    for remat in (False, True):
        model = NCSNpp(**arch, remat=remat).train()
        model.load_state_dict(state_dict_from_jax(params, **arch), strict=True)
        keep = layers.generator_keep_mask(torch.Generator().manual_seed(14))
        out = model(torch.from_numpy(x), torch.from_numpy(t), keep_mask=keep)
        out.abs().square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-6)


def test_dropout_is_flax_dropout():
    h = torch.arange(1.0, 13.0).reshape(1, 3, 2, 2)
    mask = torch.tensor([True, False] * 6).reshape(1, 3, 2, 2)
    out = layers.dropout(h, 0.25, lambda shape, keep, device: mask)
    np.testing.assert_array_equal(out.numpy(), np.where(mask, h.numpy() / 0.75, 0.0))


@pytest.mark.parametrize("up", [True, False], ids=["upsample_conv", "conv_downsample"])
def test_fir_conv_resampling_matches_jax(up):
    from diffse_tpu.ops.fir import conv_downsample_2d, upsample_conv_2d

    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 8, 10, 6)).astype(np.float32)  # NHWC
    w = rng.standard_normal((3, 3, 6, 5)).astype(np.float32)  # HWIO
    fn_j, fn_t = ((upsample_conv_2d, torch_fir.upsample_conv_2d) if up
                  else (conv_downsample_2d, torch_fir.conv_downsample_2d))
    ref = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(w), k=[1, 3, 3, 1]))
    out = fn_t(torch.from_numpy(x.transpose(0, 3, 1, 2)),
               torch.from_numpy(w.transpose(3, 2, 0, 1)), k=(1, 3, 3, 1))
    out = out.numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("with_conv", [False, True])
@pytest.mark.parametrize("fir", [False, True])
@pytest.mark.parametrize("cls", ["Upsample", "Downsample"])
def test_resampling_layers_match_jax(cls, fir, with_conv):
    """``Upsample``/``Downsample`` in all four fir x with_conv forms, on an
    odd-sized map (the naive downsample drops the last row and column; the
    strided conv pads one at the bottom and right)."""
    from diffse_tpu.models import layers as jax_layers

    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 9, 7, 4)).astype(np.float32)
    jmod = getattr(jax_layers, cls)(out_ch=6 if with_conv else None, with_conv=with_conv,
                                    fir=fir)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))
    mod = getattr(layers, cls)(4, 6 if with_conv else None, with_conv=with_conv, fir=fir)
    sd = {}
    for key, node in params.get("params", {}).items():
        kind = "firconv" if key == "Conv2d_0" else "conv"
        for n, v in convert._flax_to_torch_tensors(kind, node).items():
            sd[f"{key}.{n}"] = torch.from_numpy(np.asarray(v))
    mod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(1.0, np.max(np.abs(ref))))


def test_timestep_embedding_and_activations_match_jax():
    from diffse_tpu.models import layers as jax_layers

    t = np.asarray([0.03, 0.5, 0.999], np.float32)
    for dim in (16, 17):
        np.testing.assert_allclose(
            layers.get_timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_layers.get_timestep_embedding(jnp.asarray(t), dim)),
            rtol=0, atol=1e-6)
    v = np.linspace(-3, 3, 13).astype(np.float32)
    for name in ("elu", "relu", "lrelu", "swish"):
        np.testing.assert_allclose(layers.get_act(name)(torch.from_numpy(v)).numpy(),
                                   np.asarray(jax_layers.get_act(name)(jnp.asarray(v))),
                                   rtol=1e-6, atol=1e-7)


def test_bf16_refuses_other_configurations():
    """No configuration is refused the bf16 trunk: each builds, NCSNpp and
    NCSNppSNR, with float32 parameters and the float32 model's state_dict
    (its keys and shapes), which takes the bridged weights."""
    for name in CONFIGS:
        arch = arch_of(name)
        for cls, snr in ((NCSNpp, False), (NCSNppSNR, True)):
            model = cls(**arch, dtype="bf16")
            assert model.compute_dtype == torch.bfloat16
            sd, ref = model.state_dict(), cls(**arch).state_dict()
            assert all(v.dtype == torch.float32 for v in sd.values()), name
            assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}
            model.load_state_dict(state_dict_from_jax(
                random_jax_params(arch, 0, frames=16, snr=snr), **arch, snr_conditioning=snr),
                strict=True)


def test_default_configuration_is_the_paper_program():
    """The default's modules are the paper's: BigGAN blocks with the FIR and
    the 1/sqrt(2) residual, fused (swish), and no dropout in training."""
    model = NCSNpp(**TINY)
    blocks = [m for m in model.all_modules if isinstance(m, layers.ResnetBlockBigGANpp)]
    assert blocks and all(b.fused and b.fir and b.skip_coef == layers.SKIP_COEF
                          and b.dropout == 0 for b in blocks)
    assert not any(isinstance(m, (layers.ResnetBlockDDPMpp, layers.Upsample,
                                  layers.Downsample)) for m in model.all_modules)
    assert convert.ncsnpp_correspondence(**TINY) == convert.ncsnpp_correspondence(
        **TINY, resblock_type="biggan", progressive="output_skip",
        progressive_input="input_skip", progressive_combine="sum",
        embedding_type="fourier", resamp_with_conv=True, fir=True)
