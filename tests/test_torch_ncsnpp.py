"""The port's NCSN++ (and its SNR-conditioned variant) against the JAX
package's, weights carried over by the bridge
(``diffse_tpu_torch.convert.state_dict_from_jax``).

The JAX side runs the configuration whose maths the port's kernels follow:
``use_pallas_groupnorm=True, fuse_pyramid=True`` (its Pallas GroupNorm+SiLU
kernel in interpret mode, its fused-chain reference otherwise). Forward
parity is held to 1e-5 relative to max|ref|.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.layers import GaussianFourierProjection as JaxGFP
from diffse_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffse_tpu.models.ncsnpp import NCSNppSNR as JaxNCSNppSNR
from diffse_tpu_torch import convert
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.models.ncsnpp import NCSNpp, NCSNppSNR
from diffse_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

# small but full height: F=256, 5 levels, attention at 16 (every feature of
# the enhance path is live)
ARCH = dict(nf=4, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, attn_resolutions=(16,),
            image_size=256)
JAX_FLAGS = dict(use_pallas_groupnorm=True, fuse_pyramid=True)
# the production widths (nf 128: 32 GroupNorm groups, a 384-channel concat of
# group width 12, attention at 256 channels) at two levels and a 32x32 map
WIDE_ARCH = dict(nf=128, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                 image_size=32)
# the production depth (7 levels, 2 blocks each, down to 1x1 maps on a 64x64
# input) at narrow widths
DEEP_ARCH = dict(nf=16, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2,
                 attn_resolutions=(16,), image_size=64)


def jax_param_shapes(arch, frames=64, snr=False):
    """The JAX NCSN++'s (or NCSNppSNR's) param tree as shapes, from
    ``jax.eval_shape`` of its init, so nothing is compiled."""
    x = jnp.zeros((1, 2, 256, frames), jnp.complex64)
    t = jnp.ones((1,), jnp.float32)
    if snr:
        return jax.eval_shape(JaxNCSNppSNR(**arch).init, jax.random.PRNGKey(0), x, t, t)["params"]
    return jax.eval_shape(JaxNCSNpp(**arch).init, jax.random.PRNGKey(0), x, t)["params"]


def random_jax_params(arch, seed, frames=64, snr=False):
    """A seeded random flax param tree of the JAX NCSN++ (or NCSNppSNR).
    Kernels are drawn at 1/sqrt(fan_in), GroupNorm scales near 1, biases
    small: every path is live, where the default init zeroes every block's
    last conv and every pyramid head."""
    shapes = jax_param_shapes(arch, frames, snr)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * z
        if leaf.ndim == 1:
            return 0.1 * z
        return z / np.sqrt(np.prod(leaf.shape[:-1]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_params():
    return random_jax_params(ARCH, seed=1)


def _inputs(seed, batch, frames, freqs=256):
    rng = np.random.default_rng(seed)
    shape = (batch, 2, freqs, frames)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    t = rng.uniform(0.05, 0.99, size=(batch,)).astype(np.float32)
    return x, t


def load_tools_converter():
    """The JAX side's converter, ``tools/convert_torch_checkpoint.py``, by path
    (numpy only at module level)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "convert_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("convert_torch_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_state_dict_matches_converter_walk(jax_params):
    """The port's all_modules indices are the converter's: the bridged
    state_dict loads with strict=True, and every key and shape agrees."""
    model = NCSNpp(**ARCH)
    sd = state_dict_from_jax(jax_params, **ARCH)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    model.load_state_dict(sd, strict=True)
    corr = load_tools_converter().ncsnpp_correspondence(**ARCH)
    assert corr[-1][0] == "output_layer"
    assert len(model.all_modules) == int(corr[-2][0].split(".")[1]) + 1


@pytest.mark.parametrize("arch", [{}, ARCH], ids=["production", "tiny"])
def test_walk_matches_tools_walk(arch):
    """The port's own copy of the walk gives the tools walk's keys and arrays,
    for the production 65M arch and the tiny one."""
    shapes = jax_param_shapes(arch)
    offset = [0]

    def fill(leaf):  # distinct values, so a wrong transpose shows
        n = int(np.prod(leaf.shape))
        offset[0] += n
        return (np.arange(n, dtype=np.float32) + offset[0] - n).reshape(leaf.shape)

    params = jax.tree_util.tree_map(fill, shapes)
    tools = load_tools_converter()
    corr = convert.ncsnpp_correspondence(**arch)
    assert corr == tools.ncsnpp_correspondence(**arch)
    ours = convert.convert_flax_to_state_dict(params, corr)
    ref = tools.convert_flax_to_state_dict(params, tools.ncsnpp_correspondence(**arch))
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def _flax_leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("arch", [{}, ARCH], ids=["production", "tiny"])
def test_snr_walk_covers_the_flax_tree(arch):
    """The SNR walk reads every leaf of NCSNppSNR's flax tree exactly once,
    and emits exactly the port's NCSNppSNR state_dict keys and shapes."""
    shapes = jax_param_shapes(arch, snr=True)
    corr = convert.ncsnpp_correspondence(**arch, snr_conditioning=True)
    read = []
    for _, flax_path, _ in corr:
        node = shapes
        for p in flax_path:
            node = node[p]
        read += [flax_path + (k,) for k in node if not isinstance(node[k], dict)]
    assert sorted(read) == sorted(_flax_leaf_paths(shapes))
    model_sd = NCSNppSNR(**arch).state_dict()
    keys = set()
    for prefix, flax_path, kind in corr:
        node = shapes
        for p in flax_path:
            node = node[p]
        keys |= {f"{prefix}.{name}" for name in convert._flax_to_torch_tensors(
            kind, {k: np.zeros(v.shape) for k, v in node.items()})}
    assert keys == set(model_sd)


def test_snr_forward_matches_jax():
    """NCSNppSNR (dual embedding, semb into every block's first conv bias or
    after its Conv_0, output / noise level) on the tiny arch, 1e-5."""
    params = random_jax_params(ARCH, seed=12, snr=True)
    x, t = _inputs(13, 2, 64)
    s = np.asarray([0.07, 0.6], np.float32)
    ref = np.asarray(jax.jit(JaxNCSNppSNR(**ARCH, **JAX_FLAGS).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(s)))
    model = NCSNppSNR(**ARCH)
    model.load_state_dict(state_dict_from_jax(params, **ARCH, snr_conditioning=True),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(s)).numpy()
    assert out.shape == ref.shape == (2, 1, 256, 64)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-5


def test_forward_matches_jax(jax_params):
    batch = 2
    x, t = _inputs(0, batch, 64)
    ref = np.asarray(jax.jit(JaxNCSNpp(**ARCH, **JAX_FLAGS).apply)(
        {"params": jax_params}, jnp.asarray(x), jnp.asarray(t)))
    model = NCSNpp(**ARCH)
    model.load_state_dict(state_dict_from_jax(jax_params, **ARCH), strict=True)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert not any(ck.launch_counts.values())
    assert out.shape == ref.shape == (batch, 1, 256, 64)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-5


def test_forward_matches_jax_full_width():
    """The production channel widths, at a depth and map size the CPU runs
    in seconds."""
    _check_square_forward(WIDE_ARCH, groups={32}, seeds=(6, 7))


def test_forward_matches_jax_full_depth():
    """The production depth and blocks per level, at narrow widths."""
    _check_square_forward(DEEP_ARCH, groups={4, 8, 12, 16}, seeds=(8, 9))


def _check_square_forward(arch, groups, seeds):
    """Port vs JAX on an ``image_size`` x ``image_size`` input."""
    size = arch["image_size"]
    params = random_jax_params(arch, seed=seeds[0])
    x, t = _inputs(seeds[1], 1, size, freqs=size)
    ref = np.asarray(jax.jit(JaxNCSNpp(**arch, **JAX_FLAGS).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = NCSNpp(**arch)
    model.load_state_dict(state_dict_from_jax(params, **arch), strict=True)
    assert {m.GroupNorm_0.num_groups for m in model.all_modules
            if isinstance(m, layers.ResnetBlockBigGANpp)} == groups
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert out.shape == ref.shape == (1, 1, size, size)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 1e-5


def test_fused_conv_weights_are_hwio_views(jax_params):
    """The convs that only the fused kernel runs keep HWIO memory, so the
    kernel's weight is a view, through loading, deepcopy and ``.to()``; the
    state_dict keeps the reference's OIHW shapes."""
    model = NCSNpp(**ARCH)
    model.load_state_dict(state_dict_from_jax(jax_params, **ARCH), strict=True)
    model = copy.deepcopy(model).double().float()  # .to() makes new tensors
    fused = [m for m in model.all_modules
             if isinstance(m, layers.ResnetBlockBigGANpp) and not (m.up or m.down)]
    convs = [c for m in fused for c in (m.Conv_0, m.Conv_1)] + [
        m for i, m in enumerate(model.all_modules)
        if isinstance(m, torch.nn.Conv2d) and m.out_channels == 4 and m.kernel_size == (3, 3)
        and isinstance(model.all_modules[i - 1], layers.GroupNorm)]
    assert len(fused) > 0 and len(convs) == 2 * len(fused) + len(ARCH["ch_mult"])
    for conv in convs:
        assert layers.conv_hwio(conv).data_ptr() == conv.weight.data_ptr()
        assert conv.weight.shape[2:] == (3, 3)
    np.testing.assert_array_equal(
        layers.conv_hwio(convs[0]).detach().numpy(),
        convs[0].weight.detach().numpy().transpose(2, 3, 1, 0))


def test_gaussian_fourier_projection_matches_jax():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal(8) * 16).astype(np.float32)
    t = np.log(np.asarray([0.03, 0.5, 0.999], np.float32))
    ref = JaxGFP(embedding_size=8, scale=16.0).apply({"params": {"W": w}}, jnp.asarray(t))
    gfp = layers.GaussianFourierProjection(8, scale=16.0)
    gfp.W.data.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(gfp(torch.from_numpy(t)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert not gfp.W.requires_grad


def test_default_init_is_seeded_and_ddpm_scaled():
    a = NCSNpp(**ARCH, generator=torch.Generator().manual_seed(3)).state_dict()
    b = NCSNpp(**ARCH, generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # init_scale=0: every block's last conv starts (numerically) at zero
    assert a["all_modules.4.Conv_1.weight"].abs().max() < 1e-4
    assert a["all_modules.4.Conv_0.weight"].abs().max() > 1e-2


@pytest.mark.slow
def test_forward_matches_jax_65m():
    """The full 65M configuration at F=256, T=64."""
    params = random_jax_params({}, seed=2)
    x, t = _inputs(5, 1, 64)
    ref = np.asarray(jax.jit(JaxNCSNpp(**JAX_FLAGS).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t)))
    model = NCSNpp()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
    print(f"65M NCSN++ forward, port vs JAX: relative error {err:.3e}")
    assert err < 1e-5


@pytest.mark.slow
def test_snr_forward_matches_jax_65m():
    """The full-width SNR-conditioned NCSN++ at F=256, T=64."""
    params = random_jax_params({}, seed=3, snr=True)
    x, t = _inputs(6, 1, 64)
    s = np.asarray([0.2], np.float32)
    ref = np.asarray(jax.jit(JaxNCSNppSNR(**JAX_FLAGS).apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(s)))
    model = NCSNppSNR()
    model.load_state_dict(state_dict_from_jax(params, snr_conditioning=True), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(s)).numpy()
    err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
    print(f"65M NCSNppSNR forward, port vs JAX: relative error {err:.3e}")
    assert err < 1e-5
