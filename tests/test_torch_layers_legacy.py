"""The port's legacy NCSNv1/v2 layers and normalization library against the
JAX package's, on the cases of tests/test_layers_legacy.py and the
normalization cases of tests/test_norm_and_pallas.py.

Each flax module's variables are redrawn from a numpy seed and carried over
by ``convert.flax_tree_state_dict`` (the port's modules carry the flax
names); outputs are held to 1e-5 of max(1, max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffse_tpu.models import layers_legacy as jl
from diffse_tpu.models import normalization as jn
from diffse_tpu_torch.convert import flax_tree_state_dict
from diffse_tpu_torch.models import layers_legacy as tl
from diffse_tpu_torch.models import normalization as tn

torch.set_num_threads(2)
TOL = 1e-5


def _x(rng, shape=(2, 8, 8, 16)):
    return rng.standard_normal(shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _check(jmod, tmod, jargs, targs, seed=0, **apply_kw):
    """Redraw ``jmod``'s variables, load them into ``tmod``, compare the
    outputs (NHWC against the port's NCHW)."""
    rng = np.random.default_rng(seed)
    shapes = jmod.init(jax.random.PRNGKey(0), *jargs)  # shape arguments stay static

    def draw(leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.dtype != jnp.float32:
            return np.zeros(leaf.shape, leaf.dtype)
        return z / np.sqrt(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 0.1 * z

    variables = jax.tree_util.tree_map(draw, shapes)
    ref = np.asarray(jmod.apply(variables, *jargs, **apply_kw))
    sd = {k: torch.from_numpy(v) for k, v in flax_tree_state_dict(variables.get("params", {})).items()}
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tmod(*targs).numpy().transpose(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= TOL * max(1.0, np.max(np.abs(ref)))
    return out


@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_and_rcu_blocks(rng, maxpool):
    x = _x(rng)
    _check(jl.CRPBlock(16, 2, maxpool=maxpool), tl.CRPBlock(16, 2, maxpool=maxpool),
           [jnp.asarray(x)], [_nchw(x)])
    _check(jl.RCUBlock(16, 2, 2), tl.RCUBlock(16, 2, 2), [jnp.asarray(x)], [_nchw(x)])


def test_msf_and_refine_blocks(rng):
    x1, x2 = _x(rng, (2, 8, 8, 16)), _x(rng, (2, 4, 4, 32))
    jx, tx = [jnp.asarray(x1), jnp.asarray(x2)], [_nchw(x1), _nchw(x2)]
    _check(jl.MSFBlock(24), tl.MSFBlock([16, 32], 24), [jx, (8, 8)], [tx, (8, 8)])
    out = _check(jl.RefineBlock(24), tl.RefineBlock([16, 32], 24), [jx, (8, 8)], [tx, (8, 8)])
    assert np.all(np.isfinite(out))


def test_bilinear_resize_shrinks_as_jax(rng):
    """The MSF resize also shrinks (antialiased), as ``jax.image.resize``."""
    x = _x(rng, (2, 9, 7, 3))
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 4, 11, 3), method="bilinear"))
    out = tl.bilinear_resize(_nchw(x), (4, 11)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_cond_blocks(rng):
    x = _x(rng)
    y = np.asarray([0, 1])
    jy, ty = jnp.asarray(y), torch.from_numpy(y)
    jnorm, tnorm = jn.ConditionalInstanceNorm2dPlus, tn.ConditionalInstanceNorm2dPlus
    _check(jl.CondCRPBlock(16, 2, 4, jnorm), tl.CondCRPBlock(16, 2, 4, tnorm),
           [jnp.asarray(x), jy], [_nchw(x), ty])
    _check(jl.CondRCUBlock(16, 2, 2, 4, jnorm), tl.CondRCUBlock(16, 2, 2, 4, tnorm),
           [jnp.asarray(x), jy], [_nchw(x), ty])
    # a single input: the reference assumes in_planes[0] == features
    _check(jl.CondRefineBlock(16, 4, jnorm), tl.CondRefineBlock([16], 16, 4, tnorm),
           [[jnp.asarray(x)], jy, (8, 8)], [[_nchw(x)], ty, (8, 8)])
    x2 = _x(rng, (2, 4, 4, 8))
    _check(jl.CondMSFBlock(12, 4, jnorm), tl.CondMSFBlock([16, 8], 12, 4, tnorm),
           [[jnp.asarray(x), jnp.asarray(x2)], jy, (8, 8)],
           [[_nchw(x), _nchw(x2)], ty, (8, 8)])


def test_pool_convs(rng):
    x = _x(rng)
    _check(jl.ConvMeanPool(8), tl.ConvMeanPool(16, 8), [jnp.asarray(x)], [_nchw(x)])
    _check(jl.MeanPoolConv(8), tl.MeanPoolConv(16, 8), [jnp.asarray(x)], [_nchw(x)])
    _check(jl.UpsampleConv(8), tl.UpsampleConv(16, 8), [jnp.asarray(x)], [_nchw(x)])


def test_legacy_attn_block(rng):
    x = _x(rng)
    _check(jl.AttnBlock(), tl.AttnBlock(16), [jnp.asarray(x)], [_nchw(x)])


@pytest.mark.parametrize("conv_shortcut", [False, True])
def test_legacy_resblock(rng, conv_shortcut):
    x, temb = _x(rng), rng.standard_normal((2, 12)).astype(np.float32)
    _check(jl.ResnetBlockDDPM(act=jax.nn.silu, out_ch=24, conv_shortcut=conv_shortcut),
           tl.ResnetBlockDDPM(F.silu, 16, 24, temb_dim=12, conv_shortcut=conv_shortcut).eval(),
           [jnp.asarray(x), jnp.asarray(temb)], [_nchw(x), torch.from_numpy(temb)])


def test_get_normalization_dispatch():
    assert tn.get_normalization("InstanceNorm") is tn.InstanceNorm2d
    assert tn.get_normalization("InstanceNorm++") is tn.InstanceNorm2dPlus
    assert tn.get_normalization("VarianceNorm") is tn.VarianceNorm2d
    assert tn.get_normalization("GroupNorm") is torch.nn.GroupNorm
    assert tn.get_normalization("InstanceNorm++", conditional=True,
                                num_classes=3).func is tn.ConditionalInstanceNorm2dPlus
    with pytest.raises(ValueError):
        tn.get_normalization("nope")
    with pytest.raises(NotImplementedError):
        tn.get_normalization("VarianceNorm", conditional=True)


@pytest.mark.parametrize("jcls,tcls,kw", [
    (jn.InstanceNorm2d, tn.InstanceNorm2d, {}),
    (jn.InstanceNorm2dPlus, tn.InstanceNorm2dPlus, {}),
    (jn.InstanceNorm2dPlus, tn.InstanceNorm2dPlus, {"bias": False}),
    (jn.VarianceNorm2d, tn.VarianceNorm2d, {}),
    (jn.NoneNorm2d, tn.NoneNorm2d, {}),
], ids=["instance", "instance++", "instance++-nobias", "variance", "none"])
def test_norms_match_jax(rng, jcls, tcls, kw):
    x = (rng.standard_normal((2, 8, 8, 4)) * 3 + 1).astype(np.float32)
    out = _check(jcls(**kw), tcls(4, **kw), [jnp.asarray(x)], [_nchw(x)])
    if tcls is tn.InstanceNorm2d:
        np.testing.assert_allclose(out.mean(axis=(1, 2)), 0.0, atol=1e-5)
        np.testing.assert_allclose(out.std(axis=(1, 2)), 1.0, atol=1e-2)
    if tcls is tn.NoneNorm2d:
        np.testing.assert_array_equal(out, x)


@pytest.mark.parametrize("jcls,tcls,kw", [
    (jn.ConditionalInstanceNorm2dPlus, tn.ConditionalInstanceNorm2dPlus, {}),
    (jn.ConditionalInstanceNorm2dPlus, tn.ConditionalInstanceNorm2dPlus, {"bias": False}),
    (jn.ConditionalVarianceNorm2d, tn.ConditionalVarianceNorm2d, {}),
    (jn.ConditionalNoneNorm2d, tn.ConditionalNoneNorm2d, {}),
    (jn.ConditionalNoneNorm2d, tn.ConditionalNoneNorm2d, {"bias": False}),
], ids=["instance++", "instance++-nobias", "variance", "none", "none-nobias"])
def test_conditional_norms_match_jax(rng, jcls, tcls, kw):
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    y = np.asarray([0, 3])
    out = _check(jcls(num_classes=5, **kw), tcls(4, num_classes=5, **kw),
                 [jnp.asarray(x), jnp.asarray(y)], [_nchw(x), torch.from_numpy(y)])
    assert np.all(np.isfinite(out))
