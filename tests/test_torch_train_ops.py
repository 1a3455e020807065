"""Gradients through the port's GroupNorm kernels' ops, on the CPU.

``groupnorm_silu_conv3x3_op`` and ``groupnorm_silu_op`` (ops/cuda_kernels.py)
are autograd Functions: forward the wrapper (on the CPU its plain version),
backward the plain version recomputed. Their gradients are held to
``jax.vjp`` of the JAX package's references, ``_gn_silu_conv3x3_reference``
and ``_groupnorm_silu_jnp`` (pallas_kernels.py:330, :195), with the same
cotangent: with and without a skip, a [Cout] bias expanded over the batch
(its gradient summed over the batch), an identity skip (``skip`` is ``x``:
both gradients reach it) and bf16 activations.

Float32 within 1e-5 of each gradient's largest magnitude. bf16 within 0.05
of it (the JAX tests hold bf16 to 0.05-0.15): the JAX reference cannot be
differentiated with ``compute_dtype=bf16`` (``lax.conv_general_dilated``'s
transpose is given a bf16 and a float32 operand and raises), so the bf16 op,
whose products take the activation and the weight rounded to bf16, is held to
the JAX reference's gradient with float32 products on the same bf16 input.

Then the bf16 trunk: every float32 parameter of the tiny ``NCSNpp(dtype=
"bf16")`` gets a gradient, near the JAX package's ``dtype="bf16"`` model's
(``BF16_MODEL_TOL`` beyond that model's own bf16-vs-float32 gap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.ops.pallas_kernels import _gn_silu_conv3x3_reference, _groupnorm_silu_jnp
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from test_torch_ncsnpp import random_jax_params
from test_torch_train_loss import (SDE_KWARGS, STFT, TINY, gradient_scale, jax_grads_by_name,
                                   jax_loss_draws, port_grads, spec_pair)

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 0.05
BF16_MODEL_TOL = 0.15  # the JAX tests' bf16 atol
EPS = 1e-6


def _rel(ours, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(np.asarray(ours, np.float32) - ref)) / np.max(np.abs(ref)))


def _chain(seed, b=2, h=8, w=8, cin=16, cout=16):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((b, h, w, cin)).astype(np.float32),
                gs=(1 + 0.1 * rng.standard_normal(cin)).astype(np.float32),
                gb=(0.1 * rng.standard_normal(cin)).astype(np.float32),
                w=(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32),
                bt=(0.1 * rng.standard_normal((b, cout))).astype(np.float32),
                skip=rng.standard_normal((b, h, w, cout)).astype(np.float32),
                g=rng.standard_normal((b, h, w, cout)).astype(np.float32))


# (name, skip: None | "skip" | "identity", expanded bias, bf16)
CONV_CASES = [("no-skip", None, False, False), ("skip", "skip", False, False),
              ("expanded-bias", "skip", True, False), ("identity-skip", "identity", False, False),
              ("deep-map", "skip", False, False), ("bf16", "skip", False, True),
              ("bf16-no-skip", None, True, True)]


@pytest.mark.parametrize("name,skip,expanded,bf16", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_gn_silu_conv3x3_gradients_match_jax(name, skip, expanded, bf16):
    shape = dict(h=4, w=1) if name == "deep-map" else {}
    a = _chain(0, **shape)
    groups, coef = 4, (1 / np.sqrt(2.0) if skip else 1.0)
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    bias_row = a["bt"][:1]

    def jax_fn(x, gs, gb, w, bt, sk):
        bt = jnp.broadcast_to(bt, (x.shape[0], bt.shape[-1])) if expanded else bt
        sk = x if skip == "identity" else (sk if skip else None)
        return _gn_silu_conv3x3_reference(x, gs, gb, w, bt, sk, coef, groups, EPS, None)

    jax_args = [jnp.asarray(a["x"], dtype), jnp.asarray(a["gs"]), jnp.asarray(a["gb"]),
                jnp.asarray(a["w"]), jnp.asarray(bias_row if expanded else a["bt"]),
                jnp.asarray(a["skip"], dtype)]
    out_ref, vjp = jax.vjp(jax_fn, *jax_args)
    grads_ref = vjp(jnp.asarray(a["g"], out_ref.dtype))

    tdtype = torch.bfloat16 if bf16 else torch.float32
    x = torch.tensor(a["x"], dtype=tdtype, requires_grad=True)
    gs, gb, w = (torch.tensor(a[k], requires_grad=True) for k in ("gs", "gb", "w"))
    bt_leaf = torch.tensor(bias_row[0] if expanded else a["bt"], requires_grad=True)
    bt = bt_leaf[None].expand(x.shape[0], -1) if expanded else bt_leaf
    sk = torch.tensor(a["skip"], dtype=tdtype, requires_grad=True)
    sk_arg = x if skip == "identity" else (sk if skip else None)
    out = ck.groupnorm_silu_conv3x3_op(x, gs, gb, w, bt, groups, EPS, skip=sk_arg, skip_coef=coef)
    assert out.dtype == tdtype
    out.backward(torch.tensor(a["g"]).to(tdtype))

    tol = BF16_TOL if bf16 else F32_TOL
    assert _rel(out.float().detach().numpy(), np.asarray(out_ref, np.float32)) <= tol
    ours = [x.grad, gs.grad, gb.grad, w.grad, bt_leaf.grad[None] if expanded else bt_leaf.grad]
    for label, g, r in zip(("x", "gn_scale", "gn_bias", "w", "bias_total"), ours, grads_ref):
        assert tuple(g.shape) == tuple(r.shape), label
        assert _rel(g.float().numpy(), r) <= tol, (label, _rel(g.float().numpy(), r))
    if skip == "skip":
        assert _rel(sk.grad.float().numpy(), grads_ref[5]) <= tol
    else:
        assert sk.grad is None


@pytest.mark.parametrize("apply_silu,bf16,out_f32", [(True, False, False), (False, False, False),
                                                      (True, True, False), (False, True, True)])
def test_groupnorm_silu_gradients_match_jax(apply_silu, bf16, out_f32):
    rng = np.random.default_rng(1)
    xn = (2 * rng.standard_normal((2, 8, 4, 32)) + 1).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(32)).astype(np.float32)
    gn = rng.standard_normal(xn.shape).astype(np.float32)
    dtype = jnp.bfloat16 if bf16 else jnp.float32

    def jax_fn(x, s, b):
        out = _groupnorm_silu_jnp(x, s, b, 8, EPS, apply_silu)
        return out.astype(jnp.float32) if out_f32 else out

    out_ref, vjp = jax.vjp(jax_fn, jnp.asarray(xn, dtype), jnp.asarray(sc), jnp.asarray(bi))
    grads_ref = vjp(jnp.asarray(gn, out_ref.dtype))

    x = torch.tensor(xn, dtype=torch.bfloat16 if bf16 else torch.float32, requires_grad=True)
    s, b = torch.tensor(sc, requires_grad=True), torch.tensor(bi, requires_grad=True)
    out = ck.groupnorm_silu_op(x, s, b, 8, EPS, apply_silu,
                               out_dtype=torch.float32 if out_f32 else None)
    out.backward(torch.tensor(gn).to(out.dtype))
    tol = BF16_TOL if bf16 else F32_TOL
    for label, g, r in zip(("x", "scale", "bias"), (x.grad, s.grad, b.grad), grads_ref):
        assert _rel(g.float().numpy(), r) <= tol, (label, _rel(g.float().numpy(), r))


def test_ops_without_grad_are_the_wrappers():
    """Under ``torch.no_grad()`` (and with no input needing grad) the ops call
    the wrappers themselves: the same bits, no autograd node."""
    a = {k: torch.from_numpy(v) for k, v in _chain(2).items()}
    args = (a["x"], a["gs"], a["gb"], a["w"], a["bt"], 4)
    w = a["w"].clone().requires_grad_()
    with torch.no_grad():
        out = ck.groupnorm_silu_conv3x3_op(a["x"], a["gs"], a["gb"], w, a["bt"], 4,
                                           skip=a["skip"], skip_coef=0.5)
        norm = ck.groupnorm_silu_op(a["x"], a["gs"], a["gb"], 4)
    assert out.grad_fn is None and norm.grad_fn is None
    assert torch.equal(out, ck.groupnorm_silu_conv3x3(*args, skip=a["skip"], skip_coef=0.5))
    assert torch.equal(norm, ck.groupnorm_silu(a["x"], a["gs"], a["gb"], 4))
    with_grad = ck.groupnorm_silu_conv3x3_op(a["x"], a["gs"], a["gb"], w, a["bt"], 4,
                                             skip=a["skip"], skip_coef=0.5)
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), out)


def _bf16_models():
    kw = dict(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3", snr_conditioned="true",
              fixed_snr=0.17783, sigma_max=1.0, **STFT)
    params = random_jax_params(TINY, 1, frames=16)
    jax16 = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs={**TINY, "dtype": "bf16"},
                          sde_kwargs=SDE_KWARGS)
    jax32 = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs=TINY, sde_kwargs=SDE_KWARGS)
    port = ScoreModel(ScoreModelConfig(**kw), backbone_kwargs={**TINY, "dtype": "bf16"},
                      sde_kwargs=SDE_KWARGS, device="cpu")
    port.backbone.load_state_dict(state_dict_from_jax(params, **TINY), strict=True)
    return jax16, jax32, params, port


def test_bf16_trunk_float32_parameters_get_the_jax_gradients():
    """The bf16 trunk's float32 parameters all get a gradient (the convs' and
    dense layers' bf16 copies are cast without ``detach`` in training), near
    the JAX package's ``dtype="bf16"`` model's. That model is its training
    configuration's (flax's bf16 GroupNorm and convs: its fused bf16 chain
    has no gradient, see the module's docstring); it rounds at other points
    than the port (which follows the Pallas path's), and its own gradients
    lie up to ~2x their largest magnitude from its float32 model's. So each
    of the port's gradients is held within that JAX bf16-vs-float32 gap plus
    ``BF16_MODEL_TOL`` of the JAX bf16 gradient, each relative to the
    gradient's largest magnitude. Under ``torch.no_grad()`` the casts stay
    cached and counted as before."""
    jax16, jax32, params, port = _bf16_models()
    x, y = spec_pair(8)
    key = jax.random.PRNGKey(9)
    batch = (jnp.asarray(x), jnp.asarray(y))
    ref16 = jax.jit(jax.grad(lambda p: jax16.loss_fn({"params": p}, batch, key)[0]))(params)
    ref32 = jax.jit(jax.grad(lambda p: jax32.loss_fn({"params": p}, batch, key)[0]))(params)
    ref16, ref32 = jax_grads_by_name(ref16, False), jax_grads_by_name(ref32, False)

    ck.reset_launch_counts()
    loss = port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)),
                                jax_loss_draws(jax16, key, batch[0]))
    loss.backward()
    assert ck.weight_casts == {"gn_silu_conv3x3": 0, "conv": 0, "dense": 0}
    ours = port_grads(port)
    assert set(ours) == {n for n, p in port.backbone.named_parameters() if p.requires_grad}
    for name, g in ours.items():
        assert np.any(g != 0) or name.endswith("NIN_1.b"), f"{name}: no gradient"
        scale = gradient_scale(ref16, name)
        gap = float(np.max(np.abs(g - ref16[name]))) / scale
        jax_gap = float(np.max(np.abs(ref32[name] - ref16[name]))) / scale
        assert gap <= jax_gap + BF16_MODEL_TOL, (name, gap, jax_gap)

    with torch.no_grad():
        port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)),
                             jax_loss_draws(jax16, key, batch[0]))
        first = dict(ck.weight_casts)
        port.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)),
                             jax_loss_draws(jax16, key, batch[0]))
    assert first["conv"] > 0 and first["dense"] > 0
    assert ck.weight_casts == first  # cached: no cast on the second call
