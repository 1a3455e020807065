"""The port's fused bias + LeakyReLU (K4) against the JAX package.

On the CPU ``diffse_tpu_torch.ops.fused_act.fused_bias_leaky_relu`` runs the
kernel wrapper's plain PyTorch version; it is held to the JAX op
(``diffse_tpu.ops.fused_act``) and to the Pallas kernel in interpret mode:
float32 to atol = rtol = 1e-6 (the same few float32 operations), bfloat16 to
1e-2 (the JAX op computes in bfloat16, the port in float32 rounded once).
The ``gpu`` test holds the CUDA kernel to the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.ops.fused_act import fused_bias_leaky_relu as jax_fused_bias_leaky_relu
from diffse_tpu.ops.pallas_kernels import fused_bias_leaky_relu_pallas
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.ops.fused_act import fused_bias_leaky_relu

torch.set_num_threads(2)

F32_TOL = dict(atol=1e-6, rtol=1e-6)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, b


@pytest.mark.parametrize("shape", [(16, 4), (3, 6), (5, 12), (4, 128), (2, 4, 4, 4),
                                   (3, 7, 5, 6), (1, 4, 3, 12), (1, 8, 4, 128)])
def test_plain_matches_jax_and_pallas_f32(shape):
    """C = 4, 12, 128 (the kernel's vector path) and 6 (its scalar path),
    rank 2 and rank 4."""
    x, b = _inputs(shape)
    ck.reset_launch_counts()
    out = fused_bias_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    assert ck.launch_counts["fused_bias_leaky_relu"] == 0
    ref = np.asarray(jax_fused_bias_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    pallas = np.asarray(fused_bias_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(b),
                                                     interpret=True))
    assert out.dtype == np.float32 and out.shape == shape
    np.testing.assert_allclose(out, ref, **F32_TOL)
    np.testing.assert_allclose(out, pallas, **F32_TOL)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 5, 6)])
def test_plain_matches_jax_and_pallas_bf16(shape):
    x, b = _inputs(shape, seed=1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    out = fused_bias_leaky_relu(xt, bt)
    assert out.dtype == torch.bfloat16
    xj, bj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ref = np.asarray(jax_fused_bias_leaky_relu(xj, bj).astype(jnp.float32))
    pallas = np.asarray(fused_bias_leaky_relu_pallas(xj, bj, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, **BF16_TOL)
    np.testing.assert_allclose(out.float().numpy(), pallas, **BF16_TOL)


def test_channel_axis_and_no_bias_match_jax():
    x, _ = _inputs((2, 6, 5, 4), seed=2)
    b = _inputs((6,), seed=3)[0]
    out = fused_bias_leaky_relu(torch.from_numpy(x), torch.from_numpy(b), channel_axis=1)
    ref = jax_fused_bias_leaky_relu(jnp.asarray(x), jnp.asarray(b), channel_axis=1)
    assert tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)
    out = fused_bias_leaky_relu(torch.from_numpy(x), None, negative_slope=0.1, scale=2.0)
    ref = jax_fused_bias_leaky_relu(jnp.asarray(x), None, negative_slope=0.1, scale=2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_wrapper_refuses_other_devices():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.fused_bias_leaky_relu(x, torch.empty(8, device="meta"))


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_ulps(out, ref):
    """|out - ref| in units of ref's bfloat16 spacing."""
    ref32 = ref.float()
    exp = torch.floor(torch.log2(ref32.abs().clamp_min(2.0 ** -126)))
    return ((out.float() - ref32).abs() / torch.exp2(exp - 7)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256, 64, 128), (16, 512), (3, 7, 5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_kernel_matches_plain(cuda, shape, dtype, with_bias):
    x, b = _inputs(shape, seed=3)
    xt = torch.from_numpy(x).to(cuda, dtype)
    bt = torch.from_numpy(b).to(cuda, dtype) if with_bias else None
    ck.reset_launch_counts()
    out = fused_bias_leaky_relu(xt, bt)
    ref = ck.fused_bias_leaky_relu_reference(xt, bt)
    torch.cuda.synchronize()
    assert ck.launch_counts["fused_bias_leaky_relu"] == 1
    assert out.dtype == dtype and out.shape == xt.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, **F32_TOL)
    else:
        assert _bf16_ulps(out, ref) <= 1.0


@pytest.mark.gpu
def test_kernel_channel_axis_and_misaligned(cuda):
    """A channel axis that is not last is moved last for the kernel; a view
    that is not 16-byte aligned takes the scalar path."""
    x, _ = _inputs((2, 8, 5, 4), seed=4)
    xt = torch.from_numpy(x).to(cuda)
    bt = torch.from_numpy(_inputs((8,), seed=6)[0]).to(cuda)
    out = fused_bias_leaky_relu(xt, bt, channel_axis=1)
    ref = ck.fused_bias_leaky_relu_reference(xt.movedim(1, -1), bt).movedim(-1, 1)
    torch.testing.assert_close(out, ref, **F32_TOL)
    flat = torch.from_numpy(_inputs((1, 8 * 64 + 1), seed=5)[0]).to(cuda)[0, 1:].reshape(64, 8)
    bias = torch.ones(8, device=cuda)
    torch.testing.assert_close(ck.fused_bias_leaky_relu(flat, bias),
                               ck.fused_bias_leaky_relu_reference(flat, bias), **F32_TOL)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ck.fused_bias_leaky_relu(xt.double(), None)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_bias_leaky_relu(xt.transpose(1, 2), None)
    with pytest.raises(ValueError, match="channel axis"):
        ck.fused_bias_leaky_relu(torch.ones((), device=cuda), None)
    with pytest.raises(RuntimeError, match="requires grad"):
        ck.fused_bias_leaky_relu(xt.clone().requires_grad_(), None)
