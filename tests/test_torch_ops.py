"""The port's ops and transforms against the JAX package (float32, 1e-5).

expi, upfirdn2d (also against the numpy reference), the FIR resamplers,
STFT/iSTFT, the spectrogram transforms and padding helpers, complex noise,
and the rule that importing the port imports no JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from diffse_tpu.ops.expi import expi as jax_expi
from diffse_tpu.ops import fir as jfir
from diffse_tpu.ops.upfirdn2d import upfirdn2d as jupfirdn2d
from diffse_tpu.ops.upfirdn2d import upfirdn2d_numpy
from diffse_tpu.transforms import spec as jspec
from diffse_tpu.transforms.stft import hann_window as jax_hann_window
from diffse_tpu.transforms.stft import istft as jax_istft
from diffse_tpu.transforms.stft import stft as jax_stft
from diffse_tpu_torch.ops import fir
from diffse_tpu_torch.ops.expi import expi
from diffse_tpu_torch.ops.upfirdn2d import upfirdn2d
from diffse_tpu_torch.transforms import spec
from diffse_tpu_torch.transforms.stft import hann_window, istft, stft
from diffse_tpu_torch.utils import randn_like

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def test_expi_matches_jax_and_scipy():
    x = np.concatenate([np.linspace(-8.0, -1e-3, 97), np.linspace(1e-3, 4.0, 31)]).astype(np.float32)
    out = expi(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_expi(jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    # Against scipy on the range BBED evaluates (|x| < 2 log 2.6 < 1.92), where
    # the float32 series has no cancellation to speak of.
    near = np.abs(x) <= 2.0
    np.testing.assert_allclose(out[near], scipy.special.expi(x[near].astype(np.float64)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)), (1, 1, (-1, 2)),
                                         (2, 2, (0, 0))])
def test_upfirdn2d_matches_jax_and_numpy(up, down, pad):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    k = jfir.setup_fir_kernel([1, 3, 3, 1]) * 4.0
    out = upfirdn2d(torch.from_numpy(x), torch.from_numpy(k), up=up, down=down, pad=pad).numpy()
    ref_np = upfirdn2d_numpy(x, k, up=up, down=down, pad=pad)
    ref_jax = np.asarray(jupfirdn2d(jnp.asarray(_nchw_to_nhwc(x)), jnp.asarray(k),
                                    up=up, down=down, pad=pad))
    np.testing.assert_allclose(out, ref_np, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nchw_to_nhwc(out), ref_jax, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["upsample_2d", "downsample_2d", "naive_upsample_2d",
                                  "naive_downsample_2d"])
def test_fir_resampling_matches_jax(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    x_cl = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    if name.startswith("naive"):
        out = getattr(fir, name)(x_cl, factor=2)
        ref = getattr(jfir, name)(jnp.asarray(_nchw_to_nhwc(x)), factor=2)
    else:
        out = getattr(fir, name)(x_cl, [1, 3, 3, 1], factor=2)
        ref = getattr(jfir, name)(jnp.asarray(_nchw_to_nhwc(x)), [1, 3, 3, 1], factor=2)
    np.testing.assert_allclose(_nchw_to_nhwc(out.numpy()), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length", [63 * 128, 20000])
def test_stft_istft_match_jax(length):
    rng = np.random.default_rng(2)
    sig = (rng.standard_normal((2, length)) * 0.1).astype(np.float32)
    window_np = jax_hann_window(510)
    window = hann_window(510)
    np.testing.assert_allclose(window.numpy(), window_np, atol=1e-7)

    spec_t = stft(torch.from_numpy(sig), window)
    spec_j = np.asarray(jax_stft(jnp.asarray(sig), jnp.asarray(window_np)))
    assert spec_t.shape == spec_j.shape == (2, 256, 1 + length // 128)
    scale = np.max(np.abs(spec_j))
    assert np.max(np.abs(spec_t.numpy() - spec_j)) / scale < 1e-5

    wav_t = istft(spec_t, window).numpy()
    wav_j = np.asarray(jax_istft(jnp.asarray(spec_j), jnp.asarray(window_np)))
    assert wav_t.shape == wav_j.shape
    assert np.max(np.abs(wav_t - wav_j)) / np.max(np.abs(wav_j)) < 1e-5


@pytest.mark.parametrize("transform_type", ["exponent", "log", "none"])
def test_spec_transforms_and_padding_match_jax(transform_type):
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((1, 1, 256, 50)) + 1j * rng.standard_normal((1, 1, 256, 50)))
    s = s.astype(np.complex64)
    s[0, 0, 0, :3] = 0  # the 0/0 guard
    cfg = spec.SpecTransformConfig(transform_type=transform_type)
    jcfg = jspec.SpecTransformConfig(transform_type=transform_type)
    fwd = spec.spec_fwd(torch.from_numpy(s), cfg)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jspec.spec_fwd(jnp.asarray(s), jcfg)),
                               rtol=1e-5, atol=1e-6)
    back = spec.spec_back(fwd, cfg)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jspec.spec_back(jnp.asarray(fwd.numpy()), jcfg)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), s, rtol=1e-4, atol=1e-5)
    padded = spec.pad_spec(fwd)
    assert padded.shape[-1] == 64
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jspec.pad_spec(jnp.asarray(fwd.numpy()))))
    for n in (1, 8000, 63 * 128, 64 * 128, 16000, 24001):
        assert spec.width_bucket(n, 128) == jspec.width_bucket(n, 128)


def test_randn_like_is_complex_standard_normal():
    like = torch.zeros((4, 1, 256, 64), dtype=torch.complex64)
    z = randn_like(like, torch.Generator().manual_seed(0))
    assert z.dtype == torch.complex64 and z.shape == like.shape
    assert abs(z.real.var().item() - 0.5) < 0.02 and abs(z.imag.var().item() - 0.5) < 0.02
    again = randn_like(like, torch.Generator().manual_seed(0))
    assert torch.equal(z, again)


_BRIDGE_WITHOUT_JAX = """
import os, sys
import numpy as np
import diffse_tpu_torch.models.score_model, diffse_tpu_torch.ops.cuda_kernels
import diffse_tpu_torch.ops.fused_act, diffse_tpu_torch.models.snr_model
from diffse_tpu_torch import convert
from diffse_tpu_torch.models.ncsnpp import NCSNppSNR

# a flax-shaped tree made from the port's own module, then bridged back
arch = dict(nf=4, ch_mult=(1, 1), num_res_blocks=1, attn_resolutions=(16,), image_size=32)
model_sd = {k: v.numpy() for k, v in NCSNppSNR(**arch).state_dict().items()}
axes = {"conv": (2, 3, 1, 0), "linear": (1, 0)}
params = {}
for prefix, path, kind in convert.ncsnpp_correspondence(**arch, snr_conditioning=True):
    node = params
    for p in path:
        node = node.setdefault(p, {})
    for name, value in model_sd.items():
        if name.startswith(prefix + "."):
            leaf = name[len(prefix) + 1:]
            if kind in axes and leaf == "weight":
                node["kernel"] = value.transpose(axes[kind])
            elif kind == "groupnorm" and leaf == "weight":
                node["scale"] = value
            else:
                node[leaf] = value
sd = convert.state_dict_from_jax(params, **arch, snr_conditioning=True)
NCSNppSNR(**arch).load_state_dict(sd, strict=True)

bad = [m for m in sys.modules if m in ('jax', 'flax', 'diffse_tpu')
       or m.startswith(('jax.', 'flax.', 'diffse_tpu.'))]
assert not bad, bad
outside = [os.path.join(REPO, d) + os.sep for d in ("tools", "diffse_tpu")]
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
bad = [f for f in files if os.path.abspath(f).startswith(tuple(outside))]
assert not bad, bad
"""


def test_port_imports_no_jax():
    """Importing the port, and bridging a state_dict with its own converter,
    loads neither JAX nor any module of the JAX package or of ``tools/``."""
    code = f"REPO = {REPO!r}\n" + _BRIDGE_WITHOUT_JAX
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
