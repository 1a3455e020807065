"""Frames-parallel enhancement (``ScoreModel.enhance(seq_mesh=)``) of every
NCSN++ configuration, in float32 and in bf16, on the CPU over gloo, against
the port's one-device ``enhance`` and the JAX package's, on the same weights
(the bridge, redrawn at full size) and the JAX package's draws.

One spawned 2-rank world (a module fixture) runs ``sebridge_v2`` of each of
tests/test_torch_backbones.py's configurations in both trunks, and
``bbed_pc`` N = 3 of DDPM++, on a 7-level tiny NCSN++ at 64 frames: levels
0-5 split over the ranks (the sixth holds one frame a rank), the 1-frame
bottom level runs gathered on both, with the input pyramid there. Beside
it run the JAX references: each configuration's float32 ``enhance`` on one
device, DDPM++'s ``bbed_pc``, and for the configuration with DDPM-style
blocks and both FIR residual pyramids the JAX package's own
``enhance(seq_mesh=)`` (GSPMD) on two of the conftest's virtual devices.
Bounds: the float32 1-NFE branches within 1e-5 of max|ref| of the port's
one device and within rtol 1e-4 / atol 1e-5 of the JAX package's
(tests/test_torch_sequence.py's), the bf16 ones within a third of the
one-device bf16-vs-float32 gap of the port's one device, the PC branch
within 5e-3 of max|ref|.

Then, with no ranks, the halo arithmetic of each resampling layer on a
stand-in shard: its columns equal the whole map's, at shard bounds (0, 8),
(8, 16) and (4, 12) of 16 columns; and the plain chains' GroupNorm on a
shard equals the whole map's.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.parallel import make_seq_mesh as jax_make_seq_mesh
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.ops.fir import naive_downsample_2d
from diffse_tpu_torch.parallel import dryrun
from diffse_tpu_torch.parallel.sequence import _set_frames
import torch_sequence_workers as workers
from test_torch_backbones import CONFIGS
from test_torch_bf16 import GAP_SHARE
from test_torch_enhance import replay_pc_draws
from test_torch_sequence import JAX_TOL, ONE_NFE_TOL, PC_TOL, TIMEOUT, _pair, _rel, _StandIn

torch.set_num_threads(2)

ARCH7 = dict(nf=4, ch_mult=(1,) * 7, num_res_blocks=1, attn_resolutions=(16,),
             image_size=256)
SAMPLES = 63 * 128       # 64 frames: the width bucket pads nothing
SPEC = (1, 1, 256, 64)
PC_N = 3
GSPMD_CONFIG = "ddpm-fir-residual-noskiprescale"


def _arch(name):
    return dict(ARCH7, **CONFIGS[name])


def _wavs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.1
    return x, x + rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.05


@pytest.fixture(scope="module")
def world():
    """Every case's waveform from the 2 ranks, the port's one device and
    the JAX package."""
    cases, jax_runs = {}, {}
    for i, name in enumerate(CONFIGS):
        ref, variables, spec = _pair(_arch(name), "sebridge_v2", seed=40 + i)
        key = jax.random.PRNGKey(50 + i)
        x, y = _wavs(60 + i)
        draws = [np.asarray(jax_randn_like(key, jnp.zeros(SPEC, jnp.complex64)))]
        for dtype in (None, "bf16"):
            model = spec if dtype is None else dict(spec, backbone=dict(spec["backbone"],
                                                                        dtype=dtype))
            label = name if dtype is None else f"{name} bf16"
            cases[label] = {"kind": "enhance", "name": label, "model": model, "x": x, "y": y,
                            "draws": draws, "kwargs": {}}
        jax_runs[name] = (ref, variables, key, x, y, 30)
    ref, variables, spec = _pair(_arch("ddpmpp"), "bbed", sigma_max=0.5, seed=48)
    key = jax.random.PRNGKey(58)
    x, y = _wavs(68)
    cases["ddpmpp pc"] = {"kind": "enhance", "name": "ddpmpp pc", "model": spec, "x": x, "y": y,
                          "draws": replay_pc_draws(key, PC_N, SPEC), "kwargs": {"N": PC_N}}
    jax_runs["ddpmpp pc"] = (ref, variables, key, x, y, PC_N)

    def jax_enhance(names, seq_mesh=None):
        out = {}
        for name in names:
            ref, variables, key, x, y, n = jax_runs[name]
            kw = {} if seq_mesh is None else {"seq_mesh": seq_mesh}
            out[name if seq_mesh is None else name + " gspmd"] = np.asarray(ref.enhance(
                variables, x, y, key=key, N=n, clean_rms=1.0, noise_rms=1.0, **kw))
        return out

    names = list(jax_runs)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(dryrun.launch, workers.sequence_cases, 2, (list(cases.values()),),
                            device="cpu", timeout=TIMEOUT)
        compiled = [pool.submit(jax_enhance, names[i::3]) for i in range(3)]
        jax_out = jax_enhance([GSPMD_CONFIG], seq_mesh=jax_make_seq_mesh(n_seq=2))
        one_device = {name: workers.enhance(workers.port_model(c["model"]), c)
                      for name, c in cases.items()}
        for f in compiled:
            jax_out.update(f.result())
        ranks = ranks.result()
    return {"jax": jax_out, "one_device": one_device, "ranks": ranks}


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_enhance_matches_one_device(world, name, dtype, capsys):
    """Every rank returns the whole waveform of the port's one-device
    ``enhance`` on the same draws, the two ranks' alike. Float32 within
    1e-5 of max|ref|; bf16 within ``GAP_SHARE`` of the one-device
    bf16-vs-float32 gap: a conv over a shard's columns sums its float32
    products in another order than over the whole map's, which flips a bf16
    rounding now and then (tests/test_torch_bf16.py's bound for two bf16
    programs)."""
    label = name if dtype == "float32" else f"{name} bf16"
    ref = world["one_device"][label]
    tol = ONE_NFE_TOL
    if dtype == "bf16":
        tol = GAP_SHARE * _rel(ref, world["one_device"][name])
    waves = [res[label]["wave"] for res in world["ranks"]]
    with capsys.disabled():
        print(f"\n{label}: 2 ranks vs one device {_rel(waves[0], ref):.3e} (limit {tol:.3e})")
    for out in waves:
        assert out.shape == ref.shape == (SAMPLES,) and np.isfinite(out).all()
        assert _rel(out, ref) <= tol, (label, _rel(out, ref))
    assert np.array_equal(waves[0], waves[1])
    assert all(res[label]["graphs"] == 0 for res in world["ranks"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_enhance_matches_jax(world, name):
    """Float32 over 2 ranks, within tests/test_sequence_parallel.py's bounds
    of the JAX package's one-device ``enhance`` on the same weights and key."""
    ref = world["jax"][name]
    for res in world["ranks"]:
        np.testing.assert_allclose(res[name]["wave"], ref, **JAX_TOL)


def test_sharded_pc_matches_one_device_and_jax(world):
    """DDPM++'s ``bbed_pc`` N = 3 over 2 ranks: within 5e-3 of max|ref| of
    the port's one device and of the JAX package's."""
    for ref in (world["one_device"]["ddpmpp pc"], world["jax"]["ddpmpp pc"]):
        for res in world["ranks"]:
            out = res["ddpmpp pc"]["wave"]
            assert out.shape == ref.shape and _rel(out, ref) <= PC_TOL


def test_sharded_enhance_matches_jax_sharded(world):
    """JAX's own ``enhance(seq_mesh=make_seq_mesh(2))`` (GSPMD) of the
    configuration with DDPM-style blocks and both FIR residual pyramids, and
    the port over 2 gloo ranks."""
    ref = world["jax"][GSPMD_CONFIG + " gspmd"]
    np.testing.assert_allclose(ref, world["jax"][GSPMD_CONFIG], **JAX_TOL)
    for res in world["ranks"]:
        np.testing.assert_allclose(res[GSPMD_CONFIG]["wave"], ref, **JAX_TOL)


# ------------------------------------------------------------------ no ranks


def _map(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last)


def _resampling_layers():
    """(label, layer, output columns per input column) of each resampling
    layer of the configurations."""
    g = torch.Generator().manual_seed(0)
    return [
        ("DDPM Downsample, stride-2 conv", layers.Downsample(8, 6, with_conv=True, generator=g),
         0.5),
        ("Downsample, 2x2 mean", layers.Downsample(8), 0.5),
        ("Upsample, nearest + conv", layers.Upsample(8, 6, with_conv=True, generator=g), 2),
        ("Upsample, nearest", layers.Upsample(8), 2),
        ("FirConv2d down", layers.FirConv2d(8, 6, down=True, generator=g), 0.5),
        ("FirConv2d up", layers.FirConv2d(8, 6, up=True, generator=g), 2),
        ("Downsample, FIR + conv", layers.Downsample(8, 6, with_conv=True, fir=True,
                                                     generator=g), 0.5),
        ("Upsample, FIR + conv", layers.Upsample(8, 6, with_conv=True, fir=True, generator=g),
         2),
    ]


class _Scales(_StandIn):
    """A stand-in shard over columns ``[lo, hi)`` of the whole input map
    whose halo also serves the maps a layer makes at twice its width (the
    nearest upsample before its conv), from the whole map's upsample."""

    def __init__(self, whole, lo, hi, count):
        super().__init__(whole, lo, hi, count)
        self.up = _StandIn(layers.naive_upsample_2d(whole), 2 * lo, 2 * hi, count)

    def halo(self, t, dim, left, right, zero_edges=True):
        scale = self if t.shape[dim] == self.hi - self.lo else self.up
        return _StandIn.halo(scale, t, dim, left, right, zero_edges)


@pytest.mark.parametrize("lo,hi", [(0, 8), (8, 16), (4, 12)])
def test_resampling_on_a_stand_in_shard_gives_the_whole_maps_columns(lo, hi):
    x = _map((1, 8, 16, 16))
    for label, layer, factor in _resampling_layers():
        with torch.no_grad():
            whole = layer(x)
            with _set_frames(_Scales(x, lo, hi, 2)):
                part = layer(x[..., lo:hi])
        a, b = int(lo * factor), int(hi * factor)
        assert part.shape == whole[..., a:b].shape, label
        torch.testing.assert_close(part, whole[..., a:b], rtol=1e-5, atol=1e-5, msg=label)


def test_shard_widths_off_the_stride_raise():
    """An odd shard width would start a shard off the 2x2 mean's and the
    stride-2 convs' phase: refused, not assumed away."""
    x = _map((1, 8, 16, 15))
    shard = _StandIn(_map((1, 8, 16, 30)), 0, 15, 2)
    for fn in (lambda v: naive_downsample_2d(v, 2, frames=shard),
               lambda v: layers.Downsample(8, with_conv=True)(v),
               lambda v: layers.FirConv2d(8, 6, down=True)(v)):
        with _set_frames(shard), pytest.raises(ValueError, match="frames shard"):
            fn(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi", [(0, 8), (8, 16), (4, 12)])
def test_plain_chain_groupnorm_on_a_shard_is_the_whole_maps(lo, hi, dtype):
    """``gn_act`` (the non-swish chains' GroupNorm, rounded to the block's
    dtype, then the activation) on a shard: the statistics of the whole map
    (the shards' group sums), so its columns equal the whole map's."""
    x = _map((2, 16, 8, 16)).to(dtype)
    gn = layers.GroupNorm(16)
    with torch.no_grad():
        gn.weight.copy_(1 + 0.1 * torch.randn(16, generator=torch.Generator().manual_seed(1)))
        gn.bias.copy_(0.1 * torch.randn(16, generator=torch.Generator().manual_seed(2)))
        act = layers.get_act("elu")
        whole = layers.gn_act(gn, x, act)
        shard = _StandIn(layers.to_nhwc(x), lo, hi, 2)
        shard.sum = lambda sums: ck.gn_group_sums(layers.to_nhwc(x), gn.num_groups)
        with _set_frames(shard):
            part = layers.gn_act(gn, x[..., lo:hi], act)
    assert part.dtype == dtype
    torch.testing.assert_close(part, whole[..., lo:hi], rtol=0, atol=0)
