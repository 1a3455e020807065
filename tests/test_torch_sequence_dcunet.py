"""Frames-parallel DCUNet (``ScoreModel.enhance(seq_mesh=)`` with
``backbone="dcunet"``) on the CPU.

DCUNet's widths do not divide: its input is padded to ``(T - 1) % time_prod
== 0`` (64 frames become 65), its even kernels' "auto" padding widens a
stride-1 conv by a column, and its decoder takes its encoder's exact sizes.
So every level splits unevenly (``parallel.sequence.split_bounds``) and each
complex conv and transposed conv computes its rank's part of its output
from the input columns that part reaches (``FramesShard.columns``).

With no processes: ``ComplexConv2d`` and ``ComplexConvTranspose2d`` on
stand-in shards (threads of one process, their collectives met in memory,
``ThreadWorld``) of uneven widths against the whole map's columns, for each
stride, even and odd kernels, a dilation along the frames, and output
padding at the right edge (within 1e-6 of max|ref|: a conv on fewer
columns sums in the same order); whole DCUNets of each architecture, "bN"
and "CbN" ("CbN" within 1e-5: its moments summed in float64 over the
ranks); and the split is real: at 512 frames over 2 ranks each rank's first
encoder conv of DilDCUNet-v2 computes at most ``ceil(514 / 2)`` of its 514
output columns.

Over gloo (one spawned 2-rank world, ``tests/torch_sequence_workers.py``):
DCUNet-10 and DilDCUNet-v2, "bN" and "CbN", ``sebridge_v2`` (1-NFE) and
``bbed_pc`` at N = 2, each rank's waveform within ``ONE_DEVICE_TOL`` of
max|ref| of the port's one-device ``enhance`` on the same draws (the reading
printed); and DCUNet-10 "bN" ``sebridge_v2`` against the JAX package's own
``enhance(seq_mesh=make_seq_mesh(2))`` on the conftest's virtual CPU devices
(GSPMD), within tests/test_torch_sequence.py's JAX bounds.
"""

import concurrent.futures
import functools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.dcunet import DCUNet as JaxDCUNet
from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.parallel import make_seq_mesh as jax_make_seq_mesh
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import dcunet_state_dict_from_jax
from diffse_tpu_torch.models.dcunet import DCUNet
from diffse_tpu_torch.models.score_model import ScoreModelConfig
from diffse_tpu_torch.models.shared import ComplexConv2d, ComplexConvTranspose2d
from diffse_tpu_torch.parallel import dryrun
from diffse_tpu_torch.parallel.sequence import FramesShard, _set_frames, split_bounds
import torch_sequence_workers as workers
from test_torch_dcunet import jax_variables
from test_torch_enhance import SDE_KWARGS
from test_torch_sequence import JAX_TOL, TIMEOUT, _rel

torch.set_num_threads(2)

N_FFT = 256              # 129 bins: DilDCUNet-v2's dilation-8 level and DCUNet-10's strides
SAMPLES = 6000           # 47 frames, padded to 64 (65 in DCUNet)
SPEC = (1, 1, N_FFT // 2 + 1, 64)
ONE_DEVICE_TOL = 1e-5    # of max|ref|: tests/test_torch_sequence.py's ONE_NFE_TOL
LAYER_TOL = 1e-6         # of max|ref|: one conv on a part of the columns
CBN_TOL = 1e-5           # of max|ref|: "CbN"'s moments summed over the ranks


def _draw(key):
    return np.asarray(jax_randn_like(key, jnp.zeros(SPEC, jnp.complex64)))


def _wavs(seed):
    """White-noise clean and noisy waveforms (tests/test_torch_sequence.py's,
    shorter)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.1
    return x, x + rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.05


class ThreadWorld:
    """Ranks as threads of one process: ``run(fn)`` calls ``fn(rank)`` in
    ``n`` threads, each under ``torch.no_grad()`` inside a frames shard whose
    collectives meet the other threads' in memory (all-gather and
    all-reduce, as gloo's)."""

    def __init__(self, n):
        self.n, self.barrier, self.slots = n, threading.Barrier(n), [None] * n

    def _exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def run(self, fn):
        world, out, errors = self, [None] * self.n, []

        class Coll:
            def __init__(self, rank):
                self.rank = rank

            def all_gather(self, t):
                return torch.cat(world._exchange(self.rank, t.contiguous()))

            def all_reduce_(self, t):
                parts = world._exchange(self.rank, t.clone())
                return t.copy_(sum(parts[1:], parts[0]))

        def go(rank):
            try:
                with torch.no_grad(), _set_frames(FramesShard(rank, self.n, Coll(rank))):
                    out[rank] = fn(rank)
            except Exception as e:  # let the others leave the barrier
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=go, args=(r,)) for r in range(self.n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return out


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)).astype(np.complex64))


# (kernel, stride, padding, dilation), each along (frequency, frames)
CONVS = {"dcunet10-first": ((7, 5), (2, 2), (3, 2), (1, 1)),
         "stride1-odd": ((5, 3), (2, 1), (2, 1), (1, 1)),
         "even-auto": ((4, 4), (1, 1), (2, 2), (1, 1)),
         "even-stride2": ((4, 4), (2, 2), (2, 2), (8, 1)),
         "frames-dilation": ((3, 3), (1, 1), (1, 2), (1, 2))}
# a width's split over the ranks: split_bounds, or a lopsided one
SPLITS = {"even2": lambda w: split_bounds(w, 2), "lopsided3": lambda w: (0, 4, w - 6, w)}


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_complex_conv_on_uneven_shards(conv, split):
    k, s, p, d = CONVS[conv]
    layer = ComplexConv2d(3, 5, k, s, p, d, bias=True, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        layer.re.bias.normal_(generator=torch.Generator().manual_seed(2))
        x = _complex((2, 3, 33, 19), 3)
        ref = layer(x)
        bounds = SPLITS[split](19)
        out = layer.out_bounds(bounds)
        assert out[-1] == ref.shape[3]
        parts = ThreadWorld(len(bounds) - 1).run(
            lambda r: layer(x[..., bounds[r]:bounds[r + 1]], bounds))
    assert [q.shape[3] for q in parts] == list(np.diff(out))
    assert _rel(torch.cat(parts, -1).numpy(), ref.numpy()) <= LAYER_TOL


@pytest.mark.parametrize("output_padding", [0, 1])
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_complex_conv_transpose_on_uneven_shards(conv, output_padding):
    """The transposed conv to ``output_size`` (its output padding reaching
    the rank at the global right edge only), on shards of a width that
    does not divide."""
    k, s, p, d = CONVS[conv]
    layer = ComplexConvTranspose2d(3, 5, k, s, p, dilation=d, bias=True,
                                   generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        layer.b_re.normal_(generator=torch.Generator().manual_seed(5))
        x = _complex((2, 3, 9, 11), 6)
        width = layer.out_width(11, 0) + output_padding
        size = ((9 - 1) * s[0] - 2 * p[0] + d[0] * (k[0] - 1) + 1, width)
        ref = layer(x, output_size=size)
        bounds = split_bounds(11, 2)
        parts = ThreadWorld(2).run(
            lambda r: layer(x[..., bounds[r]:bounds[r + 1]], output_size=size, bounds=bounds))
    assert [q.shape[3] for q in parts] == list(np.diff(split_bounds(width, 2)))
    assert _rel(torch.cat(parts, -1).numpy(), ref.numpy()) <= LAYER_TOL


# (architecture, keywords, F, ranks)
FORWARDS = {"dcunet10-bN": ("DCUNet-10", {}, 33, 2),
            "dcunet10-CbN-4": ("DCUNet-10", dict(dcunet_norm_type="CbN"), 33, 4),
            "dildcunet-bN-4": ("DilDCUNet-v2", {}, 129, 4),
            "dildcunet-CbN-trim": ("DilDCUNet-v2", dict(dcunet_norm_type="CbN",
                                                        dcunet_fix_length="trim"), 129, 2),
            "dcunet16": ("DCUNet-16", {}, 257, 2),
            "dcunet20": ("DCUNet-20", {}, 257, 2)}


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_dcunet_forward_on_shards_matches_one_device(name):
    """A whole DCUNet (its default weights, running statistics redrawn) on
    shards of 64 frames, each rank handed its equal part as ``enhance``
    hands it: the ranks' outputs are the one-device output's columns."""
    arch, kw, f, n = FORWARDS[name]
    model = DCUNet(dcunet_architecture=arch, **kw, generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for buf_name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5 if buf_name.endswith("var")
                      else 0.1 * torch.randn(buf.shape, generator=g))
    model.eval()
    x, t = _complex((1, 2, f, 64), 9), torch.tensor([0.4])
    with torch.no_grad():
        ref = model(x, t)
        parts = ThreadWorld(n).run(lambda r: model(x[..., r * 64 // n:(r + 1) * 64 // n], t))
    tol = CBN_TOL if kw.get("dcunet_norm_type") == "CbN" else LAYER_TOL
    assert _rel(torch.cat(parts, -1).numpy(), ref.numpy()) <= tol


def test_the_split_is_real():
    """512 frames over 2 ranks: DilDCUNet-v2's first encoder conv (its 513
    padded frames, a 4-wide kernel, padding 2: 514 output columns) computes
    at most ceil(514 / 2) columns on each rank, 514 in all."""
    model = DCUNet(dcunet_architecture="DilDCUNet-v2",
                   generator=torch.Generator().manual_seed(10)).eval()
    widths = {}
    model.encoder_0.conv.register_forward_hook(
        lambda mod, args, y: widths.update({threading.get_ident(): y.shape[3]}))
    x, t = _complex((1, 2, 129, 512), 11), torch.tensor([0.6])
    with torch.no_grad():
        ThreadWorld(2).run(lambda r: model(x[..., r * 256:(r + 1) * 256], t))
    whole = model.encoder_0.conv.out_width(513)
    assert whole == 514
    assert sorted(widths.values()) == [257, 257] and max(widths.values()) <= math.ceil(whole / 2)


# ------------------------------------------------------------ gloo ranks

# (name, architecture, norm, model_type, sigma_max, enhance keywords)
CASES = [(f"{a}-{norm}-{branch}", a, norm, mt, sm, kw)
         for a in ("DCUNet-10", "DilDCUNet-v2") for norm in ("bN", "CbN")
         for branch, mt, sm, kw in (("v2", "sebridge_v2", 1.0, {}),
                                    ("pc", "bbed", 0.5, {"N": 2}))]


@functools.lru_cache(maxsize=None)
def _variables(arch, norm, seed):
    """A JAX DCUNet's seeded variables (one set for both branches of an
    architecture and norm)."""
    x = np.zeros((1, 2, SPEC[2], SPEC[3] + 1), np.complex64)
    return jax_variables(JaxDCUNet(dcunet_architecture=arch, dcunet_norm_type=norm), x,
                         np.zeros((1,), np.float32), seed)


def _spec_and_jax(arch, norm, model_type, sigma_max, seed):
    """The JAX ScoreModel over a DCUNet with seeded variables, its
    variables, and the port's model spec on the same weights."""
    kw = dict(dcunet_architecture=arch, dcunet_norm_type=norm)
    cfg = JaxScoreModelConfig(backbone="dcunet", sde="bbed", model_type=model_type,
                              sigma_max=sigma_max, t_eps=3e-2, n_fft=N_FFT)
    sde = dict(SDE_KWARGS, N=30)
    variables = _variables(arch, norm, seed)
    spec = {"config": {f: getattr(cfg, f) for f in ScoreModelConfig.__dataclass_fields__},
            "backbone": kw, "sde": sde, "weights": dcunet_state_dict_from_jax(variables)}
    return JaxScoreModel(cfg, backbone_kwargs=kw, sde_kwargs=sde), variables, spec


@pytest.fixture(scope="module")
def world():
    """Every case's waveform over 2 gloo ranks and on one device, and the
    JAX package's sharded enhance of the first (compiled in a thread beside
    the ranks)."""
    cases, jax_ref = [], None
    for i, (name, arch, norm, model_type, sigma_max, kw) in enumerate(CASES):
        ref, variables, spec = _spec_and_jax(arch, norm, model_type, sigma_max,
                                             seed=20 + i // 2)
        x, y = _wavs(30 + i)
        key = jax.random.PRNGKey(40)
        draws = [_draw(key)] if i == 0 else 50 + i  # JAX's draws, or a seed's
        cases.append({"kind": "enhance", "name": name, "model": spec, "x": x, "y": y,
                      "draws": draws, "kwargs": kw})
        if i == 0:
            jax_ref = (ref, variables, x, y, key)

    def jax_sharded():
        ref, variables, x, y, key = jax_ref
        return np.asarray(ref.enhance(variables, x, y, key=key, clean_rms=1.0, noise_rms=1.0,
                                      seq_mesh=jax_make_seq_mesh(n_seq=2)))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(dryrun.launch, workers.sequence_cases, 2, (cases,), device="cpu",
                            timeout=TIMEOUT)
        sharded = pool.submit(jax_sharded)
        one_device = {c["name"]: workers.enhance(workers.port_model(c["model"]), c)
                      for c in cases}
        return {"ranks": ranks.result(), "one_device": one_device, "jax": sharded.result()}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_dcunet_enhance_matches_one_device(world, name, capsys):
    ref = world["one_device"][name]
    gaps = []
    for res in world["ranks"]:
        out = res[name]["wave"]
        assert out.shape == ref.shape == (SAMPLES,) and np.isfinite(out).all()
        assert res[name]["graphs"] == 0
        gaps.append(_rel(out, ref))
    with capsys.disabled():
        print(f"\n{name}: 2 gloo ranks vs one device, max|diff|/max|ref| "
              f"{', '.join(f'{g:.3e}' for g in gaps)} (tol {ONE_DEVICE_TOL})")
    assert max(gaps) <= ONE_DEVICE_TOL
    waves = [res[name]["wave"] for res in world["ranks"]]
    assert all(np.array_equal(w, waves[0]) for w in waves)


def test_sharded_dcunet_matches_jax_sharded(world):
    """DCUNet-10 "bN" ``sebridge_v2``: the JAX package's sharded program
    (GSPMD over 2 virtual CPU devices) and the port over 2 gloo ranks, on
    the same weights and draws."""
    name = CASES[0][0]
    for res in world["ranks"]:
        np.testing.assert_allclose(res[name]["wave"], world["jax"], **JAX_TOL)
