"""Frames-parallel enhancement (``diffse_tpu_torch.parallel.sequence``,
``ScoreModel.enhance(seq_mesh=)``, ``cli.eval --seq_shards``) on the CPU over
gloo, against the port's one-device ``enhance`` and the JAX package's
(one-device, and for a 1-NFE case its own ``enhance(seq_mesh=)`` on the
conftest's virtual CPU devices), on the same weights (the bridge) and the
JAX package's draws.

Two spawned worlds, each running all of its cases once (a module fixture):
2 ranks (a tiny 3-level NCSN++ at 128 frames: ``sebridge_v2``,
``sebridge_v3_snr``, ``bbed_pc`` N=3 with ALD and with Langevin,
``bbed_ode``'s start and first step attempts (its RK45 norms reduced over
the ranks), ``sebridge``, ``sebridge_v2_snr`` (the noise level a maximum
over the ranks), a custom axis name, and ``cli.eval --seq_shards 2``) and 4
ranks (a 7-level tiny NCSN++ at 128 frames, whose 2-frame bottom level runs
gathered on every rank; ``bbed_pc`` N=3; ``make_seq_mesh`` past the world).
Tolerances: the 1-NFE branches within 1e-5 of max|ref| of the port's
one-device output and within rtol 1e-4 / atol 1e-5 of the JAX package's
(tests/test_sequence_parallel.py); the PC branches within 5e-3 of max|ref|
of both; ``bbed_ode``'s state within 1e-4 of max|ref| of the port's
one-device solver's (tests/test_torch_ode.py's bound), with the same
accepted and rejected attempts (a whole ODE solve, ~100 evaluations, would
take most of the file's time).

Then, with no ranks: the split statistics and the kernels' given affine
(``ab=``) in their plain versions, the halo arithmetic of the fused conv and
the FIR resampling on a stand-in shard, and the key of a mesh (DCUNet:
tests/test_torch_sequence_dcunet.py).
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.models.snrnet import SNRNet as JaxSNRNet
from diffse_tpu.parallel import make_seq_mesh as jax_make_seq_mesh
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
from diffse_tpu_torch.models import layers
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.ops.fir import downsample_2d, upsample_2d
from diffse_tpu_torch.parallel import dryrun
from diffse_tpu_torch.parallel.sequence import FrameLevels, _set_frames, mesh_key
from diffse_tpu_torch.train import CheckpointManager, TrainState
import torch_sequence_workers as workers
from test_torch_enhance import ARCH, FIXED_SNR, SDE_KWARGS, replay_pc_draws
from test_torch_ncsnpp import random_jax_params
from test_torch_snr import port_snrnet, random_snrnet_params

torch.set_num_threads(2)

ARCH7 = dict(ARCH, ch_mult=(1,) * 7)
SAMPLES = 12000          # 94 frames, padded to 128
SPEC = (1, 1, 256, 128)
ONE_NFE_TOL = 1e-5       # of max|ref|, against the port's one-device output
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
PC_TOL = 5e-3            # of max|ref|: reduction order compounds over the steps
ODE_TOL = 1e-4
ODE_ATTEMPTS = 2         # bbed_ode's start (2 NFE) and 2 step attempts (12 NFE)
TIMEOUT = 400.0


def _wavs(seed):
    """White-noise clean and noisy waveforms, as the JAX test draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.1
    return x, x + rng.standard_normal((1, SAMPLES)).astype(np.float32) * 0.05


def _harmonic(seed):
    """A harmonic clean waveform and the same plus white noise (SNRNet's
    estimate inside the Karras grid)."""
    rng = np.random.default_rng(seed)
    t = np.arange(SAMPLES) / 16000
    clean = 0.3 * np.sin(2 * np.pi * 190 * t) * (0.2 + np.abs(np.sin(2 * np.pi * 3 * t)))
    noisy = clean + 0.05 * rng.standard_normal(SAMPLES)
    return clean[None].astype(np.float32), noisy[None].astype(np.float32)


def _pair(arch, model_type, sigma_max=1.0, snr_conditioned="false", snr_params=None, seed=5,
          backbone="ncsnpp"):
    """The JAX model (its plain NCSN++ path, which GSPMD shards), its
    variables, and the port's model spec on the same weights."""
    snr = backbone == "ncsnpp_snr"
    params = random_jax_params(arch, seed=seed, snr=snr)
    cfg = JaxScoreModelConfig(backbone=backbone, sde="bbed", model_type=model_type,
                              snr_conditioned=snr_conditioned, fixed_snr=FIXED_SNR,
                              sigma_max=sigma_max, t_eps=3e-2)
    sde = dict(SDE_KWARGS, N=30)
    ref = JaxScoreModel(cfg, backbone_kwargs=arch, sde_kwargs=sde,
                        snr_model=None if snr_params is None else (JaxSNRNet(),
                                                                   {"params": snr_params}))
    spec = {"config": {f: getattr(cfg, f) for f in ScoreModelConfig.__dataclass_fields__},
            "backbone": dict(arch), "sde": sde,
            "weights": state_dict_from_jax(params, **arch, snr_conditioning=snr),
            "snr_weights": None if snr_params is None else port_snrnet(snr_params).state_dict()}
    return ref, {"params": params}, spec


def _draw(key):
    return np.asarray(jax_randn_like(key, jnp.zeros(SPEC, jnp.complex64)))


def _eval_setup(root):
    """A 3-file test set of 0.5 s (64 frames) and a tiny bbed checkpoint."""
    data = make_synthetic_dataset(str(root / "data"), num_train=1, num_valid=1, num_valid2=1,
                                  num_test=3, duration_s=0.5)
    cfg = ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                           fixed_snr=FIXED_SNR, sigma_max=1.0)
    model = ScoreModel(cfg, backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(state_dict_from_jax(random_jax_params(ARCH, seed=9), **ARCH))
    ckpt = str(root / "ckpt")
    CheckpointManager(ckpt, hparams=model.hparams).save(0, TrainState(model.backbone), {})
    return os.path.join(data, "test"), ckpt


def _eval_argv(test_dir, ckpt, out_dir, *extra):
    return ["--destination_folder", out_dir, "--test_dir", test_dir, "--ckpt", ckpt,
            "--device", "cpu", "--N", "2", *extra]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's inputs and references; the 2- and the 4-rank worlds run
    (each once, both in threads beside the references' JAX compiles, which
    run in threads of their own)."""
    root = tmp_path_factory.mktemp("seq")
    test_dir, ckpt = _eval_setup(root)
    snr_params = random_snrnet_params(seed=11, fc_bias=-2.0)
    cases, jax_runs = {}, {}

    def case(name, pair, waves, draws, key=None, axis="seq", **kwargs):
        ref, variables, spec = pair
        x, y = waves
        cases[name] = {"kind": "enhance", "name": name, "model": spec, "x": x, "y": y,
                       "draws": draws, "kwargs": kwargs, "axis": axis}
        if key is not None:
            jax_runs[name] = (ref, variables, key)

    v2 = _pair(ARCH, "sebridge_v2")
    bbed = _pair(ARCH, "bbed", sigma_max=0.5)
    key = jax.random.PRNGKey(3)
    case("v2", v2, _wavs(0), [_draw(key)], key)
    key = jax.random.PRNGKey(17)
    case("v3snr", _pair(ARCH, "sebridge_v3", snr_conditioned="true", snr_params=snr_params),
         _harmonic(5), [_draw(key)], key)
    key = jax.random.PRNGKey(11)
    case("pc", bbed, _wavs(1), replay_pc_draws(key, 3, SPEC), key, N=3)
    case("langevin", bbed, _wavs(2), 4, corrector="langevin", N=2)
    case("axis", v2, _wavs(4), [_draw(jax.random.PRNGKey(9))], axis="frames")
    case("sebridge", _pair(ARCH, "sebridge", sigma_max=0.5), _wavs(5), [])
    case("v2snr", _pair(ARCH, "sebridge_v2", snr_conditioned="true", backbone="ncsnpp_snr"),
         _harmonic(8), [_draw(jax.random.PRNGKey(27))], oracle=True, clean_rms=1.0,
         noise_rms=0.07)
    key = jax.random.PRNGKey(21)
    case("v2_seven", _pair(ARCH7, "sebridge_v2"), _wavs(6), [_draw(key)], key)
    key = jax.random.PRNGKey(23)
    case("pc_four", bbed, _wavs(7), replay_pc_draws(key, 3, SPEC), key, N=3)
    eval_argv = _eval_argv(test_dir, ckpt, str(root / "sharded"), "--seq_shards", "2")
    _, y = _wavs(3)
    ode = {"kind": "ode_steps", "name": "ode", "model": bbed[2], "y": y, "draws": 5,
           "attempts": ODE_ATTEMPTS}
    two = [cases[n] for n in ("v2", "v3snr", "pc", "langevin", "axis", "sebridge", "v2snr")]
    two.append(ode)
    two.append({"kind": "eval", "name": "eval", "argv": eval_argv})
    four = [cases["v2_seven"], cases["pc_four"], {"kind": "too_many", "name": "too_many"}]

    def jax_enhance(*names, seq_mesh=None):
        """The JAX package's enhance of each named case, in turn (the cases of
        one JAX model share its compiled program)."""
        out = {}
        for name in names:
            ref, variables, key = jax_runs[name]
            c = cases[name]
            kw = {"seq_mesh": seq_mesh} if seq_mesh is not None else {}
            out[name if seq_mesh is None else name + "_sharded"] = np.asarray(ref.enhance(
                variables, c["x"], c["y"], key=key, N=c["kwargs"].get("N", 30), clean_rms=1.0,
                noise_rms=1.0, **kw))
        return out

    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        launched = {n: pool.submit(dryrun.launch, workers.sequence_cases, n, (world,),
                                   device="cpu", timeout=TIMEOUT)
                    for n, world in ((2, two), (4, four))}
        # the JAX programs compile side by side (XLA's compiler leaves the GIL)
        compiled = [pool.submit(jax_enhance, "v2", "v3snr"),
                    pool.submit(jax_enhance, "pc", "pc_four"),
                    pool.submit(jax_enhance, "v2_seven")]
        jax_out = jax_enhance("v2", seq_mesh=jax_make_seq_mesh(n_seq=2))
        one_device = {name: workers.enhance(workers.port_model(c["model"]), c)
                      for name, c in cases.items()}
        one_device["ode"] = workers.ode_steps(workers.port_model(bbed[2]), ode)
        from diffse_tpu_torch.cli import eval as eval_cli

        eval_cli.main(_eval_argv(test_dir, ckpt, str(root / "whole")))
        for f in compiled:
            jax_out.update(f.result())
        ranks = {n: f.result() for n, f in launched.items()}
    return {"cases": cases, "jax": jax_out, "one_device": one_device, "ranks": ranks,
            "root": root}


def _rel(out, ref):
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


def _world_of(name):
    return 4 if name in ("v2_seven", "pc_four") else 2


@pytest.mark.parametrize("name,tol", [("v2", ONE_NFE_TOL), ("v3snr", ONE_NFE_TOL),
                                      ("pc", PC_TOL), ("langevin", PC_TOL),
                                      ("axis", ONE_NFE_TOL), ("sebridge", ONE_NFE_TOL),
                                      ("v2snr", ONE_NFE_TOL), ("v2_seven", ONE_NFE_TOL),
                                      ("pc_four", PC_TOL)])
def test_sharded_enhance_matches_one_device(worlds, name, tol):
    """Every rank returns the whole waveform of the port's one-device
    ``enhance`` on the same draws."""
    ref = worlds["one_device"][name]
    ranks = worlds["ranks"][_world_of(name)]
    for res in ranks:
        out = res[name]["wave"]
        assert out.shape == ref.shape == (SAMPLES,) and np.isfinite(out).all()
        assert _rel(out, ref) <= tol, (name, _rel(out, ref))
    # the ranks gather the same frames: one waveform
    assert all(np.array_equal(res[name]["wave"], ranks[0][name]["wave"]) for res in ranks)


def test_sharded_ode_steps_match_one_device(worlds):
    """``bbed_ode``'s start and first attempts over 2 ranks: the RK45
    controller's RMS norms reduced over the ranks give the one-device
    solver's initial step, accepted and rejected attempts (the flags equal)
    and step sizes, and its state within ``ODE_TOL`` of max|ref|."""
    ref = worlds["one_device"]["ode"]
    assert ref["flags"][2] == ODE_ATTEMPTS
    for res in worlds["ranks"][2]:
        out = res["ode"]
        assert out["flags"] == ref["flags"]
        assert out["t"] == pytest.approx(ref["t"], rel=1e-5)
        assert out["h"] == pytest.approx(ref["h"], rel=1e-5)
        assert out["y"].shape == ref["y"].shape and _rel(out["y"], ref["y"]) <= ODE_TOL


@pytest.mark.parametrize("name", ["v2", "v3snr", "pc", "v2_seven", "pc_four"])
def test_sharded_enhance_matches_jax(worlds, name):
    """The JAX package's one-device ``enhance`` on the same weights and key,
    within tests/test_sequence_parallel.py's bounds."""
    ref = worlds["jax"][name]
    for res in worlds["ranks"][_world_of(name)]:
        out = res[name]["wave"]
        assert out.shape == ref.shape
        if name.startswith("pc"):
            assert _rel(out, ref) <= PC_TOL
        else:
            np.testing.assert_allclose(out, ref, **JAX_TOL)


def test_sharded_enhance_matches_jax_sharded(worlds):
    """JAX's own ``enhance(seq_mesh=make_seq_mesh(2))`` (GSPMD) on 2 of the
    virtual CPU devices, and the port over 2 gloo ranks."""
    ref = worlds["jax"]["v2_sharded"]
    np.testing.assert_allclose(ref, worlds["jax"]["v2"], **JAX_TOL)
    for res in worlds["ranks"][2]:
        np.testing.assert_allclose(res["v2"]["wave"], ref, **JAX_TOL)


def test_sharded_call_keys_the_mesh_and_captures_nothing(worlds):
    """A sharded call runs eagerly (no program kept); the mesh's key names
    its axis (a custom one honoured), size and ranks, and keys a program
    apart from the one-device one."""
    for r, res in enumerate(worlds["ranks"][2]):
        assert res["v2"]["graphs"] == 0 and res["axis"]["graphs"] == 0
        assert res["v2"]["mesh_key"] == (("seq",), (2,), (0, 1))
        assert res["axis"]["mesh_key"] == (("frames",), (2,), (0, 1))
    model = workers.port_model(worlds["cases"]["v2"]["model"])
    args = ("sebridge_v2", 128, 30, "reverse_diffusion", "ald", 1, False, 1)
    assert model._graph_key(*args, mesh=worlds["ranks"][2][0]["v2"]["mesh_key"]) != \
        model._graph_key(*args)


def test_seq_mesh_past_the_world_raises(worlds):
    for res in worlds["ranks"][4]:
        assert res["too_many"] == "need 5 ranks, have 4"


def test_eval_cli_seq_shards_writes_the_unsharded_results(worlds):
    """``cli.eval --seq_shards 2`` over two ranks: rank 0 writes the table
    and the wavs of the unsharded run (PESQ within 1e-3, SI-SDR and ESTOI
    within 1e-4: tests/test_torch_eval.py's bounds); rank 1 writes nothing
    but enhances every file."""
    root = worlds["root"]
    whole = pd.read_csv(root / "whole" / "_results.csv")
    sharded = pd.read_csv(root / "sharded" / "_results.csv")
    assert list(sharded["filename"]) == list(whole["filename"]) and len(whole) == 3
    np.testing.assert_allclose(sharded["pesq"], whole["pesq"], atol=1e-3)
    np.testing.assert_allclose(sharded["si_sdr"], whole["si_sdr"], atol=1e-4)
    np.testing.assert_allclose(sharded["estoi"], whole["estoi"], atol=1e-4)
    assert sorted(os.listdir(root / "sharded" / "all")) == list(whole["filename"])
    assert [res["eval"]["files"] for res in worlds["ranks"][2]] == [3, 0]


# ------------------------------------------------------------------ no ranks


def _x(shape, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape) + 0.5).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_sums_and_fold_are_the_statistics_pass(dtype):
    x = _x((2, 8, 12, 32)).to(dtype)
    scale, bias = _x((32,), 1, 0.1) + 1, _x((32,), 2, 0.1)
    sums = ck.gn_group_sums(x, 8)
    assert sums.shape == (2, 8, 2) and sums.dtype == torch.float64
    a, b = ck.gn_fold_ab(sums, 8 * 12, scale, bias, 1e-6, dtype)
    ra, rb = ck.gn_stats_ab_reference(x, scale, bias, 8, 1e-6)
    assert torch.equal(a, ra) and torch.equal(b, rb)
    # the sums of two halves of the frames, added, fold to the whole's affine
    halves = ck.gn_group_sums(x[:, :, :6], 8) + ck.gn_group_sums(x[:, :, 6:], 8)
    for got, want in zip(ck.gn_fold_ab(halves, 8 * 12, scale, bias, 1e-6), (ra, rb)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_kernels_with_their_own_affine_are_unchanged():
    """K1/K2 and K3's plain versions with ``ab`` = x's own statistics equal
    them without it, bit for bit."""
    x = _x((1, 6, 10, 16))
    gs, gb = _x((16,), 1, 0.1) + 1, _x((16,), 2, 0.1)
    w, bt = _x((3, 3, 16, 8), 3, 0.1), _x((1, 8), 4, 0.1)
    ab = ck.gn_stats_ab_reference(x, gs, gb, 4, 1e-6)
    for silu in (True, False):
        assert torch.equal(ck.groupnorm_silu(x, gs, gb, 4, apply_silu=silu, ab=ab),
                           ck.groupnorm_silu(x, gs, gb, 4, apply_silu=silu))
    skip = _x((1, 6, 10, 8), 5)
    assert torch.equal(ck.groupnorm_silu_conv3x3(x, gs, gb, w, bt, 4, skip=skip, ab=ab),
                       ck.groupnorm_silu_conv3x3(x, gs, gb, w, bt, 4, skip=skip))
    # through the differentiable ops: the gradient reaches x, a and b
    xg = x.clone().requires_grad_(True)
    ag, bg = (t.clone().requires_grad_(True) for t in ab)
    out = ck.groupnorm_silu_conv3x3_op(xg, gs, gb, w, bt, 4, ab=(ag, bg))
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (xg, ag, bg))


class _StandIn:
    """A frames shard over columns ``[lo, hi)`` of a whole tensor, whose
    halo reads the whole tensor's columns as the ranks' all-gather would."""

    def __init__(self, whole, lo, hi, count):
        self.whole, self.lo, self.hi, self.count = whole, lo, hi, count

    def halo(self, t, dim, left, right, zero_edges=True):
        width = self.whole.shape[dim]
        a, b = max(0, self.lo - left), min(width, self.hi + right)
        out = self.whole.narrow(dim, a, b - a)
        added = (self.lo - a, b - self.hi)
        if not zero_edges:
            return out, *added
        pad = [0] * (2 * (t.ndim - dim % t.ndim - 1)) + [left - added[0], right - added[1]]
        return torch.nn.functional.pad(out, pad)

    def sum(self, t):
        return t


@pytest.mark.parametrize("lo,hi", [(0, 8), (8, 16), (4, 12)])
def test_halo_conv_and_fir_give_the_whole_maps_columns(lo, hi):
    """The fused conv on x extended by its neighbours' columns (the kernel's
    own padding at the global edges), cropped, and the FIR up / down
    resampling of a shard give the whole map's columns."""
    x = _x((1, 16, 16, 16))  # NCHW
    gn = layers.GroupNorm(16)
    conv = layers.hwio_memory_(layers.ddpm_conv(16, 8, 3, generator=torch.Generator()
                                                .manual_seed(0)))
    bias = conv.bias[None, :].detach()
    xn = layers.to_nhwc(x)
    with torch.no_grad():
        whole = layers.gn_silu_conv(xn, gn, conv, bias)
        shard = _StandIn(xn, lo, hi, 2)
        shard.sum = lambda sums: ck.gn_group_sums(xn, gn.num_groups)  # the whole map's sums
        with _set_frames(shard):
            part = layers.gn_silu_conv(xn[:, :, lo:hi], gn, conv, bias)
    torch.testing.assert_close(part, whole[:, :, lo:hi], rtol=1e-5, atol=1e-6)
    for fn, factor in ((upsample_2d, 2), (downsample_2d, 0.5)):
        ref = fn(x, (1, 3, 3, 1), factor=2)
        out = fn(x[..., lo:hi], (1, 3, 3, 1), factor=2, frames=_StandIn(x, lo, hi, 2))
        a, b = int(lo * factor), int(hi * factor)
        torch.testing.assert_close(out, ref[..., a:b], rtol=1e-6, atol=1e-6)


def test_frame_levels_gather_where_a_level_does_not_divide():
    """128 frames over 4 ranks, 7 levels: the 2-frame bottom level runs
    whole; over 2 ranks every level splits; no shard, no level splits."""
    class Shard:
        count = 4
    with _set_frames(Shard()):
        assert FrameLevels(32, 7).split == [True] * 6 + [False]
    Shard.count = 2
    with _set_frames(Shard()):
        assert FrameLevels(64, 7).split == [True] * 7
    assert FrameLevels(128, 7).split == [] and FrameLevels(128, 7).shard is None


def test_mesh_key_of_a_one_rank_mesh():
    """``make_seq_mesh(1)`` in one process: a mesh of this process alone,
    whose key names its axis; a one-rank axis is no shard."""
    import torch.distributed as dist

    from diffse_tpu_torch.parallel import make_seq_mesh
    from diffse_tpu_torch.parallel.sequence import frames_shard, spec_seq_sharding

    created = not dist.is_initialized()
    try:
        mesh = make_seq_mesh(1, device_type="cpu", axis_name="frames")
        assert mesh_key(mesh) == (("frames",), (1,), (0,))
        assert frames_shard(mesh) is None and spec_seq_sharding(mesh, 128) == slice(0, 128)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
