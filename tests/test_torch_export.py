"""The exported enhance programs (diffse_tpu_torch/serving/export.py) on the
CPU: the counterparts of tests/test_export.py, the kernels' operators under
``torch.library.opcheck``, and the artifact against the JAX package's own.

Every artifact must reproduce ``ScoreModel.enhance`` through the loader,
which imports no model code: bitwise, float32 and bf16 trunk alike, since
the programs run the same operations on the same draws (drawn by the loader
from the seed in ``enhance``'s order, or given) with the same bf16 casts and
packed weights (made at export by the blocks' own code). The JAX package's
CPU artifact of ``sebridge`` (one forward at t = 0.999, no draw) is matched
within 1e-5 on the same weights (``convert.state_dict_from_jax``); its bf16
artifact within a third of its own bf16-vs-float32 gap. Tiny models only
(two levels, nf 4; nf 16 for the bf16 trunk, whose packed weights need
whole chunks of 16 input channels)."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.serving import export as jax_export
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.sampling import CorrectorRegistry, PredictorRegistry, get_pc_sampler
from diffse_tpu_torch.sde import SDERegistry
from diffse_tpu_torch.serving import export
from diffse_tpu_torch.serving.export import load_artifact, save_artifact
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.transforms import width_bucket
from diffse_tpu_torch.utils import generator_noise
from test_torch_bf16 import GAP_SHARE, JAX_FLAGS
from test_torch_ncsnpp import jax_param_shapes, random_jax_params

torch.set_num_threads(2)

TINY_BACKBONE = dict(nf=4, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                     image_size=256)
# the bf16 trunk packs the fused convs' weights where Cin is whole chunks of 16
BF16_BACKBONE = dict(TINY_BACKBONE, nf=16, dtype="bf16")
# the samplers' artifacts on a 64-bin spectrogram: a quarter of the forward's work
SMALL_STFT = dict(n_fft=126, hop_length=64)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(model_type="sebridge_v2", snr_conditioned="false", sigma_max=1.0, seed=0,
           backbone=TINY_BACKBONE, **cfg):
    return ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type=model_type,
                                       snr_conditioned=snr_conditioned, sigma_max=sigma_max,
                                       **cfg),
                      backbone_kwargs=backbone, sde_kwargs=SDE_KWARGS, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


def _draws(seed, n, shape):
    """n complex CN(0, 1) draws of ``shape``, numpy, from a seed."""
    rng = np.random.default_rng(seed)
    shape = (n, *shape)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)) \
        .astype(np.complex64)


def _feed(draws):
    """``noise(like)`` handing out ``draws`` in order."""
    it = iter(draws)
    return lambda like: torch.from_numpy(next(it))


def _wave(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _enhance(model, y, seed, **kwargs):
    return model.enhance(y[None], y[None], generator=torch.Generator().manual_seed(seed),
                         **kwargs)


@pytest.fixture(scope="module")
def tiny_model():
    return _model()


@pytest.fixture(scope="module")
def artifact(tiny_model, tmp_path_factory):
    """A two-bucket sebridge_v2 artifact (64 and 192 frames) and its loader."""
    path = str(tmp_path_factory.mktemp("art") / "v2")
    meta = save_artifact(path, tiny_model, None, "sebridge_v2", utt_samples=[4800, 20000, 5000])
    enhance, loaded = load_artifact(path)
    return path, meta, enhance


def _cli_artifact(tmp_path_factory, model, name, flags):
    """``model``'s checkpoint exported by ``cli.export_artifact`` (its EMA,
    equal to its weights at the start) for 3000 samples, and loaded."""
    from diffse_tpu_torch.cli import export_artifact

    root = tmp_path_factory.mktemp(name)
    ckpt, path = str(root / "ckpt"), str(root / "art")
    CheckpointManager(ckpt, hparams=model.hparams).save(0, TrainState(model.backbone), {})
    meta = export_artifact.main(["--ckpt", ckpt, "--out", path, "--utt_seconds", "0.1875",
                                 "--device", "cpu", *flags])
    enhance, _ = load_artifact(path)
    return model, path, enhance, meta


@pytest.fixture(scope="module")
def float32_pc(tmp_path_factory):
    """A float32 bbed_pc artifact, N = 3, and its model."""
    model = _model("bbed", sigma_max=0.5, seed=1, **SMALL_STFT)
    path = str(tmp_path_factory.mktemp("pc") / "f32")
    meta = save_artifact(path, model, None, "bbed_pc", utt_samples=3000, n_steps=3)
    enhance, _ = load_artifact(path)
    return model, path, enhance, meta


@pytest.fixture(scope="module")
def bf16_pc(tmp_path_factory):
    """A bf16-trunk bbed checkpoint's bbed_pc artifact, N = 3, through the
    export CLI, and its model."""
    return _cli_artifact(tmp_path_factory, _model("bbed", sigma_max=0.5, seed=5,
                                                  backbone=BF16_BACKBONE, **SMALL_STFT),
                         "bf16", ["--N", "3"])


@pytest.fixture(scope="module")
def ode_artifact(tmp_path_factory):
    """A float32 bbed checkpoint's bbed_ode artifact through the export CLI
    (``--branch bbed_ode``), and its model."""
    return _cli_artifact(tmp_path_factory, _model("bbed", sigma_max=0.5, seed=6, **SMALL_STFT),
                         "ode", ["--branch", "bbed_ode"])


def test_weights_roundtrip_keeps_names_and_strides(tiny_model, artifact):
    """The counterpart of the JAX flatten/unflatten roundtrip: the weights
    file gives back every tensor by name, bit for bit, with its strides
    (the fused convs' weights live in HWIO memory, which the program's
    kernel calls read in place)."""
    path, meta, _ = artifact
    saved = torch.load(os.path.join(path, export.WEIGHTS_FILE), weights_only=True)
    own = dict(tiny_model.backbone.named_parameters())
    own.update(tiny_model.backbone.named_buffers())
    assert saved.keys() == own.keys()
    for name, t in own.items():
        assert torch.equal(saved[name], t) and saved[name].stride() == t.stride(), name
    hwio = [n for n, t in own.items() if t.ndim == 4 and not t.is_contiguous()]
    assert hwio  # the plain blocks' fused convs
    # the weights are in weights.pt only: no program keeps them as its example inputs
    for b in meta["buckets"]:
        for program in b["programs"]:
            assert torch.export.load(os.path.join(path, program["file"])).example_inputs is None


def test_artifact_matches_enhance_1nfe(tiny_model, artifact):
    _, meta, enhance = artifact
    assert meta["pad_samples"] == (192 - 1) * 128 and meta["branch"] == "sebridge_v2"
    (program,) = meta["buckets"][0]["programs"]
    assert program["role"] == "enhance" and program["draws"] == 1
    assert meta["buckets"][0]["draw_shape"] == [1, 1, 256, 64]
    assert meta["device"] == "cpu" and meta["nfe"] == 1
    assert meta["format"] == export.FORMAT and meta["dtype"] == "float32"
    assert meta["prepared"] is None and meta["grid"] is None
    y = _wave(0, 4800)
    got = enhance(y, seed=7)
    assert got.shape == y.shape
    np.testing.assert_array_equal(got, _enhance(tiny_model, y, 7))


def test_artifact_matches_enhance_pc_sampler(float32_pc):
    """The PC sampler as three programs, the step run by the loader once per
    step on the stored grid (3 steps, 6 forwards, 7 draws: the prior's, then
    each step's corrector's and predictor's): bitwise equal to enhance at the
    same seed."""
    model, _, enhance, meta = float32_pc
    programs = meta["buckets"][0]["programs"]
    assert [(p["role"], p["draws"], p["forwards"]) for p in programs] == [
        ("start", 1, 0), ("step", 2, 2), ("finish", 0, 0)]
    assert meta["nfe"] == 6 and sorted(meta["grid"]) == ["std", "step", "t"]
    assert len(meta["grid"]["t"]) == 3 and enhance.buckets[0].draws == 7
    y = _wave(1, 3000)
    np.testing.assert_array_equal(enhance(y, seed=3, snr=0.3),
                                  _enhance(model, y, 3, N=3, snr=0.3))


def test_multibucket_artifact_picks_smallest_fit(tiny_model, artifact):
    _, meta, enhance = artifact
    assert [b["pad_samples"] for b in meta["buckets"]] == [(64 - 1) * 128, (192 - 1) * 128]
    assert len(meta["seconds"]) == 2  # 4800 and 5000 share the 64-frame bucket
    short, long = _wave(2, 3000), _wave(3, 20000)
    np.testing.assert_array_equal(enhance(short, seed=1), _enhance(tiny_model, short, 1))
    np.testing.assert_array_equal(enhance(long, seed=1), _enhance(tiny_model, long, 1))
    # 15000 samples are a 128-frame utterance, served padded to 192 frames
    assert enhance(_wave(4, 15000), seed=1).shape == (15000,)
    with pytest.raises(ValueError, match="largest bucket"):
        enhance(np.zeros(40000, np.float32))


def test_artifact_serves_truncation_bucket_lengths(tiny_model, artifact):
    """frames % 64 == 0 (up to hop-1 samples beyond the bucket) is served by
    truncation, as enhance does; an empty waveform is refused."""
    _, _, enhance = artifact
    y = _wave(5, 8100)
    assert width_bucket(len(y), 128) == (64, 8064)
    got = enhance(y, seed=4)
    assert got.shape == (8100,)
    np.testing.assert_array_equal(got, _enhance(tiny_model, y, 4))
    with pytest.raises(ValueError, match="empty"):
        enhance(np.zeros(0, np.float32))


def test_artifact_http_serving(artifact):
    """cli.serve --artifact: the HTTP front over the loaded program returns
    the loader's output for the service's seeds (0, 1, ...)."""
    from diffse_tpu_torch.cli.serve import main as serve_main

    path, _, enhance = artifact
    server, service, _ = serve_main(["--artifact", path, "--port", "0"], block=False)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        for seed, n in enumerate((4000, 12000)):
            y = _wave(10 + seed, n)
            req = urllib.request.Request(base + "/enhance",
                                         data=wav_bytes(y, 16000, subtype="float32"),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                got, sr = parse_wav(r.read(), name="<resp>")
            assert sr == 16000
            np.testing.assert_array_equal(got[0], enhance(y, seed=seed))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 2 and stats["branch"] == "sebridge_v2"
        assert stats["buckets"] == [8064, 24448] and stats["errors"] == 0
    finally:
        server.shutdown()
        service.close()


@pytest.mark.parametrize("argv,message", [
    ([], "exactly one of --ckpt / --artifact"),
    (["--ckpt", "c", "--artifact", "a"], "exactly one of --ckpt / --artifact"),
    (["--artifact", "a", "--snr_ckpt", "s"], "apply to --ckpt mode only"),
    (["--artifact", "a", "--ckpt_step", "1"], "apply to --ckpt mode only"),
    (["--artifact", "a", "--monitor", "pesq"], "apply to --ckpt mode only"),
])
def test_serve_cli_artifact_rules(argv, message, capsys):
    from diffse_tpu_torch.cli.serve import main as serve_main

    with pytest.raises(SystemExit):
        serve_main(argv, block=False)
    assert message in capsys.readouterr().err


def test_loader_imports_no_model_code(artifact, bf16_pc, ode_artifact, tmp_path):
    """In place of the JAX multiplatform test: a fresh process loads a
    float32 one-forward, a bf16 bbed_pc and a bbed_ode artifact, and runs
    the first two, with no diffse_tpu_torch.models / sampling / sde /
    transforms module imported (nor JAX)."""
    paths = [artifact[0], bf16_pc[1], ode_artifact[1]]
    y = _wave(6, 3000)
    np.save(str(tmp_path / "y.npy"), y)
    script = (
        "import sys, numpy as np\n"
        "from diffse_tpu_torch.serving.export import load_artifact\n"
        f"y = np.load({str(tmp_path / 'y.npy')!r})\n"
        f"for i, path in enumerate({paths!r}):\n"
        "    enhance, meta = load_artifact(path)\n"
        "    if i < 2:\n"
        f"        np.save({str(tmp_path)!r} + f'/out{{i}}.npy', enhance(y, seed=2))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[:2] in "
        "[['diffse_tpu_torch', p] for p in ('models', 'sampling', 'sde', 'transforms')] "
        "or m.split('.')[0] in ('jax', 'diffse_tpu'))\n"
        "print('imported', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "imported []" in done.stdout
    for i, enhance in enumerate((artifact[2], bf16_pc[2])):
        np.testing.assert_array_equal(np.load(str(tmp_path / f"out{i}.npy")),
                                      enhance(y, seed=2))


def test_snr_artifact_matches_oracle_enhance_and_given_draws(tmp_path):
    """sebridge_v3_snr: the client's est_snr snapped on the host as enhance
    snaps the oracle SNR; given draws run the program eagerly and equal
    enhance on the same noise."""
    model = _model("sebridge_v3", snr_conditioned="true", fixed_snr=0.17783, seed=2)
    path = str(tmp_path / "v3")
    save_artifact(path, model, None, "sebridge_v3_snr", utt_samples=6000)
    enhance, meta = load_artifact(path)
    assert meta["snr_conditioned"] == "true" and meta["fixed_snr"] == 0.17783
    y = _wave(7, 6000)
    for est in (0.2, 0.9):
        est = float(np.float32(est))
        np.testing.assert_array_equal(
            enhance(y, seed=5, est_snr=est),
            _enhance(model, y, 5, oracle=True, noise_rms=est, clean_rms=1.0))
    rng = np.random.default_rng(9)
    shape = (1, 1, 1, 256, 64)
    draws = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2))
    draws = draws.astype(np.complex64)
    np.testing.assert_array_equal(
        enhance(y, est_snr=0.5, draws=draws),
        model.enhance(y[None], y[None], noise=lambda like: torch.from_numpy(draws[0]),
                      oracle=True, noise_rms=0.5, clean_rms=1.0))
    with pytest.raises(ValueError, match="draws of shape"):
        enhance(y, draws=draws[:, :, :, :128])


def test_loader_pins_float32(artifact, monkeypatch):
    """The exported graph cannot hold the process's TF32 switches: the
    loader runs each program under ``utils.float32_precision`` for its
    device, as the model's forward runs."""
    import contextlib

    pinned = []

    @contextlib.contextmanager
    def recording(device):
        pinned.append(torch.device(device))
        yield

    monkeypatch.setattr(export, "float32_precision", recording)
    _, _, enhance = artifact
    y = _wave(9, 3000)
    enhance(y, seed=0)
    enhance(y, draws=np.zeros((1, 1, 1, 256, 64), np.complex64))
    assert pinned == [torch.device("cpu")] * 2


def test_sebridge_artifact_matches_jax_artifact(tmp_path):
    """The port's sebridge artifact on weights carried over from a tiny JAX
    model against the JAX package's own CPU artifact (sebridge draws
    nothing, so the frameworks' draws play no part)."""
    cfg = dict(backbone="ncsnpp", sde="bbed", model_type="sebridge", snr_conditioned="false",
               sigma_max=1.0)
    jax_model = JaxScoreModel(JaxScoreModelConfig(**cfg), backbone_kwargs=TINY_BACKBONE,
                              sde_kwargs=SDE_KWARGS)
    params = random_jax_params(TINY_BACKBONE, seed=4, frames=64)
    variables = {"params": params}
    model = _model("sebridge")
    model.backbone.load_state_dict(state_dict_from_jax(params, **TINY_BACKBONE), strict=True)
    y = _wave(8, 4800)
    jax_dir = str(tmp_path / "jax")
    jax_export.save_artifact(jax_dir, jax_model, variables, "sebridge", utt_samples=len(y),
                             platforms=("cpu",))
    ref = jax_export.load_artifact(jax_dir)[0](y, seed=0)
    path = str(tmp_path / "port")
    save_artifact(path, model, None, "sebridge", utt_samples=len(y))
    got = load_artifact(path)[0](y, seed=0)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_export_cli_writes_the_ema_and_refuses_platforms(tmp_path):
    """cli.export_artifact: the checkpoint's EMA weights (unless --no_ema),
    the default branch from the model's config, --platforms refused."""
    from diffse_tpu_torch.cli import export_artifact

    model = _model(seed=3)
    ckpt = str(tmp_path / "ckpt")
    state = TrainState(model.backbone)
    with torch.no_grad():
        for e in state.ema:
            e.mul_(0.5)
    CheckpointManager(ckpt, hparams=model.hparams).save(0, state, {})
    for flags, want in (([], state.ema), (["--no_ema", "--branch", "sebridge_v2"],
                                          state.params)):
        out = str(tmp_path / f"art{len(flags)}")
        meta = export_artifact.main(["--ckpt", ckpt, "--out", out, "--utt_seconds", "0.2",
                                     "--device", "cpu", *flags])
        assert meta["branch"] == "sebridge_v2" and meta["n_steps"] == 30 and meta["nfe"] == 1
        weights = torch.load(os.path.join(out, export.WEIGHTS_FILE), weights_only=True)
        for name, w in zip(state.names, want):
            assert torch.equal(weights[name], w), name
    with pytest.raises(SystemExit):
        export_artifact.main(["--ckpt", ckpt, "--out", out, "--device", "cpu",
                              "--platforms", "cpu"])


def test_export_refuses_what_it_cannot_trace(tiny_model):
    """A name that is no enhance branch is refused; every branch exports in
    both trunks (tests below), the bf16 trunk of every NCSN++ configuration
    (``test_bf16_ddpmpp_artifact_matches_enhance``)."""
    with pytest.raises(ValueError, match="cannot be exported"):
        export.export_enhance(tiny_model, None, "sebridge_v3", 4800)


# score_sde's DDPM++ (tests/test_torch_backbones.py), bf16 trunk: DDPM-style
# blocks in float32, the stem's bf16 cast the only prepared weights
BF16_DDPMPP = dict(BF16_BACKBONE, resblock_type="ddpm", fir=False, resamp_with_conv=True,
                   progressive="none", progressive_input="none", embedding_type="positional")


def test_bf16_ddpmpp_artifact_matches_enhance(tmp_path):
    """A bf16 DDPM++ checkpoint's bbed_pc artifact (N = 3) through the
    export CLI: bitwise equal to ``enhance`` on the same seed, its prepared
    weights the stem's bf16 cast (the blocks and the final head are
    float32), and a call casts nothing."""
    from diffse_tpu_torch.cli import export_artifact

    model = _model("bbed", sigma_max=0.5, seed=7, backbone=BF16_DDPMPP, **SMALL_STFT)
    ckpt, path = str(tmp_path / "ckpt"), str(tmp_path / "art")
    CheckpointManager(ckpt, hparams=model.hparams).save(0, TrainState(model.backbone), {})
    meta = export_artifact.main(["--ckpt", ckpt, "--out", path, "--utt_seconds", "0.1875",
                                 "--device", "cpu", "--N", "3"])
    enhance, _ = load_artifact(path)
    assert meta["dtype"] == "bfloat16"
    prepared = torch.load(os.path.join(path, meta["prepared"]), weights_only=True)
    stem = next(f"all_modules.{i}" for i, m in enumerate(model.backbone.all_modules)
                if isinstance(m, torch.nn.Conv2d))
    assert sorted(prepared) == [f"{stem}.cast_bias", f"{stem}.cast_weight"]
    y = _wave(13, 3000)
    casts = dict(ck.weight_casts)
    got = enhance(y, seed=4, snr=0.3)
    assert ck.weight_casts == casts
    np.testing.assert_array_equal(got, _enhance(model, y, 4, N=3, snr=0.3))


def test_format_1_artifact_is_refused(artifact, tmp_path):
    """An artifact of another format (PR 11's had none: one program per
    bucket) is refused with a message to export it again."""
    path, meta, _ = artifact
    old = str(tmp_path / "old")
    os.makedirs(old)
    for name in os.listdir(path):
        if name != export.META_FILE:
            os.symlink(os.path.join(path, name), os.path.join(old, name))
    with open(os.path.join(old, export.META_FILE), "w") as f:
        json.dump({k: v for k, v in meta.items() if k != "format"}, f)
    with pytest.raises(ValueError, match="format 1.*export it again"):
        load_artifact(old)


@pytest.mark.parametrize("trunk", ["float32", "bf16"])
def test_looped_pc_artifact_matches_enhance(trunk, request):
    """bbed_pc as start, three replays of one step, finish: bitwise equal
    to enhance, on draws from the seed and on given draws (all of a call's,
    in order). The bf16 artifact carries the casts and packed weights made
    at export (prepared.pt): a call casts nothing (``weight_casts``)."""
    model, path, enhance, meta = request.getfixturevalue(f"{trunk}_pc")
    assert meta["dtype"] == ("bfloat16" if trunk == "bf16" else "float32")
    if trunk == "bf16":
        prepared = torch.load(os.path.join(path, meta["prepared"]), weights_only=True)
        kinds = {k.rsplit(".", 1)[1] for k in prepared}
        assert kinds == {"cast_weight", "cast_bias", "packed"}
    y = _wave(12, 3000)
    casts = dict(ck.weight_casts)
    got = enhance(y, seed=3, snr=0.3)
    assert ck.weight_casts == casts
    np.testing.assert_array_equal(got, _enhance(model, y, 3, N=3, snr=0.3))
    bucket = enhance.buckets[0]
    assert bucket.draws == 7
    draws = _draws(13, bucket.draws, bucket.draw_shape)
    np.testing.assert_array_equal(
        enhance(y, snr=0.3, draws=draws),
        model.enhance(y[None], y[None], noise=_feed(draws), N=3, snr=0.3))


def test_ode_artifact_matches_enhance(ode_artifact):
    """bbed_ode as start, attempts until the done flag, finish (the host
    reads the flag after each attempt), given all of a call's draws (the
    prior's, then the denoising step's): bitwise equal to enhance on the
    same draws, with the same number of forwards."""
    model, _, enhance, meta = ode_artifact
    assert meta["branch"] == "bbed_ode" and meta["nfe"] is None
    assert [(p["role"], p["draws"], p["forwards"])
            for p in meta["buckets"][0]["programs"]] == [
        ("start", 1, 2), ("attempt", 0, 6), ("finish", 1, 1)]
    bucket = enhance.buckets[0]
    assert bucket.draws == 2
    y = _wave(14, 3000)
    draws = _draws(15, bucket.draws, bucket.draw_shape)
    got = enhance(y, draws=draws)
    ref, nfe, _ = model.enhance(y[None], y[None], noise=_feed(draws), sampler_type="ode",
                                timeit=True)
    np.testing.assert_array_equal(got, ref)
    assert bucket.flags[0] == 1 and bucket.flags[1] == nfe > 8


def _jax_init_like(arch, seed):
    """A param tree drawn as the JAX NCSN++'s initialisation draws it, in
    numpy (flax's own init of the tiny model takes ~40 s op by op): kernels
    uniform at variance scaling over the fan average, the blocks' last convs
    and the attention's output at scale 1e-10, biases 0, GroupNorm scales 1,
    the Fourier embedding at scale 16; the output heads drawn at
    1/sqrt(fan_in) (``_heads_redrawn``: at zero they would hide the network
    from the waveform)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [p.key for p in path]
        if names[-1] == "W" and len(names) == 2:
            return (16.0 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if leaf.ndim == 1:
            return np.full(leaf.shape, 1.0 if names[-1] == "scale" else 0.0, np.float32)
        if (names[0].startswith("Conv_") and names[0] != "Conv_0") or names[0] == "output_layer":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))) \
                .astype(np.float32)
        last = ((names[0].startswith("ResnetBlock") and names[1] == "Conv_1")
                or (names[0].startswith("AttnBlock") and names[1] == "NIN_3"))
        field = int(np.prod(leaf.shape[:-2]))
        bound = np.sqrt(3 * (1e-10 if last else 1.0) * 2 / (field * sum(leaf.shape[-2:])))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax_param_shapes(arch, 64))


def test_bf16_sebridge_artifact_matches_jax_bf16_artifact(tmp_path, capsys):
    """The port's bf16 sebridge artifact against the JAX package's bf16 CPU
    artifact on the same weights (drawn as the JAX initialisation draws
    them, ``_jax_init_like``; the JAX model with the flags the port's trunk
    follows, ``JAX_FLAGS``): within ``GAP_SHARE`` of the JAX package's own
    bf16-vs-float32 artifact gap (two bf16 programs that round in other
    places, here XLA's fused one and the port's, differ by a share of it)."""
    cfg = dict(backbone="ncsnpp", sde="bbed", model_type="sebridge", snr_conditioned="false",
               sigma_max=1.0)
    params = _jax_init_like(TINY_BACKBONE, seed=4)
    y = _wave(16, 4800)
    outs = {}
    for trunk, flags in (("float32", {}), ("bf16", dict(JAX_FLAGS, dtype="bf16"))):
        jax_model = JaxScoreModel(JaxScoreModelConfig(**cfg),
                                  backbone_kwargs={**TINY_BACKBONE, **flags},
                                  sde_kwargs=SDE_KWARGS)
        jax_dir = str(tmp_path / f"jax_{trunk}")
        jax_export.save_artifact(jax_dir, jax_model, {"params": params}, "sebridge",
                                 utt_samples=len(y), platforms=("cpu",))
        outs[trunk] = jax_export.load_artifact(jax_dir)[0](y, seed=0)
    model = _model("sebridge", backbone=dict(TINY_BACKBONE, dtype="bf16"))
    model.backbone.load_state_dict(state_dict_from_jax(params, **TINY_BACKBONE), strict=True)
    path = str(tmp_path / "port")
    save_artifact(path, model, None, "sebridge", utt_samples=len(y))
    got = load_artifact(path)[0](y, seed=0)

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    gap, err = rel(outs["bf16"], outs["float32"]), rel(got, outs["bf16"])
    with capsys.disabled():
        print(f"\nbf16 sebridge artifact: JAX bf16 vs JAX float32 {gap:.3e}; port bf16 vs JAX "
              f"bf16 {err:.3e} (limit {GAP_SHARE * gap:.3e})")
    assert gap > 1e-3 and np.isfinite(got).all()
    assert err <= GAP_SHARE * gap


def test_export_cli_takes_bbed_ode_and_a_bf16_checkpoint(bf16_pc, ode_artifact):
    """cli.export_artifact with --branch bbed_ode on a bbed checkpoint, and
    on a bf16-trunk checkpoint (its bf16 casts and packed weights in
    prepared.pt); the bf16 artifact equals the checkpoint's model's
    enhance, restored from the checkpoint."""
    from diffse_tpu_torch.train.restore import load_score_model

    _, _, _, meta = ode_artifact
    assert meta["branch"] == "bbed_ode" and meta["dtype"] == "float32"
    assert [p["role"] for p in meta["buckets"][0]["programs"]] == ["start", "attempt", "finish"]
    _, path, enhance, meta = bf16_pc
    assert meta["branch"] == "bbed_pc" and meta["dtype"] == "bfloat16"
    assert meta["n_steps"] == 3 and meta["prepared"] == export.PREPARED_FILE
    restored, _ = load_score_model(os.path.join(os.path.dirname(path), "ckpt"), device="cpu")
    assert restored.backbone.compute_dtype == torch.bfloat16
    y = _wave(17, 3000)
    np.testing.assert_array_equal(enhance(y, seed=1), _enhance(restored, y, 1, N=3))


PHASE_CASES = [(p, c) for p in ("reverse_diffusion", "euler_maruyama", "heun", "exp_euler",
                                "exp_heun", "none") for c in ("ald", "langevin", "none")]


@pytest.mark.parametrize("predictor,corrector", PHASE_CASES)
def test_pc_sampler_phases_are_the_sampler(predictor, corrector):
    """``get_pc_sampler``'s phases run by hand as the artifact's loader runs
    them (start, a step on each entry of the grid read back from Python
    floats, finish) are bitwise its ``sampler()``, draws and all, for every
    predictor and corrector (a closed-form score on a small spectrogram)."""
    assert predictor in PredictorRegistry.get_all_names()
    assert corrector in CorrectorRegistry.get_all_names()
    sde = SDERegistry.get_by_name("bbed")(**dict(SDE_KWARGS, N=3))
    rng = np.random.default_rng(18)
    Y = torch.from_numpy((rng.standard_normal((2, 1, 8, 8))
                          + 1j * rng.standard_normal((2, 1, 8, 8))).astype(np.complex64))

    def score(x, t, y):
        return -(x - y) * t[:, None, None, None]

    def sampler():
        noise = generator_noise(torch.Generator().manual_seed(19))
        return get_pc_sampler(predictor, corrector, sde, score, Y, noise, snr=0.3)

    ref, nfe = sampler()()
    phases = sampler()
    grid = {k: torch.tensor(v.tolist(), dtype=torch.float32) for k, v in phases.grid().items()}
    x, x_mean = phases.start()
    for i in range(3):
        x, x_mean = phases.step(x, **{k: v[i] for k, v in grid.items()})
    assert torch.equal(phases.finish(x, x_mean), ref) and phases.nfe == nfe


def test_loader_width_bucket_is_the_models(tmp_path):
    for n in (1, 127, 128, 8063, 8064, 8100, 8191, 8192, 24448, 50000):
        assert export.width_bucket(n, 128) == width_bucket(n, 128)


def test_card_artifact_needs_the_card(artifact, tmp_path, monkeypatch):
    path, meta, _ = artifact
    card = str(tmp_path / "card")
    os.makedirs(card)
    for name in os.listdir(path):
        if name != export.META_FILE:
            os.symlink(os.path.join(path, name), os.path.join(card, name))
    with open(os.path.join(card, export.META_FILE), "w") as f:
        json.dump({**meta, "device": "cuda"}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(card)


# ------------------------------------------------------------- the operators

_X = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(0))
_P = torch.rand(16, generator=torch.Generator().manual_seed(1)) + 0.5
_W = torch.randn(3, 3, 16, 8, generator=torch.Generator().manual_seed(2)) * 0.1
_B = torch.randn(2, 8, generator=torch.Generator().manual_seed(3))
OPCHECK_CASES = {
    "conv": (ck.gn_silu_conv3x3_custom_op, (_X, _P, _P, _W, _B, 4), {}),
    "conv_skip": (ck.gn_silu_conv3x3_custom_op, (_X, _P, _P, _W, _B, 4),
                  dict(skip=torch.randn(2, 8, 8, 8), skip_coef=0.5)),
    "conv_expanded_bias": (ck.gn_silu_conv3x3_custom_op, (_X, _P, _P, _W, _B[:1].expand(2, 8), 4),
                           {}),
    "conv_bf16": (ck.gn_silu_conv3x3_custom_op, (_X.bfloat16(), _P, _P, _W, _B, 4), {}),
    "groupnorm": (ck.groupnorm_silu_custom_op, (_X, _P, _P, 4), {}),
    "groupnorm_no_silu_f32_out": (ck.groupnorm_silu_custom_op, (_X.bfloat16(), _P, _P, 4),
                                  dict(apply_silu=False, out_dtype=torch.float32)),
    "fused_act": (ck.fused_bias_leaky_relu_custom_op, (_X, _P), {}),
    "fused_act_no_bias": (ck.fused_bias_leaky_relu_custom_op, (_X,),
                          dict(negative_slope=0.1, scale=2.0)),
}


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_opcheck(case):
    """Schema, fake implementation (shape, dtype, strides), the autograd
    registration and AOT dispatch of each operator on the CPU."""
    op, args, kwargs = OPCHECK_CASES[case]
    torch.library.opcheck(op, args, kwargs)


@pytest.mark.parametrize("case", sorted(OPCHECK_CASES))
def test_operator_is_the_wrapper(case):
    """On a CPU tensor each operator gives its wrapper's plain version,
    bit for bit, and counts no launch."""
    op, args, kwargs = OPCHECK_CASES[case]
    wrapper = {ck.gn_silu_conv3x3_custom_op: ck.groupnorm_silu_conv3x3,
               ck.groupnorm_silu_custom_op: ck.groupnorm_silu,
               ck.fused_bias_leaky_relu_custom_op: ck.fused_bias_leaky_relu}[op]
    ck.reset_launch_counts()
    assert torch.equal(op(*args, **kwargs), wrapper(*args, **kwargs))
    assert not any(ck.launch_counts.values())
