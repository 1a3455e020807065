"""The exported enhance program (diffse_tpu_torch/serving/export.py) on the
CPU: the counterparts of tests/test_export.py, the kernels' operators under
``torch.library.opcheck``, and the artifact against the JAX package's own.

Every artifact must reproduce ``ScoreModel.enhance`` through the loader,
which imports no model code: bitwise, since the program runs the same
operations on the same draws (drawn by the loader from the seed in
``enhance``'s order). The JAX package's CPU artifact of ``sebridge`` (one
forward at t = 0.999, no draw) is matched within 1e-5 on the same weights
(``convert.state_dict_from_jax``). Tiny models only (two levels, nf 4)."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.serving import export as jax_export
from diffse_tpu_torch.convert import state_dict_from_jax
from diffse_tpu_torch.data.wavio import parse_wav, wav_bytes
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.ops import cuda_kernels as ck
from diffse_tpu_torch.serving import export
from diffse_tpu_torch.serving.export import load_artifact, save_artifact
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.transforms import width_bucket
from test_torch_ncsnpp import random_jax_params

torch.set_num_threads(2)

TINY_BACKBONE = dict(nf=4, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                     image_size=256)
SDE_KWARGS = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(model_type="sebridge_v2", snr_conditioned="false", sigma_max=1.0, seed=0, **cfg):
    return ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type=model_type,
                                       snr_conditioned=snr_conditioned, sigma_max=sigma_max,
                                       **cfg),
                      backbone_kwargs=TINY_BACKBONE, sde_kwargs=SDE_KWARGS, device="cpu",
                      generator=torch.Generator().manual_seed(seed))


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
        assert torch.export.load(os.path.join(path, b["file"])).example_inputs is None


def test_artifact_matches_enhance_1nfe(tiny_model, artifact):
    _, meta, enhance = artifact
    assert meta["pad_samples"] == (192 - 1) * 128 and meta["branch"] == "sebridge_v2"
    assert meta["buckets"][0]["noise"] == {"draws": 1, "shape": [1, 1, 256, 64]}
    assert meta["device"] == "cpu" and meta["nfe"] == 1
    y = _wave(0, 4800)
    got = enhance(y, seed=7)
    assert got.shape == y.shape
    np.testing.assert_array_equal(got, _enhance(tiny_model, y, 7))


def test_artifact_matches_enhance_pc_sampler(tmp_path):
    """The PC sampler's steps unrolled in the program (3 steps, 6 forwards,
    7 draws): bitwise equal to enhance at the same seed."""
    model = _model("bbed", sigma_max=0.5, seed=1)
    y = _wave(1, 3000)
    path = str(tmp_path / "pc")
    meta = save_artifact(path, model, None, "bbed_pc", utt_samples=len(y), n_steps=3)
    assert meta["nfe"] == 6 and meta["buckets"][0]["noise"]["draws"] == 7
    enhance, _ = load_artifact(path)
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


def test_loader_imports_no_model_code(artifact):
    """In place of the JAX multiplatform test: a fresh process loads the
    artifact and runs it with no diffse_tpu_torch.models / sampling / sde /
    transforms module imported (nor JAX)."""
    path, _, enhance = artifact
    y = _wave(6, 4000)
    script = (
        "import sys, numpy as np\n"
        "from diffse_tpu_torch.serving.export import load_artifact\n"
        f"enhance, meta = load_artifact({path!r})\n"
        f"out = enhance(np.load({path!r} + '/y.npy'), seed=2)\n"
        f"np.save({path!r} + '/out.npy', out)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[:2] in "
        "[['diffse_tpu_torch', p] for p in ('models', 'sampling', 'sde', 'transforms')] "
        "or m.split('.')[0] in ('jax', 'diffse_tpu'))\n"
        "print('imported', bad)\n")
    np.save(os.path.join(path, "y.npy"), y)
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "imported []" in done.stdout
    np.testing.assert_array_equal(np.load(os.path.join(path, "out.npy")), enhance(y, seed=2))


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
    with pytest.raises(ValueError, match="cannot be exported"):
        export.export_enhance(tiny_model, None, "bbed_ode", 4800)
    bf16 = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="sebridge_v2"),
                      backbone_kwargs={**TINY_BACKBONE, "dtype": "bf16"},
                      sde_kwargs=SDE_KWARGS, device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        export.export_enhance(bf16, None, "sebridge_v2", 4800)


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
