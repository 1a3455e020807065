"""The port's evaluation package against the JAX package, on the CPU:
``width_bucket`` / ``iter_buckets``, ``batch_enhance``, ``evaluate_model``,
``deep_evaluate_model`` and ``get_prior`` on identical weights (the bridge)
and the JAX package's own draws (its ``fold_in`` keys replayed through the
port's per-dispatch ``noise``). Waveforms agree to a relative error below
1e-4 (the bound of tests/test_torch_enhance.py); the metric means, computed
from them by the same numpy code, to 1e-3 (PESQ, whose level alignment and
VAD turn a 1e-5 waveform change into up to ~1e-4 of MOS) and 1e-4 (SI-SDR in
dB, ESTOI). The JAX models run the plain NCSN++ path, as in
tests/test_torch_streaming.py.

Then the port on its own: the training loop's validation metrics (on the
EMA weights, the trained parameters given back bit for bit), the CLIs
(``cli.eval`` on every path, ``cli.deep_eval``, ``cli.eval_snr_est``) on
tiny checkpoints, the CSV writer against pandas, and a changed SDE keying a
new captured program."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from diffse_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from diffse_tpu.evaluation import batch_eval as jax_batch_eval
from diffse_tpu.evaluation import debug as jax_debug
from diffse_tpu.evaluation import deep_inference as jax_deep
from diffse_tpu.evaluation import inference as jax_inference
from diffse_tpu.utils import randn_like as jax_randn_like
from diffse_tpu_torch.data import synthetic
from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
from diffse_tpu_torch.data.wavio import read_wav
from diffse_tpu_torch.evaluation import batch_eval, debug, deep_inference, inference, results
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.snrnet import SNRNet
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.train import loop
from diffse_tpu_torch.train.logging import MetricsLogger
from diffse_tpu_torch.train.restore import load_score_model
from diffse_tpu_torch.transforms import spec_back
import test_torch_enhance
from test_torch_enhance import ARCH, FIXED_SNR, _model_pair, replay_pc_draws
from test_torch_ncsnpp import random_jax_params
from test_torch_snr import random_snrnet_params
from test_torch_train_loss import SDE_KWARGS, STFT, TINY

torch.set_num_threads(2)

REL_TOL = 1e-4
PESQ_TOL = 1e-3
METRIC_TOL = 1e-4
# two width buckets at batch 3: [0, 1, 4] at 64 frames, [2, 3, 5] and the tail [6] at
# 128 (the 128-frame batches of 3 and 1 rows are evaluate_model's 0.8 s files' too)
LENGTHS = [5000, 7000, 9000, 12000, 6000, 15000, 10000]


def _rel_err(out, ref):
    return float(np.max(np.abs(np.asarray(out) - np.asarray(ref))) / np.max(np.abs(ref)))


def _wavs(seed, lengths):
    """Speech-like clean signals (the synthetic dataset's) and noisy mixtures."""
    rng = np.random.default_rng(seed)
    xs = [synthetic._speech_like(rng, n, 16000) for n in lengths]
    return xs, [(x + 0.05 * rng.standard_normal(x.shape[0])).astype(np.float32) for x in xs]


def jax_noise(key, branch, n_steps=None):
    """The port's per-dispatch noise replaying the JAX package's draws:
    dispatch ``b`` hands out what ``spec_sample`` draws from
    ``fold_in(key, b)``, shaped as the port asks."""
    def for_dispatch(b):
        """``b`` None: ``key`` itself (a caller that draws from it directly)."""
        k = key if b is None else jax.random.fold_in(key, b)
        draws = []

        def noise(like):
            if not draws:
                zeros = jnp.zeros(tuple(like.shape), jnp.complex64)
                draws.extend(reversed(replay_pc_draws(k, n_steps, tuple(like.shape))
                                      if branch == "bbed" else [jax_randn_like(k, zeros)]))
            return torch.from_numpy(np.array(draws.pop()))

        return noise

    return for_dispatch


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, JAX variables) by branch, made on first use:
    bbed and the paper's sebridge_v3_snr (with an SNRNet)."""
    params = random_jax_params(ARCH, seed=5)
    snr_params = random_snrnet_params(seed=11, fc_bias=-2.0)
    made = {}

    def get(branch):
        if branch not in made:
            with pytest.MonkeyPatch.context() as mp:  # the JAX package's plain path
                mp.setattr(test_torch_enhance, "JAX_FLAGS", {})
                if branch == "bbed":
                    ref, ours = _model_pair(params, "bbed", 0.5)
                else:
                    ref, ours = _model_pair(params, "sebridge_v3", 1.0, snr_conditioned="true",
                                            snr_params=snr_params)
                    ref.estimate_snr = jax.jit(ref.estimate_snr)  # one compile per shape
            made[branch] = (ref, ours, {"params": params})
        return made[branch]

    return get


# ------------------------------------------------------------------ buckets


def test_width_bucket_and_iter_buckets_match_jax():
    rng = np.random.default_rng(0)
    lengths = list(rng.integers(1, 200_000, size=300)) + [0, 1, 127, 128, 8063, 8064, 8065]
    for n in lengths:
        for hop, multiple in ((128, 64), (8, 64), (128, 16)):
            assert (batch_eval.width_bucket(int(n), hop, multiple)
                    == jax_batch_eval.width_bucket(int(n), hop, multiple))
    for batch_size in (1, 2, 3, 8, 16, 500):
        for hop in (128, 8):
            sub = [int(n) for n in lengths[:37 * batch_size % 300 + 7]]
            assert (list(batch_eval.iter_buckets(sub, batch_size, hop))
                    == list(jax_batch_eval.iter_buckets(sub, batch_size, hop)))


# ------------------------------------------------------------ batch_enhance


@pytest.mark.parametrize("branch,lengths", [("sebridge_v3_snr", LENGTHS),
                                            ("bbed", LENGTHS[:2])])
def test_batch_enhance_matches_jax(models, branch, lengths):
    """The paper's branch on seven files in two buckets at batch 3 with a
    tail batch of one, and bbed (the sampler at N = 2, ``sampler_kwargs``)
    on one batch: each dispatch on the JAX package's ``fold_in(key, b)``
    draws."""
    ref_model, ours, variables = models(branch)
    xs, ys = _wavs(1, lengths)
    key = jax.random.PRNGKey(3)
    est = [0.12, 0.3, 0.05, 0.2, 0.1, 0.15, 0.25] if branch.endswith("_snr") else None
    sk = {"N": 2} if branch == "bbed" else None
    refs = jax_batch_eval.batch_enhance(ref_model, variables, xs, ys, branch, key, batch_size=3,
                                        est_snrs=est, fixed_snr=FIXED_SNR, sampler_kwargs=sk)
    outs = batch_eval.batch_enhance(ours, xs, ys, branch, batch_size=3, est_snrs=est,
                                    fixed_snr=FIXED_SNR, sampler_kwargs=sk,
                                    noise=jax_noise(key, branch, n_steps=2))
    for out, ref, y in zip(outs, refs, ys):
        assert out.shape == np.asarray(ref).shape == y.shape
        assert _rel_err(out, ref) < REL_TOL


def test_batch_enhance_equals_per_file_and_seeds_by_dispatch(models):
    """On the port alone: a batch row is what the per-file path gives on
    the same draws, and generator draws follow the dispatch index only."""
    _, ours, _ = models("sebridge_v3_snr")
    xs, ys = _wavs(2, LENGTHS[:3])
    zeros = lambda b: (lambda like: torch.zeros_like(like))  # noqa: E731
    outs = batch_eval.batch_enhance(ours, xs, ys, "sebridge_v3_snr", batch_size=2,
                                    est_snrs=[0.1] * 3, fixed_snr=FIXED_SNR, noise=zeros)
    for x, y, out in zip(xs, ys, outs):
        ref = inference.eval_enhance_file(ours, x, y, "sebridge_v3_snr", est_snr=0.1,
                                          fixed_snr=FIXED_SNR, noise=zeros(0))
        assert _rel_err(out, ref) < REL_TOL  # other batch compositions round otherwise
    a = batch_eval.batch_enhance(ours, xs, ys, "sebridge_v3_snr", seed=4, batch_size=2,
                                 est_snrs=[0.1] * 3, fixed_snr=FIXED_SNR)
    b = batch_eval.batch_enhance(ours, xs, ys, "sebridge_v3_snr", seed=4, batch_size=2,
                                 est_snrs=[0.1] * 3, fixed_snr=FIXED_SNR)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert inference.dispatch_seed(4, 1) != inference.dispatch_seed(4, 0)
    assert inference.dispatch_seed(4, 1) != inference.dispatch_seed(5, 1)


# ----------------------------------------------------------- evaluate_model


@pytest.fixture(scope="module")
def valid_data(tmp_path_factory):
    """Three 0.8 s valid / valid2 pairs of the synthetic dataset (the
    JAX package's, so that both sides read the same files)."""
    root = jax_make_synthetic_dataset(str(tmp_path_factory.mktemp("evalds")), num_train=0,
                                      num_valid=3, num_valid2=2, num_test=0, duration_s=0.8,
                                      seed=2, noise_type="white_amod")

    def split(name):
        files = sorted(os.listdir(os.path.join(root, name, "clean")))
        return types.SimpleNamespace(
            clean_files=[os.path.join(root, name, "clean", f) for f in files],
            noisy_files=[os.path.join(root, name, "noisy", f) for f in files])

    return types.SimpleNamespace(valid_set=split("valid"), valid_set_2=split("valid2"))


@pytest.mark.parametrize("batch_size", [1, 3])
def test_evaluate_model_matches_jax(models, valid_data, batch_size):
    """The mean PESQ, SI-SDR and ESTOI over three files of the paper's
    branch, each file's SNR estimated by SNRNet: per file on
    ``fold_in(key, i)``, batched on ``fold_in(key, b)``."""
    ref_model, ours, variables = models("sebridge_v3_snr")
    key = jax.random.PRNGKey(7)
    ref = jax_inference.evaluate_model(ref_model, variables, valid_data, 3,
                                       model_type="sebridge_v3_snr", fixed_snr=FIXED_SNR, key=key,
                                       batch_size=batch_size)
    out = inference.evaluate_model(ours, valid_data, 3, model_type="sebridge_v3_snr",
                                   fixed_snr=FIXED_SNR, batch_size=batch_size,
                                   noise=jax_noise(key, "sebridge_v3_snr"))
    assert np.all(np.isfinite(out))
    assert abs(out[0] - ref[0]) < PESQ_TOL
    assert abs(out[1] - ref[1]) < METRIC_TOL and abs(out[2] - ref[2]) < METRIC_TOL


def test_deep_evaluate_model_matches_jax(models, valid_data):
    """The 27 scalars, in the reference's order, of one valid2 file: its
    nine SNR variants one 9-row batch on ``fold_in(fold_in(key, i), 0)``."""
    ref_model, ours, variables = models("sebridge_v3_snr")
    key = jax.random.PRNGKey(9)
    ref = jax_deep.deep_evaluate_model(ref_model, variables, valid_data, 1,
                                       model_type="sebridge_v3_snr", fixed_snr=FIXED_SNR, key=key)
    out = deep_inference.deep_evaluate_model(
        ours, valid_data, 1, model_type="sebridge_v3_snr", fixed_snr=FIXED_SNR,
        noise=lambda i: jax_noise(jax.random.fold_in(key, i), "sebridge_v3_snr")(0))
    assert len(out) == len(ref) == 27
    assert np.all(np.isfinite(out))
    n = len(deep_inference.SNR_GRID)
    np.testing.assert_allclose(out[:n], ref[:n], atol=METRIC_TOL)  # SI-SDR
    np.testing.assert_allclose(out[n:2 * n], ref[n:2 * n], atol=PESQ_TOL)  # PESQ
    np.testing.assert_allclose(out[2 * n:], ref[2 * n:], atol=METRIC_TOL)  # ESTOI
    assert deep_inference.SNR_GRID == jax_deep.SNR_GRID


def test_get_prior_matches_jax(models, monkeypatch):
    """The prior's draw, one score evaluation and the reconstruction pieces
    of bbed at T = 0.9, on the same draw. The clean spectrogram is compared
    uncompressed: the clean speech has bins near zero (above its band),
    where the two STFTs' ~1e-8 rounding has no phase to keep and the |c|^0.5
    compression makes it ~3e-4 of the max; the noise spectrogram is the
    noisy one less the clean one in both packages, and so is checked as that."""
    ref_model, ours, variables = models("bbed")
    monkeypatch.setattr(ref_model, "forward", jax.jit(ref_model.forward))  # one compile
    x, y = _wavs(3, [8000])
    key = jax.random.PRNGKey(1)
    ref = jax_debug.get_prior(ref_model, variables, y[0][None], x[0][None], key=key, T=0.9)
    out = debug.get_prior(ours, y[0][None], x[0][None], T=0.9,
                          noise=jax_noise(key, "sebridge_v3_snr")(None))
    assert sorted(out) == sorted(ref)
    np.testing.assert_array_equal(out["noise"], out["noisy"] - out["clean"])
    np.testing.assert_array_equal(ref["noise"], ref["noisy"] - ref["clean"])
    for name in ref:
        a, b = out[name], ref[name]
        assert a.shape == b.shape
        if name == "clean":
            a, b = (spec_back(torch.from_numpy(np.asarray(v)), ours.spec_cfg).numpy()
                    for v in (a, b))
        if name != "noise":
            assert _rel_err(a, b) < REL_TOL, name


def test_prior_panel_writes_a_figure(models, tmp_path):
    _, ours, _ = models("bbed")
    x, y = _wavs(4, [8000])
    path = debug.prior_panel(ours, y[0][None], x[0][None], out_path=str(tmp_path / "p.png"))
    assert os.path.getsize(path) > 0


# ------------------------------------------------------------ training loop


def _tiny_model(model_type="sebridge_v2", snr_conditioned="false", snr_model=None,
                full_stft=False, **config):
    """The tiny NCSN++ (training's TINY at a 16-bin STFT, without its
    attention, which at the validation's whole-utterance widths would take
    most of the time; or with ``full_stft`` the 256-bin STFT and
    tests/test_torch_enhance.py's ARCH, which SNRNet's input needs)."""
    cfg = ScoreModelConfig(**{**dict(backbone="ncsnpp", sde="bbed", model_type=model_type,
                                     snr_conditioned=snr_conditioned, fixed_snr=FIXED_SNR,
                                     sigma_max=1.0, **({} if full_stft else STFT)), **config})
    return ScoreModel(cfg, backbone_kwargs=ARCH if full_stft else {**TINY, "attn_resolutions": ()},
                      sde_kwargs=SDE_KWARGS,
                      device="cpu", generator=torch.Generator().manual_seed(0),
                      snr_model=snr_model)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loopds"))
    return make_synthetic_dataset(root, num_train=4, num_valid=2, num_valid2=2, num_test=3,
                                  duration_s=0.5)


def _data_module(root):
    from diffse_tpu_torch.data.dataset import DataModuleConfig, SpecsDataModule

    return SpecsDataModule(DataModuleConfig(
        base_dir=root, batch_size=2, n_fft=STFT["n_fft"], hop_length=STFT["hop_length"],
        num_frames=STFT["num_frames"], num_workers=1))


def test_training_validation_logs_metrics_on_the_ema(dataset, tmp_path, monkeypatch):
    """``num_eval_files=2``: each validation logs and saves pesq, si_sdr and
    estoi (and at the deep sweep's epoch its 27 values), enhanced with the
    EMA in the backbone; the trained parameters come back bit for bit, with
    new versions, so no program captured on the EMA replays on them."""
    monkeypatch.setattr(loop, "DEEP_INFERENCE_EVERY_EPOCH", 1)
    real_ema_weights = loop.ema_weights
    seen = []

    class checked_ema_weights:
        def __init__(self, state):
            self.state, self.inner = state, real_ema_weights(state)

        def __enter__(self):
            self.trained = [p.detach().clone() for p in self.state.params]
            self.key = model._params_key()
            module = self.inner.__enter__()
            assert all(torch.equal(p, e) for p, e in zip(self.state.params, self.state.ema))
            return module

        def __exit__(self, *exc):
            self.inner.__exit__(*exc)
            seen.append(all(torch.equal(p, t) for p, t in zip(self.state.params, self.trained))
                        and model._params_key() != self.key)
            return False

    monkeypatch.setattr(loop, "ema_weights", checked_ema_weights)
    model = _tiny_model(num_eval_files=2)
    ckpt_dir = str(tmp_path / "run")
    state = loop.train_score_model(model, _data_module(dataset), max_epochs=2, ckpt_dir=ckpt_dir,
                                   max_steps_per_epoch=1, seed=0,
                                   logger=MetricsLogger(log_dir=str(tmp_path)))
    assert state.step == 2 and seen == [True, True]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    validations = [r for r in rows if "valid_loss" in r]
    assert [int(r["epoch"]) for r in validations] == [0, 1]
    for r in validations:
        assert all(np.isfinite(r[k]) for k in ("pesq", "si_sdr", "estoi"))
    assert "pesq_-5" in validations[1] and "estoi_35" in validations[1]
    assert "pesq_-5" not in validations[0]
    meta = json.load(open(os.path.join(ckpt_dir, "metadata.json")))
    assert all(k in meta["1"] for k in ("pesq", "si_sdr", "estoi", "si_sdr_00"))
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.best_step("pesq") in (0, 1)
    _, best = load_score_model(ckpt_dir, monitor="pesq", device="cpu")
    assert best.step == mgr.best_step("pesq") + 1
    assert not model._graphs and "_eval_programs" not in model.__dict__


def test_training_validation_without_snr_model_warns(dataset, capsys):
    model = _tiny_model(model_type="sebridge_v3", snr_conditioned="true", num_eval_files=2)
    loop.train_score_model(model, _data_module(dataset), max_epochs=1, max_steps_per_epoch=1)
    assert "no snr_model injected" in capsys.readouterr().out


# -------------------------------------------------------------------- CLIs


def _save_checkpoint(model, directory, metrics=None):
    mgr = CheckpointManager(directory, hparams=model.hparams)
    mgr.save(0, TrainState(model.backbone), metrics or {})
    return directory


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Tiny checkpoints: a bbed model, an SNR estimator (random SNRNet) and
    a sebridge_v3_snr model."""
    root = tmp_path_factory.mktemp("ckpts")
    snr_dir = str(root / "snr")
    snr = SNRNet()
    torch.manual_seed(0)
    mgr = CheckpointManager(snr_dir, monitors=[{"monitor": "snr_error", "mode": "min",
                                                "top_k": 3}], hparams={"config": {}})
    mgr.save(0, TrainState(snr), {"snr_error": 1.0})
    return {
        "bbed": _save_checkpoint(_tiny_model("bbed", full_stft=True), str(root / "bbed")),
        "snr": snr_dir,
        "sebridge_v3_snr": _save_checkpoint(
            _tiny_model("sebridge_v3", snr_conditioned="true", full_stft=True),
            str(root / "v3snr")),
    }


def _check_eval_outputs(out_dir, test_dir):
    """The CSV (one row per file, SI-SDR finite: a NaN output would show
    there, as a wav's PCM cast hides it), the summary, and each wav of its
    input's length."""
    names = sorted(os.listdir(os.path.join(test_dir, "noisy")))
    with open(os.path.join(out_dir, "_results.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "filename,pesq,si_sdr,estoi"
    assert [line.split(",")[0] for line in lines[1:]] == names
    assert all(np.isfinite(float(line.split(",")[2])) for line in lines[1:])
    assert os.path.exists(os.path.join(out_dir, "_avg_results.txt"))
    for name in names:
        out, _ = read_wav(os.path.join(out_dir, "all", name))
        noisy, _ = read_wav(os.path.join(test_dir, "noisy", name))
        assert out.shape == noisy.shape and np.all(np.isfinite(out))


@pytest.mark.parametrize("path,flags", [
    ("per_file", ["--N", "2"]),
    ("per_file_oracle", ["--N", "4", "--reverse_starting_point", "0.5", "--oracle", "True"]),
    ("ode", ["--sampler_type", "ode"]),
    ("batched", ["--eval_batch_size", "2", "--N", "2", "--timestep_type", "logit"]),
    ("packed", ["--eval_batch_size", "2", "--N", "2", "--streaming_chunk_frames", "64"]),
    ("spec", ["--N", "2", "--streaming_chunk_frames", "64"]),
    ("wav", ["--N", "2", "--streaming_chunk_frames", "64", "--streaming_mode", "wav",
             "--streaming_overlap_frames", "8"]),
])
def test_eval_cli_writes_results(dataset, checkpoints, tmp_path, monkeypatch, path, flags):
    """``cli.eval`` on a tiny bbed checkpoint: every path writes the
    enhanced wavs (finite, the input's length), ``_results.csv`` (the bytes
    pandas writes from the same table) and ``_avg_results.txt``."""
    from diffse_tpu_torch.cli import eval as eval_cli

    tables = []
    real_write_csv = results.write_csv
    monkeypatch.setattr(results, "write_csv",
                        lambda p, data: tables.append((p, data)) or real_write_csv(p, data))
    test_dir = os.path.join(dataset, "valid" if path == "per_file_oracle" else "test")
    out_dir = str(tmp_path / path)
    summary = eval_cli.main(["--destination_folder", out_dir, "--test_dir", test_dir,
                             "--ckpt", checkpoints["bbed"], "--device", "cpu", *flags])
    _check_eval_outputs(out_dir, test_dir)
    assert summary["files"] == len(os.listdir(os.path.join(test_dir, "noisy")))
    assert summary["enhance_seconds"] > 0 and summary["scoring_seconds"] > 0
    (csv_path, data), = tables
    with open(csv_path, "rb") as f:
        assert f.read() == pd.DataFrame(data).to_csv(index=False).encode()


def test_eval_cli_start_at_one_is_the_jax_default_fault(dataset, checkpoints, tmp_path):
    """The JAX CLI's default --reverse_starting_point, 1.0, sets BBED's T to
    1.0, where its marginal std is NaN (every bbed output NaN) and the logit
    grid refuses (ROADMAP.md queue 3). Given explicitly, the port does the
    same; by default it keeps the SDE's own T (the other tests)."""
    from diffse_tpu.sde import BBED as JaxBBED
    from diffse_tpu.sampling import timesteps_space as jax_timesteps_space
    from diffse_tpu_torch.cli import eval as eval_cli

    assert np.isnan(np.asarray(JaxBBED(**SDE_KWARGS).replace(T_sampling=1.0)._std(
        jnp.ones((1,))))).all()
    with pytest.raises(ValueError, match="logit grid needs"):
        jax_timesteps_space(1.0, 20, 0.03, "logit")
    args = ["--destination_folder", str(tmp_path), "--test_dir", os.path.join(dataset, "test"),
            "--ckpt", checkpoints["bbed"], "--device", "cpu", "--reverse_starting_point", "1.0"]
    with pytest.raises(ValueError, match="logit grid needs"):
        eval_cli.main(args + ["--eval_batch_size", "2", "--N", "20", "--timestep_type", "logit"])
    eval_cli.main(args + ["--N", "2"])
    table = pd.read_csv(os.path.join(str(tmp_path), "_results.csv"))
    assert table["si_sdr"].isna().all()


def test_eval_cli_snr_branch_and_unported_flag(dataset, checkpoints, tmp_path):
    """The SNR branch writes its results. ``--seq_shards`` (ported: frames-
    parallel enhancement, run over ranks in tests/test_torch_sequence.py)
    with ``--eval_batch_size 2`` is the JAX CLI's parser error, and more
    shards than ranks raises, before any process group is made."""
    from diffse_tpu_torch.cli import eval as eval_cli

    test_dir = os.path.join(dataset, "test")
    out_dir = str(tmp_path / "snr")
    eval_cli.main(["--destination_folder", out_dir, "--test_dir", test_dir, "--ckpt",
                   checkpoints["sebridge_v3_snr"], "--snr_ckpt", checkpoints["snr"],
                   "--device", "cpu"])
    _check_eval_outputs(out_dir, test_dir)
    args = ["--destination_folder", out_dir, "--test_dir", test_dir, "--ckpt",
            checkpoints["bbed"], "--device", "cpu", "--seq_shards", "2"]
    with pytest.raises(SystemExit):
        eval_cli.main(args + ["--eval_batch_size", "2"])
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        eval_cli.main(args)


def test_deep_eval_cli_writes_results(dataset, checkpoints, tmp_path, monkeypatch):
    from diffse_tpu_torch.cli import deep_eval

    tables = []
    real_write_csv = results.write_csv
    monkeypatch.setattr(results, "write_csv",
                        lambda p, data: tables.append((p, data)) or real_write_csv(p, data))
    test_dir = os.path.join(dataset, "valid2")
    out_dir = str(tmp_path / "deep")
    summary = deep_eval.main(["--destination_folder", out_dir, "--test_dir", test_dir,
                              "--ckpt", checkpoints["sebridge_v3_snr"], "--snr_ckpt",
                              checkpoints["snr"], "--device", "cpu"])
    assert summary["files"] == 2
    (csv_path, data), = tables
    assert os.path.basename(csv_path) == "_results_deep.csv"
    with open(csv_path, "rb") as f:
        assert f.read() == pd.DataFrame(data).to_csv(index=False).encode()
    table = pd.read_csv(csv_path)
    assert table.shape == (2, 28) and np.all(np.isfinite(table.iloc[:, 1:].to_numpy()))
    assert list(table.columns[1:4]) == ["pesq_-5", "si_sdr_-5", "estoi_-5"]
    assert os.path.exists(os.path.join(out_dir, "_avg_results_deep.txt"))
    assert sorted(os.listdir(os.path.join(out_dir, "-5"))) == sorted(
        os.listdir(os.path.join(test_dir, "noisy")))


def test_eval_snr_est_cli(dataset, checkpoints, tmp_path, capsys):
    """The mean absolute error written, over SNRs drawn as the JAX CLI
    draws them (numpy's ``default_rng(seed)``)."""
    from diffse_tpu_torch.cli import eval_snr_est

    out_dir = str(tmp_path / "snrest")
    err = eval_snr_est.main(["--destination_folder", out_dir, "--test_dir",
                             os.path.join(dataset, "test"), "--ckpt", checkpoints["snr"],
                             "--seed", "3", "--device", "cpu"])
    printed = capsys.readouterr().out
    rng = np.random.default_rng(3)
    real = [float(line.split("/")[0].split(":")[1]) for line in printed.splitlines()
            if line.startswith("real:")]
    np.testing.assert_allclose(real, [round(rng.random() * 40 - 5, 1) for _ in real], atol=0.051)
    assert len(real) == 3 and np.isfinite(err)
    with open(os.path.join(out_dir, "_snr_est_results.txt")) as f:
        assert f.read() == f"mean_abs_snr_error_db: {err:.4f}\n"


def test_write_csv_matches_pandas(tmp_path):
    data = {"filename": ["a.wav", "b,c.wav", 'q"x.wav'],
            "pesq": [1.2345678901234, float("nan"), 3.0],
            "si_sdr": [np.float32(0.1), np.float32(-3.3333333), np.float32("nan")],
            "estoi": [0.5, 1e-7, np.float64(2.2)],
            "mixed": [np.float32(0.1), 2.0, 1e20]}
    path = str(tmp_path / "t.csv")
    results.write_csv(path, data)
    with open(path, "rb") as f:
        assert f.read() == pd.DataFrame(data).to_csv(index=False).encode()


def test_reverse_starting_point_keys_a_new_program(checkpoints):
    """``--reverse_starting_point`` replaces the SDE; the captured programs
    key on the model's settings, so the old SDE's program is not reused."""
    from diffse_tpu_torch.cli.eval import reverse_start

    model, _ = load_score_model(checkpoints["bbed"], device="cpu")
    key = model._graph_key("bbed_pc", 64, 30, "reverse_diffusion", "ald", 1, False, 1)
    reverse_start(model, 0.5)
    assert model.sde.T_sampling == 0.5
    assert model._graph_key("bbed_pc", 64, 30, "reverse_diffusion", "ald", 1, False, 1) != key
    made = []
    cache = {}
    for _ in range(2):
        model.cached_program(cache, ("k",) + model._program_settings(),
                             lambda: made.append(1) or object())
    reverse_start(model, 1.0)
    model.cached_program(cache, ("k",) + model._program_settings(),
                         lambda: made.append(1) or object())
    assert len(made) == 2
