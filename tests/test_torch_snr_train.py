"""The port's SNR-estimator training against the JAX package's, on the CPU.

Both packages get the same seeded random SNRNet weights (carried over by
``convert.snrnet_state_dict_from_jax``), the same spectrograms and the same
target draw: the JAX ``loss_fn``'s own gt, replayed from its key and fed to
the port's ``loss_from_draws``. Tolerances: the loss within 1e-5 relative;
each parameter's gradient within 1e-4 of its largest magnitude (torch keeps
two LSTM biases where flax keeps one: both get the flax bias's gradient).
Then the loop, its checkpoints and the two CLIs on the port's synthetic
VBD-style dataset (``data/synthetic.py``) at 32 frames.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.snr_model import SNRModel as JaxSNRModel
from diffse_tpu.models.snr_model import SNRModelConfig as JaxSNRModelConfig
from diffse_tpu_torch.convert import snrnet_state_dict_from_jax
from diffse_tpu_torch.data.dataset import DataModuleConfig, SpecsDataModule
from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.models.snr_model import SNRModel, SNRModelConfig
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.train.logging import MetricsLogger
from diffse_tpu_torch.train.loop import train_snr_model
from diffse_tpu_torch.train.restore import load_snr_model
from diffse_tpu_torch.train.state import load_ema
from test_torch_snr import port_snrnet, random_snrnet_params

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FRAMES = 32


def _specs(seed, batch=2):
    """Complex ``[B, 1, 256, FRAMES]`` clean and noisy spectrograms."""
    rng = np.random.default_rng(seed)

    def draw():
        return (rng.standard_normal((batch, 1, 256, FRAMES))
                + 1j * rng.standard_normal((batch, 1, 256, FRAMES))).astype(np.complex64)

    x = draw()
    return x, x + 0.3 * draw()


def _port_model(params):
    return SNRModel(SNRModelConfig(), device="cpu", dnn=port_snrnet(params))


@pytest.fixture(scope="module")
def params():
    return random_snrnet_params(seed=5, fc_bias=-1.0)


def test_loss_and_gradients_match_jax(params):
    x, y = _specs(0)
    key = jax.random.PRNGKey(3)
    jax_model = JaxSNRModel(JaxSNRModelConfig())
    batch = (jnp.asarray(x), jnp.asarray(y))

    def jax_loss(p):
        return jax_model.loss_fn({"params": p}, batch, key)[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    gt = np.array(jax.random.uniform(key, (2,)) * 0.999)

    model = _port_model(params)
    loss = model.loss_from_draws((torch.from_numpy(x), torch.from_numpy(y)),
                                 {"gt": torch.from_numpy(gt)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    assert float(ref_loss) > 1e-3  # the estimate is not already at the target

    ref = snrnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in model.dnn.named_parameters():
        want = ref[name.replace("bias_hh", "bias_ih")].numpy()
        got = p.grad.numpy()
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


def test_loss_fn_draws_gt_from_the_generator(params):
    x, y = _specs(1)
    model = _port_model(params)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    gt = torch.rand(2, generator=torch.Generator().manual_seed(7)) * 0.999
    with torch.no_grad():
        drawn = model.loss_fn(batch, torch.Generator().manual_seed(7))
        given = model.loss_from_draws(batch, {"gt": gt})
    assert torch.equal(drawn, given)


def test_prepare_batch_matches_jax():
    rng = np.random.default_rng(2)
    x_wav = (0.1 * rng.standard_normal((2, (FRAMES - 1) * 128))).astype(np.float32)
    y_wav = (x_wav + 0.05 * rng.standard_normal(x_wav.shape)).astype(np.float32)
    s, n = np.float32([0.1, 0.2]), np.float32([0.05, 0.3])
    ref = JaxSNRModel(JaxSNRModelConfig()).prepare_batch(
        tuple(jnp.asarray(a) for a in (x_wav, y_wav, s, n)))
    out = SNRModel(SNRModelConfig(), device="cpu").prepare_batch((x_wav, y_wav, s, n))
    assert out[0].shape == (2, 1, 256, FRAMES) and out[0].dtype == torch.complex64
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_valid_metrics_match_jax(params):
    x, y = _specs(4)
    s, n = np.float32([1.0, 0.7]), np.float32([0.5, 0.2])
    ref = JaxSNRModel(JaxSNRModelConfig()).valid_metrics(
        {"params": params}, tuple(jnp.asarray(a) for a in (x, y, s, n)))
    model = _port_model(params)
    batch = tuple(torch.from_numpy(a) for a in (x, y, s, n))
    out = model.valid_metrics(batch)
    for k in ("valid_loss", "snr_error"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    # the same with the weights given by name
    variables = {k: v.detach().clone() for k, v in model.dnn.named_parameters()}
    fresh = SNRModel(SNRModelConfig(), device="cpu")
    again = fresh.valid_metrics(batch, variables=variables)
    assert all(torch.equal(again[k], out[k]) for k in out)


# ------------------------------------------------------------------- the loop


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("snrds"))
    return make_synthetic_dataset(root, num_train=4, num_valid=2, num_valid2=1, num_test=2,
                                  duration_s=0.7)


def _data_module(dataset):
    return SpecsDataModule(DataModuleConfig(base_dir=dataset, batch_size=2, num_frames=FRAMES,
                                            num_workers=1, transform_type="none"))


def _first_param(state):
    return next(state.module.parameters()).detach().clone()


def test_train_snr_model_steps_validates_and_resumes(dataset, tmp_path):
    ckpt_dir = str(tmp_path / "run")
    torch.manual_seed(0)
    model = SNRModel(SNRModelConfig(num_frames=FRAMES), device="cpu")
    before = _first_param(TrainState(model.dnn))
    state = train_snr_model(model, _data_module(dataset), max_epochs=1, ckpt_dir=ckpt_dir,
                            max_steps_per_epoch=2, logger=MetricsLogger(log_dir=str(tmp_path)))
    assert state.step == 2 and not torch.equal(_first_param(state), before)
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    (valid,) = [r for r in rows if "snr_error" in r]
    assert np.isfinite(valid["snr_error"]) and np.isfinite(valid["valid_loss"])
    meta = json.load(open(os.path.join(ckpt_dir, "metadata.json")))
    assert meta["0"]["snr_error"] == pytest.approx(valid["snr_error"])

    torch.manual_seed(1)
    again = SNRModel(SNRModelConfig(num_frames=FRAMES), device="cpu")
    resumed = train_snr_model(again, _data_module(dataset), max_epochs=2, ckpt_dir=ckpt_dir,
                              max_steps_per_epoch=2, resume=True)
    assert resumed.step == 4 and CheckpointManager(ckpt_dir).all_steps() == [0, 1]

    loaded, loaded_state = load_snr_model(ckpt_dir, step=1, device="cpu")
    assert loaded_state.step == 4 and loaded.cfg.num_frames == FRAMES
    assert torch.equal(_first_param(loaded_state), _first_param(resumed))
    for e, e_loaded in zip(resumed.ema, loaded_state.ema):
        assert torch.equal(e, e_loaded)


def test_train_snr_model_validates_on_the_ema(dataset, monkeypatch):
    """Validation runs with the EMA in SNRNet's parameters and puts the
    trained weights back after."""
    from diffse_tpu_torch.train import loop

    torch.manual_seed(2)
    model = SNRModel(SNRModelConfig(num_frames=FRAMES), device="cpu")
    states, seen = [], []
    real_ema_weights, real_valid = loop.ema_weights, model.valid_metrics

    def recording_ema_weights(state):
        states.append(state)
        return real_ema_weights(state)

    def checked_valid(batch, variables=None):
        seen.append(all(torch.equal(p, e) for p, e in zip(states[-1].params, states[-1].ema)))
        return real_valid(batch, variables)

    monkeypatch.setattr(loop, "ema_weights", recording_ema_weights)
    monkeypatch.setattr(model, "valid_metrics", checked_valid)
    state = train_snr_model(model, _data_module(dataset), max_epochs=1, max_steps_per_epoch=1)
    assert seen == [True, True]
    assert not all(torch.equal(p, e) for p, e in zip(state.params, state.ema))


class _SigtermAt:
    """``data_module``'s batches, with SIGTERM raised in the process while
    batch ``at`` of the first epoch is fetched."""

    def __init__(self, data_module, at):
        self.dm, self.at, self.cfg = data_module, at, data_module.cfg

    def setup(self, stage):
        self.dm.setup(stage)

    def train_dataloader(self):
        for i, batch in enumerate(self.dm.train_dataloader()):
            if i == self.at:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    def val_dataloader(self):
        return self.dm.val_dataloader()


def test_train_snr_model_sigterm_checkpoints_and_exits(dataset, tmp_path):
    """SIGTERM while batch 1 is fetched: that step still runs, then a
    checkpoint and a clean return; a resumed run restores it."""
    ckpt_dir = str(tmp_path / "preempt")
    torch.manual_seed(3)
    model = SNRModel(SNRModelConfig(num_frames=FRAMES), device="cpu")
    state = train_snr_model(model, _SigtermAt(_data_module(dataset), 1), max_epochs=3,
                            ckpt_dir=ckpt_dir)
    assert state.step == 2 and CheckpointManager(ckpt_dir).all_steps() == [0]
    assert signal.getsignal(signal.SIGTERM) is not None  # the handler is given back
    _, restored = load_snr_model(ckpt_dir, device="cpu")
    assert restored.step == 2 and torch.equal(_first_param(restored), _first_param(state))


CLI_ARGS = ["--transform_type", "none", "--batch_size", "2", "--num_frames", str(FRAMES),
            "--num_workers", "1", "--max_steps_per_epoch", "2", "--seed", "0",
            "--device", "cpu"]


def test_cli_trains_resumes_and_feeds_eval_and_snr_ckpt(dataset, tmp_path, capsys):
    from diffse_tpu_torch.cli import eval as eval_cli
    from diffse_tpu_torch.cli import eval_snr_est, train_snr_est

    ckpt_dir = str(tmp_path / "snr_run")
    state = train_snr_est.main([*CLI_ARGS, "--base_dir", dataset, "--max_epochs", "1",
                                "--ckpt_dir", ckpt_dir])
    assert state.step == 2
    with open(os.path.join(ckpt_dir, "hparams.json")) as f:
        hp = json.load(f)
    assert hp["config"]["num_frames"] == FRAMES and hp["config"]["transform_type"] == "none"
    # the initial weights come from --seed
    torch.manual_seed(0)
    from diffse_tpu_torch.models.snrnet import SNRNet
    assert torch.equal(next(SNRNet().parameters()),
                       next(train_snr_est.main([*CLI_ARGS, "--base_dir", dataset,
                                                "--max_epochs", "0", "--nolog"])
                            .module.parameters()))

    resumed = train_snr_est.main([*CLI_ARGS, "--base_dir", dataset, "--max_epochs", "2",
                                  "--ckpt_dir", ckpt_dir, "--resume"])
    assert resumed.step == 4 and CheckpointManager(ckpt_dir).latest_step() == 1

    capsys.readouterr()
    err = eval_snr_est.main(["--test_dir", os.path.join(dataset, "test"), "--ckpt", ckpt_dir,
                             "--destination_folder", str(tmp_path / "est"), "--device", "cpu"])
    assert np.isfinite(err)
    assert len([line for line in capsys.readouterr().out.splitlines()
                if line.startswith("real:")]) == 2

    # --snr_ckpt: the evaluation CLI's sebridge_v3_snr model estimates with it
    score = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="ouve", model_type="sebridge_v3",
                                        snr_conditioned="true", fixed_snr=0.17783,
                                        sigma_max=1.0),
                       backbone_kwargs=dict(nf=4, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1,
                                            attn_resolutions=(16,), image_size=256),
                       sde_kwargs=dict(sigma_max=1.0), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    score_dir = str(tmp_path / "score")
    CheckpointManager(score_dir, hparams=score.hparams).save(0, TrainState(score.backbone), {})
    out_dir = str(tmp_path / "enh")
    eval_cli.main(["--destination_folder", out_dir, "--test_dir", os.path.join(dataset, "test"),
                   "--ckpt", score_dir, "--snr_ckpt", ckpt_dir, "--device", "cpu"])
    assert len(os.listdir(os.path.join(out_dir, "all"))) == 2

    snr_model, snr_state = load_snr_model(ckpt_dir, device="cpu")
    load_ema(snr_state)
    score.snr_model = snr_model.dnn
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8000)).astype(np.float32))
    np.testing.assert_allclose(score.estimate_snr(wav).numpy(),
                               snr_model.estimate_from_wav(wav).numpy(), rtol=1e-6)


@pytest.mark.parametrize("flag", [["--no_mesh"], ["--tp_size", "1"]])
def test_cli_refuses_unported_flags(dataset, tmp_path, flag):
    """The flags are ported; on one process each trains an epoch (the
    data-parallel CLI on 2 ranks: tests/test_torch_parallel.py)."""
    from diffse_tpu_torch.cli import train_snr_est

    state = train_snr_est.main([*CLI_ARGS, "--base_dir", dataset, "--ckpt_dir", str(tmp_path),
                                "--max_epochs", "1", *flag])
    assert state.step == 2 and state.mesh is None


@pytest.mark.parametrize("flag", [["--tp_size", "2"], ["--chain_steps", "2"]])
def test_cli_refuses_tensor_parallelism_and_chaining(dataset, tmp_path, flag, capsys):
    """The SNR estimator trains data-parallel only, one update a step, as
    the JAX package's ``train_snr_model``: a parser error, not a silent
    fallback."""
    from diffse_tpu_torch.cli import train_snr_est

    with pytest.raises(SystemExit):
        train_snr_est.main([*CLI_ARGS, "--base_dir", dataset, "--ckpt_dir", str(tmp_path), *flag])
    assert "data-parallel only" in capsys.readouterr().err


def test_cli_runs_on_the_card_by_default(dataset, monkeypatch):
    from diffse_tpu_torch.cli import train_snr_est

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_snr_est.main([*args, "--base_dir", dataset, "--nolog"])
