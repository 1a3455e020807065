"""The port's checkpoints, training loop and CLI, on the CPU: the JAX
package's expectations (tests/test_train.py, tests/test_cli.py) for the
port's own files, with no framework crossing. Top-k retention, the lowest-
first monitor, recovery from a step whose save never completed, SIGTERM,
resume and its epoch numbering, ``eval_every_n_epochs``, the stage timer and
the JSONL logger; the CLI on the JAX package's synthetic VBD-style fixture
(``diffse_tpu.data.synthetic``), through a checkpoint and a resume, and
``load_score_model`` on its output."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from diffse_tpu.data.synthetic import make_synthetic_dataset
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.train import CheckpointManager, TrainState
from diffse_tpu_torch.train.logging import MetricsLogger
from diffse_tpu_torch.train.loop import _stack_groups, eval_model_type, train_score_model
from diffse_tpu_torch.train.profiling import StageTimer, rtf
from diffse_tpu_torch.train.restore import load_score_model
from test_torch_train_loss import SDE_KWARGS, STFT, TINY

torch.set_num_threads(2)

WAV_LEN = (STFT["num_frames"] - 1) * STFT["hop_length"]


def _model(**config):
    cfg = ScoreModelConfig(**{**dict(backbone="ncsnpp", sde="bbed", snr_conditioned="false",
                                     model_type="sebridge_v2", sigma_max=1.0, num_eval_files=0,
                                     **STFT), **config})
    return ScoreModel(cfg, backbone_kwargs=TINY, sde_kwargs=SDE_KWARGS, device="cpu",
                      generator=torch.Generator().manual_seed(0))


def _state():
    return TrainState(_model().backbone)


class _DataModule:
    """Two batches of two random pairs an epoch; ``sigterm_at`` raises
    SIGTERM in the process while that batch is fetched."""

    class cfg:
        batch_size = 2

    def __init__(self, batches=2, sigterm_at=None, valid=False):
        self.batches, self.sigterm_at, self.valid = batches, sigterm_at, valid
        self.rng = np.random.default_rng(0)

    def setup(self, stage):
        pass

    def _pair(self):
        x = self.rng.standard_normal((2, WAV_LEN)).astype(np.float32)
        return x, (x + 0.3 * self.rng.standard_normal((2, WAV_LEN))).astype(np.float32)

    def train_dataloader(self):
        for i in range(self.batches):
            if i == self.sigterm_at:
                signal.raise_signal(signal.SIGTERM)
            yield self._pair()

    def val_dataloader(self):
        return [self._pair()] if self.valid else []


def _first_param(state):
    """The first trained parameter (the Fourier features' W is frozen)."""
    return state.params[0].detach().clone()


def test_checkpoint_topk_retention(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpts"),
                            monitors=[{"monitor": "pesq", "mode": "max", "top_k": 2}],
                            save_last=True, hparams={"backbone": "ncsnpp"})
    for i, p in enumerate([1.0, 3.0, 2.0, 2.5, 0.5]):
        with torch.no_grad():
            state.params[0].add_(1.0)
        state.step = i
        mgr.save(i, state, {"pesq": p})
    # top-2 pesq = steps 1 (3.0), 3 (2.5); last = step 4
    assert set(mgr.all_steps()) == {1, 3, 4}
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["hparams.json", "metadata.json",
                                                      "step_1", "step_3", "step_4"]
    assert mgr.best_step("pesq") == 1 and mgr.latest_step() == 4
    restored = mgr.restore(_state(), step=1)
    assert restored.step == 1
    torch.testing.assert_close(_first_param(restored), _first_param(state) - 3.0)
    assert mgr.load_hparams() == {"backbone": "ncsnpp"}


def test_checkpoint_min_mode(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "c2"),
                            monitors=[{"monitor": "snr_error", "mode": "min", "top_k": 1}])
    for i, e in enumerate([5.0, 1.0, 3.0]):
        mgr.save(i, state, {"snr_error": e})
    assert set(mgr.all_steps()) == {1, 2}
    assert mgr.best_step("snr_error", mode="min") == 1


def test_checkpoint_recovers_from_uncommitted_step(tmp_path):
    """metadata.json naming a step whose directory was never completed: a
    new manager falls back to the newest complete step."""
    state = _state()
    d = str(tmp_path / "c3")
    mgr = CheckpointManager(d, monitors=[{"monitor": "pesq", "mode": "max", "top_k": 5}])
    mgr.save(0, state, {"pesq": 1.0})
    state.step = 7
    mgr.save(1, state, {"pesq": 2.0})
    meta_path = tmp_path / "c3" / "metadata.json"
    meta = json.loads(meta_path.read_text())
    meta["2"] = {"pesq": 9.9}
    meta_path.write_text(json.dumps(meta))
    os.makedirs(tmp_path / "c3" / "step_2.tmp")  # a save cut off before its rename

    mgr2 = CheckpointManager(d, monitors=[{"monitor": "pesq", "mode": "max", "top_k": 5}])
    assert mgr2.latest_step() == 1
    assert mgr2.best_step("pesq") == 1  # the phantom 9.9 entry is dropped
    assert mgr2.restore(_state()).step == 7


def test_profiling_stage_timer():
    timer = StageTimer()
    with timer.stage("a", sync=False):
        sum(range(1000))
    with timer.stage("a", sync=False):
        pass
    with timer.stage("b"):
        pass
    assert timer.counts["a"] == 2 and timer.counts["b"] == 1
    assert "a:" in timer.summary()
    assert rtf(1.0, 2.0) == 0.5


def test_metrics_logger_jsonl(tmp_path):
    logger = MetricsLogger(log_dir=str(tmp_path))
    logger.log({"train_loss": torch.tensor(1.5)}, step=3)
    logger.log({"pesq": 2.9, "si_sdr": 17.0}, step=4)
    logger.close()
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert lines[0]["train_loss"] == 1.5 and lines[0]["step"] == 3
    assert lines[1]["pesq"] == 2.9


def test_stack_groups_drops_ragged_tail():
    batches = [(np.ones((4, 3)), np.zeros((4,))), (np.ones((4, 3)) * 2, np.zeros((4,))),
               (np.ones((4, 3)) * 3, np.zeros((4,))), (np.ones((2, 3)), np.zeros((2,)))]
    groups = list(_stack_groups(iter(batches), 2))
    assert len(groups) == 1
    assert groups[0][0].shape == (2, 4, 3)
    np.testing.assert_array_equal(groups[0][0][1], np.ones((4, 3)) * 2)


def test_eval_model_type():
    assert eval_model_type("false", "bbed") == "bbed"
    assert eval_model_type("fixed", "sebridge_v3") == "sebridge_v3_fixed"
    assert eval_model_type("true", "sebridge_v3") == "sebridge_v3_snr"


def test_sigterm_checkpoints_and_exits(tmp_path):
    """SIGTERM while batch 2 is fetched: that step still runs, then a
    checkpoint and a clean return; a resumed run restores it."""
    ckpt_dir = str(tmp_path / "preempt")
    state = train_score_model(_model(), _DataModule(batches=10, sigterm_at=2), max_epochs=3,
                              ckpt_dir=ckpt_dir, seed=0)
    assert state.step == 3
    assert signal.getsignal(signal.SIGTERM) is not None  # the handler is given back
    resumed = train_score_model(_model(), _DataModule(), max_epochs=0, ckpt_dir=ckpt_dir,
                                seed=0, resume=True)
    assert resumed.step == 3
    assert torch.equal(_first_param(state), _first_param(resumed))
    assert all(torch.equal(a, b) for a, b in zip(state.ema, resumed.ema))


def test_resume_continues_epoch_numbering(tmp_path):
    ckpt_dir = str(tmp_path / "epochs")
    s1 = train_score_model(_model(), _DataModule(), max_epochs=2, ckpt_dir=ckpt_dir, seed=0)
    assert s1.step == 4
    s2 = train_score_model(_model(), _DataModule(), max_epochs=4, ckpt_dir=ckpt_dir, seed=0,
                           resume=True)
    assert s2.step == 8  # epochs 2..3 on top of the restored 4 steps
    mgr = CheckpointManager(ckpt_dir)
    assert mgr.latest_step() == 3
    assert mgr.restore(_state()).step == 8


def test_eval_every_n_epochs_gates_validation_and_saves(tmp_path):
    ckpt_dir = str(tmp_path / "cadence")
    state = train_score_model(_model(), _DataModule(valid=True), max_epochs=5,
                              ckpt_dir=ckpt_dir, seed=0, eval_every_n_epochs=2,
                              logger=MetricsLogger(log_dir=str(tmp_path)))
    assert state.step == 10
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    validated = sorted({int(r["epoch"]) for r in rows if "valid_loss" in r})
    assert validated == [1, 3, 4]
    assert all(np.isfinite(r["valid_loss"]) for r in rows if "valid_loss" in r)
    assert CheckpointManager(ckpt_dir).latest_step() == 4


def test_loop_refuses_enhancement_metrics_and_unported_options():
    """``chain_steps`` and ``tp_size`` are ported (the enhancement metrics
    too: tests/test_torch_eval.py holds the loop's validation). In one
    process: ``chain_steps=2`` stacks the epoch's two batches into one call
    of two updates; ``tp_size=2`` finds one rank and trains without a mesh,
    as the JAX package does on one device (tests/test_torch_parallel*.py
    hold the meshes)."""
    chained = train_score_model(_model(), _DataModule(), chain_steps=2)
    assert chained.step == 2 and chained.mesh is None
    single = train_score_model(_model(), _DataModule(), tp_size=2)
    assert single.step == 2 and single.mesh is None
    for a, b in zip(chained.params, single.params):
        assert torch.equal(a, b)  # two updates either way, the same draws


def test_dropout_in_training_raises():
    """Dropout in training needs keep masks: a training forward of the
    backbone without them raises; ``loss_fn`` draws them from its generator
    and trains (a finite loss, other than the validation loss)."""
    model = ScoreModel(ScoreModelConfig(model_type="sebridge_v2", sde="bbed", **STFT),
                       backbone_kwargs={**TINY, "dropout": 0.1}, sde_kwargs=SDE_KWARGS,
                       device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.zeros((1, 1, 16, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="dropout"):
        model.backbone.train()(torch.cat([x, x], dim=1), torch.full((1,), 0.5))
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((1, 1, 16, 16))
                          + 1j * rng.standard_normal((1, 1, 16, 16))).astype(np.complex64))
    with torch.no_grad():
        train = model.loss_fn((x, x), torch.Generator().manual_seed(0))
        valid = model.loss_fn((x, x), torch.Generator().manual_seed(0), train=False)
    assert torch.isfinite(train) and not torch.equal(train, valid)


def test_remat_gives_the_same_gradients():
    """``remat`` (``torch.utils.checkpoint`` around every residual block)
    recomputes what it drops: the same loss and gradients."""
    grads = []
    for remat in (False, True):
        model = ScoreModel(ScoreModelConfig(model_type="sebridge_v2", sde="bbed", **STFT),
                           backbone_kwargs={**TINY, "remat": remat}, sde_kwargs=SDE_KWARGS,
                           device="cpu", generator=torch.Generator().manual_seed(3))
        rng = np.random.default_rng(4)
        x = torch.from_numpy((rng.standard_normal((2, 1, 16, 16))
                              + 1j * rng.standard_normal((2, 1, 16, 16))).astype(np.complex64))
        model.loss_fn((x, 0.5 * x), torch.Generator().manual_seed(5)).backward()
        grads.append([p.grad for p in model.backbone.parameters() if p.requires_grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clids"))
    return make_synthetic_dataset(root, num_train=4, num_valid=2, num_valid2=2, num_test=2,
                                  duration_s=0.7)


CLI_ARGS = ["--backbone", "ncsnpp", "--sde", "bbed", "--modeltype", "sebridge_v3",
            "--snr_conditioned", "true", "--fixed_snr", "0.17783", "--batch_size", "2",
            "--num_frames", "32", "--num_workers", "1", "--max_steps_per_epoch", "1",
            "--num_eval_files", "0", "--seed", "0", "--device", "cpu",
            "--nf", "4", "--ch_mult", "1", "1", "--attn_resolutions", "8",
            "--image_size", "256"]


def test_train_cli_smoke_and_resume(dataset, tmp_path):
    from diffse_tpu_torch.cli.train import main

    ckpt_dir = str(tmp_path / "run")
    state = main([*CLI_ARGS, "--base_dir", dataset, "--max_epochs", "1", "--ckpt_dir", ckpt_dir])
    assert state.step == 1
    with open(os.path.join(ckpt_dir, "hparams.json")) as f:
        hp = json.load(f)
    assert hp["config"]["model_type"] == "sebridge_v3" and hp["backbone_kwargs"]["nf"] == 4
    assert hp["config"]["num_frames"] == 32 and "fuse_pyramid" not in hp["backbone_kwargs"]
    assert CheckpointManager(ckpt_dir).latest_step() == 0
    rows = [json.loads(line) for line in open(os.path.join(ckpt_dir, "metrics.jsonl"))]
    assert any("train_loss" in r for r in rows) and any("valid_loss" in r for r in rows)

    resumed = main([*CLI_ARGS, "--base_dir", dataset, "--max_epochs", "2", "--ckpt_dir",
                    ckpt_dir, "--resume"])
    assert resumed.step == 2 and CheckpointManager(ckpt_dir).latest_step() == 1

    model, state = load_score_model(ckpt_dir, device="cpu")
    assert state.step == 2 and model.cfg.snr_conditioned == "true"
    assert torch.equal(_first_param(state), _first_param(resumed))


@pytest.mark.parametrize("flag", [["--no_mesh"], ["--tp_size", "1"], ["--chain_steps", "2"]])
def test_train_cli_refuses_unported_flags(dataset, tmp_path, flag):
    """The flags are ported; on one process each trains: ``--no_mesh`` and
    ``--tp_size 1`` one update an epoch, ``--chain_steps 2`` the epoch's two
    batches as one call of two updates (the refusal of ``--no_mesh`` under
    several ranks: tests/test_torch_parallel.py)."""
    from diffse_tpu_torch.cli.train import main

    state = main([*CLI_ARGS, "--base_dir", dataset, "--ckpt_dir", str(tmp_path), "--max_epochs",
                  "1", *flag])
    assert state.step == (2 if flag[0] == "--chain_steps" else 1) and state.mesh is None
    assert CheckpointManager(str(tmp_path)).latest_step() == 0


def test_train_cli_runs_on_the_card_by_default(dataset, monkeypatch):
    from diffse_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([*args, "--base_dir", dataset, "--nolog"])
