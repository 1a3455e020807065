"""Data-parallel training, ``chain_steps`` and preemption across ranks on the
CPU: the port's steps on gloo ranks against the JAX package's mesh steps
(its 8 virtual CPU devices) on the same weights (``convert.py``), batch and
draws (the JAX step's own, replayed as ``test_torch_train_step`` feeds
them).

  - a 2-rank data-parallel step of the tiny NCSN++ (sebridge_v3,
    SNR-conditioned) against ``make_train_step(mesh=make_mesh(2 devices))``,
    and with ``accum_steps`` 2: the loss within 1e-5 relative, the weights
    and the EMA within ``CLEAR_ATOL`` where the gradient is clear of zero
    and within 2 lr in its band (``assert_weights_match``; for DCUNet the
    band is ``DCUNET_F32_GRAD_TOL``), the reduced gradients within
    ``PARALLEL_GRAD_TOL`` of the port's one-process step's (see
    ``test_torch_parallel`` for the tolerance);
  - a 2-rank step of DilDCUNet-v2 with "bN": the running statistics, from
    the global batch's statistics, within 2e-6 of max(1, |ref|) of the JAX
    mesh step's on both ranks (``test_torch_dcunet``'s tolerance), the loss
    and weights as above. The gradients through the global batch's
    statistics: in float64 the 2-rank gradients equal the one-process ones
    within 1e-9 of each one's largest magnitude; in float32 within
    ``DCUNET_F32_GRAD_TOL`` of the float64 ones. (Within one process a CPU
    reduction accumulates float32 in float64; the ranks' partial sums meet
    rounded to float32, and this redrawn network's batch norms over 2 rows,
    at a loss near 1.6e3, amplify that: 6.2e-3 of the largest magnitude at
    worst, 1.5e-3 at the median, where one process is 3.1e-3 and 1.5e-6;
    the card accumulates float32 sums in float32 in both cases);
  - ``chain_steps`` 2 in one process against the JAX chained step
    (tests/test_train.py:394), and ``chain_steps`` 2 x ``accum_steps`` 2 on
    2 ranks against the JAX chained step on a 2-device mesh (:433):
    ``"train_loss"`` the last update's, ``"train_loss_mean"`` their mean;
  - SIGTERM to rank 1 of a 2-rank ``train_score_model``: both ranks stop at
    the same step, rank 0 checkpoints, and a resumed run ends with the
    uninterrupted run's weights (tests/test_parallel.py:189).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.parallel import make_mesh as jax_make_mesh
from diffse_tpu_torch.convert import dcunet_state_dict_from_jax, flax_tree_state_dict
from diffse_tpu_torch.parallel import dryrun
from test_torch_dcunet import jax_variables
from test_torch_parallel import (PARALLEL_GRAD_TOL, TIMEOUT, assert_update_matches,
                                 assert_weights_match, chained_draws, jax_step, one_process,
                                 spec_batch, tiny_spec, loss_rtol, LR)
from test_torch_train_loss import LOSS_RTOL, SDE_KWARGS, assert_grads_close, make_models
from torch_parallel_workers import OneBatchData, loss_grads, signal_rank_after, step_cases, train

torch.set_num_threads(2)

STATS_TOL = 2e-6
DCUNET_F32_GRAD_TOL = 1e-2
F64_GRAD_TOL = 1e-9
DCUNET = dict(dcunet_architecture="DilDCUNet-v2")
DCUNET_STFT = dict(n_fft=256, hop_length=64, num_frames=16)  # 129 bins: DilDCUNet-v2's least


def _stack(batches):
    return tuple(np.stack([b[i] for b in batches]) for i in range(len(batches[0])))


@pytest.fixture(scope="module")
def cases():
    """Every 2-rank case's inputs, and the ranks run once over all of them."""
    jax_model, params, _ = make_models("true", "sebridge_v3")
    spec = tiny_spec(params)
    key = jax.random.PRNGKey(2)
    plain = spec_batch(10, 4)
    accum = _stack([spec_batch(20, 4), spec_batch(21, 4)])
    chained = _stack([_stack([spec_batch(22 + 2 * c + m, 4) for m in range(2)])
                      for c in range(2)])
    out = {
        "dp": dict(model=spec, batch=plain, accum=1, chain=1),
        "dp_accum": dict(model=spec, batch=accum, accum=2, chain=1),
        "dp_chain_accum": dict(model=spec, batch=chained, accum=2, chain=2),
    }
    for c in out.values():
        c["draws"] = chained_draws(jax_model, key, (jnp.asarray(c["batch"][0]),),
                                   c["chain"], c["accum"])

    # DilDCUNet-v2 with "bN": bbed score matching on 129 x 16 spectrograms
    kw = dict(backbone="dcunet", sde="bbed", model_type="bbed", snr_conditioned="false",
              sigma_max=1.0, **DCUNET_STFT)
    dc_model = JaxScoreModel(JaxScoreModelConfig(**kw), backbone_kwargs=DCUNET,
                             sde_kwargs=SDE_KWARGS)
    variables = jax_variables(dc_model.backbone, np.zeros((1, 2, 129, 16), np.complex64),
                              np.ones(1, np.float32), seed=6)
    dc_batch = _dcunet_batch(31)
    out["dcunet"] = dict(model={"config": kw, "backbone": DCUNET, "sde": SDE_KWARGS, "lr": LR,
                                "weights": dcunet_state_dict_from_jax(variables)},
                         batch=dc_batch, accum=1, chain=1,
                         draws=chained_draws(dc_model, key, (jnp.asarray(dc_batch[0]),), 1, 1))
    names = list(out)
    ranks = dryrun.launch(step_cases, 2, ([dict(out[n], mesh="dp") for n in names],),
                          device="cpu", timeout=TIMEOUT)
    results = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return {"jax_model": jax_model, "params": params, "key": key, "inputs": out,
            "results": results, "dc_model": dc_model, "dc_variables": variables}


def _dcunet_batch(seed, b=2):
    rng = np.random.default_rng(seed)

    def spec():
        mag = rng.uniform(0.5, 1.0, (b, 1, 129, 16))
        return (mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (b, 1, 129, 16)))).astype(
            np.complex64)

    return spec(), spec()


def gaps(grads: dict, ref: dict) -> np.ndarray:
    return np.array([np.max(np.abs(grads[n] - ref[n])) / np.max(np.abs(ref[n])) for n in ref])


def _check_against_one_process(results, case, steps=1, grad_tol=PARALLEL_GRAD_TOL):
    """Each rank's step against the same step in one process."""
    ref = one_process(case)
    for res in results:
        assert res["step"] == ref["step"] == steps
        assert res["loss"] == pytest.approx(ref["loss"], rel=loss_rtol(steps))
        if grad_tol is not None:
            assert_grads_close(res["grads"], ref["grads"], grad_tol)
    return ref


@pytest.mark.parametrize("name,accum", [("dp", 1), ("dp_accum", 2)])
def test_data_parallel_step_matches_jax(cases, name, accum):
    case, results = cases["inputs"][name], cases["results"][name]
    jax_state, metrics = jax_step(cases["jax_model"], {"params": cases["params"]}, case["batch"],
                                  cases["key"], mesh=jax_make_mesh(jax.devices()[:2]),
                                  accum=accum)
    _check_against_one_process(results, case)
    for res in results:
        assert res["rows"] == 2
        assert_update_matches(res, jax_state, float(metrics["train_loss"]))
    for name_, value in results[0]["params"].items():
        np.testing.assert_array_equal(value, results[1]["params"][name_], err_msg=name_)


def test_dcunet_batch_norm_statistics_match_jax(cases):
    """The "bN" running statistics come from the global batch's statistics
    (all-reduced over the data axis, gradients included): equal on both
    ranks and within ``STATS_TOL`` of the JAX mesh step's."""
    case, results = cases["inputs"]["dcunet"], cases["results"]["dcunet"]
    jax_state, metrics = jax_step(cases["dc_model"], cases["dc_variables"], case["batch"],
                                  cases["key"], mesh=jax_make_mesh(jax.devices()[:2]))
    _check_against_one_process(results, case, grad_tol=None)
    exact = loss_grads(None, case, torch.float64)
    ranks64 = dryrun.launch(loss_grads, 2, (case, torch.float64), device="cpu", timeout=TIMEOUT)
    for grads64 in ranks64:
        assert gaps(grads64, exact).max() <= F64_GRAD_TOL
    for res in results:
        assert gaps(res["grads"], exact).max() <= DCUNET_F32_GRAD_TOL
    stats = flax_tree_state_dict(jax.tree_util.tree_map(
        np.asarray, jax_state.variables["batch_stats"]))
    ref_params = {k: v.numpy() for k, v in dcunet_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jax_state.variables["params"])}).items()}
    ref_loss = float(metrics["train_loss"])
    assert len(stats) > 20
    for res in results:
        assert res["rows"] == 1
        assert abs(res["loss"] - ref_loss) <= LOSS_RTOL * abs(ref_loss)
        for name, value in stats.items():
            err = np.max(np.abs(res["buffers"][name] - value))
            assert err <= STATS_TOL * max(1.0, np.max(np.abs(value))), (name, err)
        assert_weights_match("params", res["params"], ref_params, res["grads"],
                             band_tol=DCUNET_F32_GRAD_TOL)
    for name, value in results[0]["buffers"].items():
        np.testing.assert_array_equal(value, results[1]["buffers"][name], err_msg=name)


def test_chain_steps_match_jax_chained_step(cases):
    """``chain_steps`` 2 in one process: two updates in one call, against
    the JAX package's chained step (one scanned program) on the same keys."""
    jax_model, params, key = cases["jax_model"], cases["params"], cases["key"]
    batch = _stack([spec_batch(40, 2), spec_batch(41, 2)])
    case = dict(model=tiny_spec(params), batch=batch, accum=1, chain=2,
                draws=chained_draws(jax_model, key, (jnp.asarray(batch[0]),), 2, 1))
    res = one_process(case)
    jax_state, metrics = jax_step(jax_model, {"params": params}, batch, key, chain=2)
    assert res["step"] == int(jax_state.step) == 2
    assert res["loss_mean"] == pytest.approx(float(metrics["train_loss_mean"]), rel=loss_rtol(2))
    assert_update_matches(res, jax_state, float(metrics["train_loss"]), steps=2)


def test_chain_and_accum_steps_over_a_mesh_match_jax(cases):
    """``chain_steps`` 2 x ``accum_steps`` 2 on 2 ranks (batch axes (chain,
    accum, b), the data axis at 2) against the JAX chained step on a
    2-device mesh."""
    case, results = cases["inputs"]["dp_chain_accum"], cases["results"]["dp_chain_accum"]
    jax_state, metrics = jax_step(cases["jax_model"], {"params": cases["params"]}, case["batch"],
                                  cases["key"], mesh=jax_make_mesh(jax.devices()[:2]), accum=2,
                                  chain=2)
    ref = _check_against_one_process(results, case, steps=2)
    for res in results:
        assert res["rows"] == 2
        assert res["loss_mean"] == pytest.approx(float(metrics["train_loss_mean"]),
                                                 rel=loss_rtol(2))
        assert res["loss_mean"] == pytest.approx(ref["loss_mean"], rel=loss_rtol(2))
        assert_update_matches(res, jax_state, float(metrics["train_loss"]), steps=2)


# ------------------------------------------------------------- preemption


def test_sigterm_to_one_rank_stops_both_and_resume_ends_where_an_uninterrupted_run_does(
        tmp_path):
    _, params, _ = make_models("false", "sebridge_v2")
    model = tiny_spec(params, model_type="sebridge_v2", snr_conditioned="false",
                      num_eval_files=0)
    epochs = 6

    def run(name, resume=False, progress=None):
        spec = dict(model=model, data=OneBatchData, epochs=epochs, resume=resume,
                    ckpt=str(tmp_path / name), progress=progress, pause=0.2)
        on_start = None
        if progress:
            def on_start(procs):
                signal_rank_after(procs, 1, progress, lines=2)
        return dryrun.launch(train, 2, (spec,), device="cpu", timeout=TIMEOUT, on_start=on_start)

    progress = str(tmp_path / "progress.jsonl")
    stopped = run("run", progress=progress)
    assert stopped[0]["step"] == stopped[1]["step"] < epochs  # a coordinated stop
    from diffse_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "run"))
    assert mgr.latest_step() == stopped[0]["step"] - 1  # the stopped epoch, by rank 0
    resumed = run("run", resume=True)
    clean = run("clean")
    for r in (*resumed, *clean):
        assert r["step"] == epochs
    for name, value in clean[0]["params"].items():
        np.testing.assert_array_equal(resumed[0]["params"][name], value, err_msg=name)
        np.testing.assert_array_equal(resumed[1]["params"][name], value, err_msg=name)
    assert os.path.exists(progress)
