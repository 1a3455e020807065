"""The port's parallel layer (``diffse_tpu_torch.parallel``) on the CPU, held
to the JAX package's (``diffse_tpu.parallel``) at its 8 virtual CPU devices.

  - ``initialize_distributed``'s failure policy, as tests/test_parallel.py
    holds the JAX one's;
  - the mesh helpers, the collectives and the global batch mean on 2 gloo
    ranks;
  - the tensor-parallel layout (``leaf_partition_spec``): every leaf's
    local shard shape on the full 65.6M flagship tree equals the JAX
    ``state_shardings(make_2d_mesh(1, 2), state)`` shard shape, mapped
    through ``convert.py`` (shapes only, as tests/test_train.py:657);
  - tensor-parallel train steps on ``(1, 2)`` and ``(2, 2)`` meshes of gloo
    ranks against the JAX package's ``make_2d_mesh`` steps on the same
    weights, batch and draws: the loss within 1e-5 relative; the weights
    and the EMA after within 1e-6 where the gradient is clear of zero, and
    within 2 lr in its band (Adam's first update is ~lr * sign(g): a
    gradient near zero may take the other sign); every local shard
    (weights, EMA, moments) of the JAX shard shape; the reduced gradients
    within ``PARALLEL_GRAD_TOL`` of each one's largest magnitude of the
    port's one-process gradients on the same inputs (the parallel layer
    reorders sums only), and within ``JAX_GRAD_TOL`` of
    ``jax.value_and_grad`` of the JAX loss (jitted). The tolerances are
    those of one parameter on this batch: the output conv's bias
    (``all_modules.21.bias``), whose gradient under the consistency loss is
    the difference of its two forwards' nearly equal contributions. The
    JAX package's own jitted and op-by-op gradients of it are 1.14e-3 of
    its largest magnitude apart, the port's one-process gradient 2.1e-4
    from the jitted one, and the sum of the 4 rows taken as 2 + 2 over the
    data axis 1.17e-4 from the sum over 4. ``test_torch_train_loss``'s
    inputs keep all of them within 1e-4;
  - a checkpoint saved under ``(1, 2)`` restores on one process with equal
    tensors;
  - ``batch_enhance(mesh=)`` on 2 ranks against no mesh, within 1e-5;
  - the training CLIs on 2 ranks: ``cli.train --tp_size 2 --chain_steps 2``,
    ``cli.train_snr_est`` data-parallel, and ``--no_mesh`` a parser error;
  - ``parallel.dryrun.dryrun_multichip(4)``.

Then data-parallel training, ``chain_steps`` and preemption across ranks
(the JAX package's mesh steps on its 8 virtual CPU devices; the draws the
JAX step's own, replayed as ``test_torch_train_step`` feeds them):

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

Every multi-rank test runs its ranks through ``dryrun.launch`` with its own
time limit (``TIMEOUT``); the rank functions are in
``tests/torch_parallel_workers.py``.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from diffse_tpu.models.score_model import ScoreModel as JaxScoreModel
from diffse_tpu.models.score_model import ScoreModelConfig as JaxScoreModelConfig
from diffse_tpu.parallel import make_2d_mesh as jax_make_2d_mesh
from diffse_tpu.parallel import make_mesh as jax_make_mesh
from diffse_tpu.parallel import replicate as jax_replicate
from diffse_tpu.parallel import shard_batch as jax_shard_batch
from diffse_tpu.parallel import shard_state as jax_shard_state
from diffse_tpu.parallel import stacked_batch_sharding as jax_stacked_batch_sharding
from diffse_tpu.parallel import state_shardings as jax_state_shardings
from diffse_tpu.train.state import create_train_state
from diffse_tpu.train.steps import make_train_step as jax_make_train_step
from diffse_tpu_torch.convert import (dcunet_state_dict_from_jax, flax_tree_state_dict,
                                      state_dict_from_jax)
from diffse_tpu_torch.parallel import dryrun
from diffse_tpu_torch.parallel import mesh as mesh_mod
from diffse_tpu_torch.parallel.model_sharding import partition_specs
from diffse_tpu_torch.train import CheckpointManager, TrainState
from test_torch_dcunet import jax_variables
from test_torch_train_loss import (LOSS_RTOL, SDE_KWARGS, STFT, TINY, assert_grads_close,
                                   gradient_scale, jax_loss_draws, make_models)
from torch_parallel_workers import (OneBatchData, clis, collectives, enhance, loss_grads,
                                    signal_rank_after, step_cases, train)

torch.set_num_threads(2)

LR = 1e-4
TIMEOUT = 240  # seconds, for each launch of ranks
BATCH = 4
PARALLEL_GRAD_TOL = 2e-4
JAX_GRAD_TOL = 2e-3
# a weight's gap after Adam where the first gradient is clear of its band:
# the float32 rounding after one update; after two a tenth of lr, since the
# second follows m / sqrt(v) of a gradient taken at weights that differ in
# the band (9.4e-7 at most on these inputs). A wrong sign moves a weight 2 lr.
CLEAR_ATOL = {1: 1e-6, 2: 0.1 * LR}


# ------------------------------------------------ initialize_distributed


class _Boom(RuntimeError):
    pass


@pytest.fixture
def broken_initialize(monkeypatch):
    def _raise(*args, **kwargs):
        raise _Boom("connection refused to coordinator")

    monkeypatch.setattr(dist, "init_process_group", _raise)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for v in mesh_mod.COORDINATOR_ENV:
        monkeypatch.delenv(v, raising=False)


def test_no_coordinator_degrades_to_single_process(broken_initialize):
    mesh_mod.initialize_distributed(device="cpu")
    assert mesh_mod.world_size() == 1


def test_explicit_coordinator_failure_reraises(broken_initialize):
    with pytest.raises(_Boom):
        mesh_mod.initialize_distributed(device="cpu", init_method="tcp://10.0.0.1:1234",
                                        world_size=2, rank=0)


def test_env_coordinator_failure_reraises(broken_initialize, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    with pytest.raises(_Boom):
        mesh_mod.initialize_distributed(device="cpu")


def test_already_initialized_is_noop(monkeypatch):
    def _raise(*args, **kwargs):
        raise AssertionError("initialised twice")

    monkeypatch.setattr(dist, "init_process_group", _raise)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    mesh_mod.initialize_distributed(device="cpu", init_method="tcp://10.0.0.1:1234")


def test_mesh_helpers_and_collectives_on_two_ranks():
    r0, r1 = dryrun.launch(collectives, 2, device="cpu", timeout=TIMEOUT)
    assert r0["placements"] == ["(Shard(dim=0),)", "(Shard(dim=2),)"]
    # rows: each rank its half of the batch axis (after one leading axis)
    assert r0["rows"][0] == np.arange(24.0).reshape(2, 4, 3)[:, :2].tolist()
    assert r1["rows"][0] == np.arange(24.0).reshape(2, 4, 3)[:, 2:].tolist()
    assert (r0["rows"][1], r1["rows"][1]) == ([0.0, 1.0, 2.0, 3.0], [4.0, 5.0, 6.0, 7.0])
    assert r0["replicated"] == r1["replicated"] == [0.0] * 6  # rank 0's weights
    for r in (r0, r1):
        assert r["mean"] == [5.0, 6.0, 7.0, 8.0]
        assert r["gather"] == [0.0, 1.0, 10.0, 11.0]
        assert r["any"] == [True, False]
        # [0, 1, 2, 3] + [10, 11, 12, 13] = [10, 12, 14, 16], halves by rank
    assert (r0["reduce_scatter"], r1["reduce_scatter"]) == ([10.0, 12.0], [14.0, 16.0])
    # the mean of x^2 over both ranks' rows [[1, 0], [2, 2]]: 9 / 4 on each.
    # Each rank's loss is one term of the sum that a step's gradient mean
    # divides by the ranks, so each rank's x gets the gradient of both
    # terms: 2 x (2 / 4)
    assert r0["batch_mean"][0] == r1["batch_mean"][0] == pytest.approx(9 / 4)
    assert (r0["batch_mean"][1], r1["batch_mean"][1]) == ([[1.0, 0.0]], [[2.0, 2.0]])
    # _maybe_mesh: off, batch 3 over 2 ranks, a 2-rank data mesh, tp 3 over
    # 2 ranks, a (1, 2) mesh
    assert r0["maybe_mesh"] == [True, True, (2,), True, (1, 2)]


# ------------------------------------------------------ the layout rule


def _jax_shard_shapes(mesh, params):
    """The JAX shard shape of every leaf of ``params`` (shapes), as zeros
    mapped through the weight bridge: {port name: shape}."""
    sh = jax_state_shardings(mesh, {"params": params})["params"]
    zeros = jax.tree_util.tree_map(lambda leaf, s: np.zeros(s.shard_shape(leaf.shape), np.float32),
                                   params, sh)
    return zeros


def test_leaf_partition_spec_matches_jax_on_the_flagship_tree():
    from diffse_tpu_torch.models.ncsnpp import NCSNpp

    cfg = JaxScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                              snr_conditioned="false", sigma_max=0.5, num_frames=64)
    jax_model = JaxScoreModel(cfg, backbone_kwargs={}, sde_kwargs=SDE_KWARGS)
    shapes = jax.eval_shape(lambda k: jax_model.init_variables(k, num_frames=64),
                            jax.random.PRNGKey(0))["params"]
    ref = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        _jax_shard_shapes(jax_make_2d_mesh(1, 2), shapes)).items()}
    module = NCSNpp()
    n_params = sum(p.numel() for p in module.parameters())
    assert n_params > 60e6  # really the flagship tree
    specs = partition_specs(module, 2)
    local = {}
    for name, p in module.named_parameters():
        shape = list(p.shape)
        if isinstance(specs[name], mesh_mod.Shard):
            shape[0] //= 2
        local[name] = tuple(shape)
    assert local == ref
    sharded = [n for n, s in specs.items() if isinstance(s, mesh_mod.Shard)]
    assert len(sharded) > 100
    # a FIR conv's weight (flax "weight", not "kernel") and NIN's W stay whole
    assert not any(n.endswith("Conv2d_0.weight") or n.endswith(".W") for n in sharded)


# --------------------------------------------------- tensor-parallel steps


def spec_batch(seed, b):
    """A global batch of ``b`` clean/noisy complex spectrograms of 16 x 16."""
    rng = np.random.default_rng(seed)

    def spec():
        mag = rng.uniform(0.5, 1.0, (b, 1, 16, 16))
        return (mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (b, 1, 16, 16)))).astype(
            np.complex64)

    return spec(), spec()


def tiny_spec(params, **config):
    """The port's model of ``make_models``' branch, as a rank rebuilds it."""
    kw = {**dict(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3", snr_conditioned="true",
                 fixed_snr=0.17783, sigma_max=1.0, loss_type="mse", **STFT), **config}
    return {"config": kw, "backbone": TINY, "sde": SDE_KWARGS, "lr": LR,
            "weights": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), **TINY)}


def chained_draws(jax_model, key, batch, chain, accum):
    """The JAX step's draws, in the port's order: per update (its key from
    ``split(key, chain)``), per microbatch (``split(k, accum)``)."""
    keys = jax.random.split(key, chain) if chain > 1 else [key]
    x = batch[0]
    draws = []
    for c, k in enumerate(keys):
        xc = x[c] if chain > 1 else x
        mkeys = jax.random.split(k, accum) if accum > 1 else [k]
        for m, mk in enumerate(mkeys):
            draws.append(jax_loss_draws(jax_model, mk, jnp.asarray(xc[m] if accum > 1 else xc)))
    return draws


def jax_step(jax_model, variables, batch, key, mesh=None, tp=False, accum=1, chain=1):
    """The JAX package's step over ``mesh``; returns the new state and metrics."""
    opt = optax.adam(LR)
    state = create_train_state(variables, opt)
    ssh = jax_state_shardings(mesh, state) if tp else None
    step = jax_make_train_step(jax_model, opt, ema_decay=0.999, donate=False, mesh=mesh,
                               state_sharding=ssh, accum_steps=accum, chain_steps=chain)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    if mesh is not None:
        lead = int(chain > 1) + int(accum > 1)
        state = jax_shard_state(mesh, state) if tp else jax_replicate(mesh, state)
        jbatch = jax_shard_batch(mesh, jbatch, spec=None if lead == 0
                                 else jax_stacked_batch_sharding(mesh, lead))
    return step(state, jbatch, key)


def jax_grads(jax_model, params, batch, key):
    """``jax.value_and_grad`` of the JAX loss on the global batch, by port name."""
    def loss(p):
        return jax_model.loss_fn({"params": p}, tuple(jnp.asarray(a) for a in batch), key)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), **TINY).items()}


def one_process(case) -> dict:
    """The case's step in this process, without a mesh: the port's
    reference for the multi-rank runs of it."""
    return step_cases(0, [dict(case, mesh="none")])[0]


def by_name(tree, **arch) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree), **{**TINY, **arch}).items()}


def param_atol(steps=1) -> float:
    """A weight's gap after ``steps`` Adam updates inside the band: 2 lr a
    step (a sign flip), and the float32 rounding of the two sides' p +- lr."""
    return 2 * LR * steps + 1e-7


def loss_rtol(steps=1) -> float:
    """The loss of update ``steps``: 1e-5 for the first; after an update
    the weights differ by Adam's sign flips, and the loss within 1e-4
    (``test_torch_train_step``'s tolerance over several steps)."""
    return LOSS_RTOL if steps == 1 else 1e-4


def assert_weights_match(label, ours, ref, grads, steps=1, band_tol=JAX_GRAD_TOL):
    """Weights (or EMA) after ``steps`` Adam updates against the
    reference's, split by the first update's gradient ``grads``: within
    ``CLEAR_ATOL[steps]`` where it is clear of zero, and within
    ``param_atol(steps)`` in its band, where it is within ``band_tol`` of
    its scale (``gradient_scale``: an attention's key bias, whose gradient
    is rounding, lies in it whole). Adam's first step moves a weight by ~lr
    * sign(g), so a gradient in the band may take the other sign."""
    for name, value in ours.items():
        g = np.abs(grads[name])
        band = g <= band_tol * gradient_scale(grads, name)
        gap = np.abs(value - ref[name])
        if (~band).any():
            assert gap[~band].max() <= CLEAR_ATOL[steps], \
                f"{label} {name}: {gap[~band].max():.3e} clear of the band"
        if band.any():
            assert gap[band].max() <= param_atol(steps), \
                f"{label} {name}: {gap[band].max():.3e} in the band"


def assert_update_matches(res, jax_state, ref_loss, steps=1):
    """Loss, weights and EMA after the update(s) against the JAX state's."""
    assert abs(res["loss"] - ref_loss) <= loss_rtol(steps) * abs(ref_loss)
    for label, ours, ref in (("params", res["params"], by_name(jax_state.variables["params"])),
                             ("ema", res["ema"], by_name(jax_state.ema_params))):
        assert_weights_match(label, ours, ref, res["grads"], steps)


@pytest.fixture(scope="module")
def tp_setup(tmp_path_factory):
    """The tensor-parallel cases' inputs, and each mesh's ranks run once (in
    threads, beside the references: the JAX package's gradients and its step
    over each mesh, and the port's one-process step)."""
    jax_model, params, _ = make_models("true", "sebridge_v3")
    batch = spec_batch(30, BATCH)
    key = jax.random.PRNGKey(40)
    draws = chained_draws(jax_model, key, (jnp.asarray(batch[0]),), 1, 1)
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    case = {"model": tiny_spec(params), "batch": batch, "draws": draws, "accum": 1, "chain": 1}
    meshes = {"tp12": (2, {"mesh": "tp12", "ckpt": ckpt}, (1, 2)), "tp22": (4, {"mesh": "tp22"},
                                                                           (2, 2))}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = {kind: pool.submit(dryrun.launch, step_cases, n, ([dict(case, **extra)],),
                                      device="cpu", timeout=TIMEOUT)
                    for kind, (n, extra, _) in meshes.items()}
        grads = jax_grads(jax_model, params, batch, key)
        steps = {kind: jax_step(jax_model, {"params": params}, batch, key,
                                mesh=jax_make_2d_mesh(*shape), tp=True)
                 for kind, (_, _, shape) in meshes.items()}
        one = one_process(case)
        results = {kind: [cases[0] for cases in f.result()] for kind, f in launched.items()}
    return {"jax_model": jax_model, "params": params, "batch": batch, "key": key,
            "results": results, "ckpt": ckpt, "case": case, "jax_steps": steps,
            "jax_grads": grads, "one_process": one}


@pytest.mark.parametrize("mesh_kind,shape", [("tp12", (1, 2)), ("tp22", (2, 2))])
def test_tensor_parallel_step_matches_jax(tp_setup, mesh_kind, shape):
    s = tp_setup
    jmesh = jax_make_2d_mesh(*shape)
    jax_state, metrics = s["jax_steps"][mesh_kind]
    ref_loss, ref_grads = s["jax_grads"]
    assert float(metrics["train_loss"]) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    ref = s["one_process"]
    ranks = s["results"][mesh_kind]
    # the JAX shard shape of every leaf, through the bridge
    shard_shapes = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        _jax_shard_shapes(jmesh, jax.tree_util.tree_map(np.asarray, s["params"])),
        **TINY).items()}
    for res in ranks:
        assert res["step"] == 1 and res["rows"] == BATCH // shape[0]
        assert_grads_close(res["grads"], ref["grads"], PARALLEL_GRAD_TOL)
        assert_grads_close(res["grads"], ref_grads, JAX_GRAD_TOL)
        assert_update_matches(res, jax_state, float(metrics["train_loss"]))
        for name, local in res["local"].items():
            assert local == shard_shapes[name] == res["ema_local"][name] == \
                res["moments_local"][name], name
        assert any(local != res["params"][n].shape for n, local in res["local"].items())
    # every rank holds the same whole weights after the all-gather
    for res in ranks[1:]:
        for name, value in res["params"].items():
            np.testing.assert_array_equal(value, ranks[0]["params"][name], err_msg=name)


def test_checkpoint_saved_under_tensor_parallelism_restores_on_one_rank(tp_setup):
    """Rank 0 wrote whole tensors under ``(1, 2)``: one process restores
    them, and its weights, EMA and moments are the 2-rank state's whole."""
    s = tp_setup
    res = s["results"]["tp12"][0]
    port = make_models("true", "sebridge_v3")[2]
    state = TrainState(port.backbone, lr=LR)
    CheckpointManager(s["ckpt"]).restore(state)
    assert state.step == 1
    for name, p in zip(state.names, state.params):
        np.testing.assert_array_equal(p.detach().numpy(), res["params"][name], err_msg=name)
    for name, e in zip(state.names, state.ema):
        np.testing.assert_array_equal(e.numpy(), res["ema"][name], err_msg=name)
    moments = [st["exp_avg"] for st in state.optimizer.state.values()]
    assert [tuple(m.shape) for m in moments] == [tuple(p.shape) for p in state.params]
    # and a one-process update from it runs
    state.apply_gradients([torch.ones_like(p) for p in state.params])
    assert state.step == 2


# ---------------------------------------------------- batch_enhance(mesh=)


def test_batch_enhance_over_a_mesh_matches_no_mesh():
    """Two ranks split each bucket batch that divides (the 2-row batches;
    the tail of one row runs whole on both) and every rank returns the
    whole list, in order, within 1e-5 of the one-process call."""
    from diffse_tpu_torch.evaluation.batch_eval import batch_enhance
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from test_torch_enhance import ARCH

    config = dict(backbone="ncsnpp", sde="bbed", model_type="sebridge_v2",
                  snr_conditioned="false", sigma_max=1.0)
    model = ScoreModel(ScoreModelConfig(**config), backbone_kwargs=ARCH, sde_kwargs=SDE_KWARGS,
                       device="cpu", generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(5)
    # buckets of 64 frames ([0, 1, 4]: a batch of 2 and a tail of 1) and 128 ([2, 3])
    lengths = [5000, 7000, 9000, 12000, 6000]
    y = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]
    x = [yy * 0.8 for yy in y]
    spec = {"model": {"config": config, "backbone": ARCH, "sde": SDE_KWARGS,
                      "weights": model.backbone.state_dict()},
            "x": x, "y": y, "branch": "sebridge_v2", "seed": 3, "batch_size": 2, "est": None}
    ranks = dryrun.launch(enhance, 2, (spec,), device="cpu", timeout=TIMEOUT)
    ref = batch_enhance(model, x, y, "sebridge_v2", seed=3, batch_size=2)
    for out in ranks:
        assert len(out) == len(ref)
        for a, b, n in zip(out, ref, lengths):
            assert a.shape == (n,)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_launch_runs_on_the_cards_unless_asked_for_the_cpu(monkeypatch):
    """``launch`` and the dry run default to the cards: NCCL when each rank
    has a card, gloo for more ranks than cards or on the CPU; without a
    card a launch that did not ask for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [dryrun.launch_backend("cuda", n) for n in (1, 2, 3)] == ["nccl", "nccl", "gloo"]
    assert dryrun.launch_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.launch(collectives, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["2"])


def test_dryrun_multichip_four_ranks(capsys):
    msg = dryrun.dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    assert msg.startswith("dryrun_multichip(4): ok, train_loss=") and "dp2xtp2" in msg
    assert msg in capsys.readouterr().out


def test_training_clis_on_two_ranks(tmp_path):
    """``cli.train --tp_size 2 --chain_steps 2`` on 2 ranks: a (1, 2) mesh,
    one chained call of 2 updates an epoch, rank 0's checkpoint whole;
    ``cli.train_snr_est`` data-parallel; ``--no_mesh`` under 2 ranks a
    parser error (exit code 2) on each."""
    from diffse_tpu_torch.data.synthetic import make_synthetic_dataset
    from diffse_tpu_torch.train.restore import load_score_model

    data = make_synthetic_dataset(str(tmp_path / "data"), num_train=4, num_valid=2,
                                  num_valid2=1, num_test=1, duration_s=0.7)
    common = ["--batch_size", "2", "--num_frames", "32", "--num_workers", "1", "--seed", "0",
              "--device", "cpu", "--base_dir", data, "--max_epochs", "1"]
    score = ["--backbone", "ncsnpp", "--sde", "bbed", "--modeltype", "sebridge_v3",
             "--snr_conditioned", "true", "--fixed_snr", "0.17783", "--num_eval_files", "0",
             "--nf", "4", "--ch_mult", "1", "1", "--attn_resolutions", "8",
             "--image_size", "256", *common]
    ckpt = str(tmp_path / "score")
    train_argv = [*score, "--tp_size", "2", "--chain_steps", "2", "--ckpt_dir", ckpt]
    snr_argv = ["--transform_type", "none", *common, "--ckpt_dir", str(tmp_path / "snr")]
    r0, r1 = dryrun.launch(clis, 2, (train_argv, snr_argv, [*score, "--no_mesh", "--nolog"]),
                           device="cpu", timeout=TIMEOUT)
    for r in (r0, r1):
        assert (r["step"], r["tp"], r["snr_step"], r["snr_mesh"], r["no_mesh"]) == \
            (2, 2, 2, True, 2)
    for name, value in r0["params"].items():
        np.testing.assert_array_equal(value, r1["params"][name], err_msg=name)
    _, state = load_score_model(ckpt, device="cpu")
    assert state.step == 2
    for name, p in zip(state.names, state.params):
        np.testing.assert_array_equal(p.detach().numpy(), r0["params"][name], err_msg=name)


# ---------------------------------------------------- data-parallel training

STATS_TOL = 2e-6
DCUNET_F32_GRAD_TOL = 1e-2
F64_GRAD_TOL = 1e-9
DCUNET = dict(dcunet_architecture="DilDCUNet-v2")
DCUNET_STFT = dict(n_fft=256, hop_length=64, num_frames=16)  # 129 bins: DilDCUNet-v2's least


def _stack(batches):
    return tuple(np.stack([b[i] for b in batches]) for i in range(len(batches[0])))


@pytest.fixture(scope="module")
def cases():
    """Every 2-rank case's inputs, and the ranks run once over all of them
    (and DCUNet's in float64), in threads beside the JAX package's mesh step
    of each case, taken meanwhile."""
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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(dryrun.launch, step_cases, 2,
                            ([dict(out[n], mesh="dp") for n in names],), device="cpu",
                            timeout=TIMEOUT)
        ranks64 = pool.submit(dryrun.launch, loss_grads, 2, (out["dcunet"], torch.float64),
                              device="cpu", timeout=TIMEOUT)
        mesh = jax_make_mesh(jax.devices()[:2])
        jax_steps = {n: jax_step(dc_model if n == "dcunet" else jax_model,
                                 variables if n == "dcunet" else {"params": params},
                                 out[n]["batch"], key, mesh=mesh, accum=out[n]["accum"],
                                 chain=out[n]["chain"]) for n in names}
        ranks, ranks64 = ranks.result(), ranks64.result()
    results = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return {"jax_model": jax_model, "params": params, "key": key, "inputs": out,
            "results": results, "jax_steps": jax_steps, "ranks64": ranks64,
            "dc_model": dc_model, "dc_variables": variables}


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
    assert case["accum"] == accum
    jax_state, metrics = cases["jax_steps"][name]
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
    jax_state, metrics = cases["jax_steps"]["dcunet"]
    _check_against_one_process(results, case, grad_tol=None)
    exact = loss_grads(None, case, torch.float64)
    for grads64 in cases["ranks64"]:
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
    assert (case["accum"], case["chain"]) == (2, 2)
    jax_state, metrics = cases["jax_steps"]["dp_chain_accum"]
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
