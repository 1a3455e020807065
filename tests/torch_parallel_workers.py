"""Rank functions of the port's multi-rank CPU tests
(``tests/test_torch_parallel.py``), run by
``diffse_tpu_torch.parallel.dryrun.launch`` in spawned gloo ranks. Spawned
ranks import this module by name, so it imports nothing of JAX."""

import json
import os
import signal
import time

import numpy as np
import torch

from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
from diffse_tpu_torch.parallel import make_2d_mesh, make_mesh, replicate, shard_batch
from diffse_tpu_torch.parallel.mesh import (Collectives, batch_mean, batch_shard, rank_device,
                                            world_rank)
from diffse_tpu_torch.train import CheckpointManager, TrainState, make_train_step

MESHES = {"dp": None, "tp12": (1, 2), "tp22": (2, 2)}


def mesh_of(kind):
    """A mesh over the group's ranks: "dp" 1-D, "tp12" / "tp22" (data,
    model); "none": no mesh (one process)."""
    if kind == "none":
        return None
    if MESHES[kind] is None:
        return make_mesh("cpu")
    return make_2d_mesh(*MESHES[kind], "cpu")


def port_model(spec) -> ScoreModel:
    """``spec``: "config", "backbone", "sde" and "weights" (a state_dict)."""
    model = ScoreModel(ScoreModelConfig(**spec["config"]), backbone_kwargs=spec["backbone"],
                       sde_kwargs=spec["sde"], device="cpu")
    model.backbone.load_state_dict(spec["weights"], strict=True)
    return model


def step_cases(rank, cases):
    """Each case: one call of the train step over a mesh, from the case's
    model ("model", as ``port_model``), on this rank's rows of its global
    batch ("batch", with the leading chain / accum axes), with the given
    global draws ("draws", one per loss call, in order). Returns per case the
    loss, the first update's reduced gradients, the weights, EMA and buffers
    after, whole, and this rank's local shapes; with "ckpt", a checkpoint of
    the state saved there as step 0."""
    out = []
    for case in cases:
        model = port_model(case["model"])
        draws = iter(case["draws"])
        model.draw_loss_noise = lambda like, generator: next(draws)
        mesh = mesh_of(case["mesh"])
        state = TrainState(model.backbone, lr=case["model"]["lr"], mesh=mesh)
        state.keep_gradients = True
        step = make_train_step(model, accum_steps=case["accum"], chain_steps=case["chain"],
                               mesh=mesh)
        lead = int(case["chain"] > 1) + int(case["accum"] > 1)
        batch = shard_batch(mesh, tuple(torch.from_numpy(a) for a in case["batch"]), lead)
        # the first update's gradients, before a chained second replaces them
        first = []
        apply = state.apply_gradients

        def keep_first(*args, **kwargs):
            apply(*args, **kwargs)
            if not first:
                first.append(list(state.last_grads))
        state.apply_gradients = keep_first
        state, metrics = step(state, batch, None)
        grads = [state.layout.whole(i, g) if state.layout else g for i, g in enumerate(first[0])]
        res = {"loss": float(metrics["train_loss"]),
               "loss_mean": float(metrics.get("train_loss_mean", float("nan"))),
               "step": state.step, "rows": int(batch[0].shape[lead]),
               "grads": {n: g.numpy().copy() for n, g in zip(state.names, grads)},
               "params": {n: p.detach().numpy().copy() for n, p in
                          zip(state.names, state.params)},
               "ema": {n: e.numpy().copy() for n, e in zip(state.names, state.whole_ema())},
               "buffers": {n: b.numpy().copy() for n, b in model.backbone.named_buffers()},
               "local": {n: tuple(t.shape) for n, t in zip(state.names, state.local)},
               "ema_local": {n: tuple(e.shape) for n, e in zip(state.names, state.ema)},
               "moments_local": {state.names[i]: tuple(st["exp_avg"].shape)
                                 for i, st in enumerate(state.optimizer.state.values())}}
        if case.get("ckpt"):
            CheckpointManager(case["ckpt"]).save(0, state, {})
        out.append(res)
    return out


def loss_grads(rank, case, dtype):
    """The gradients of the case's first loss (its model, whole global batch
    and first draws) on this rank's rows inside ``batch_shard`` over a data
    mesh of the group's ranks ("none": the whole batch in this process), in
    ``dtype`` (float64 for an exact reference), averaged over the ranks."""
    model = port_model(case["model"])
    complex_dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    model.backbone.to(dtype).train()
    draws = {k: v.to(complex_dtype) if v.is_complex() else v.to(dtype)
             for k, v in case["draws"][0].items()}
    batch = tuple(torch.from_numpy(a).to(complex_dtype) for a in case["batch"])
    mesh = None if rank is None else make_mesh("cpu")
    with batch_shard(mesh) as shard:
        if shard is not None:
            batch = tuple(shard.rows(t) for t in batch)
            draws = {k: shard.rows(v) for k, v in draws.items()}
        model.loss_from_draws(batch, draws).backward()
    named = [(n, p.grad) for n, p in model.backbone.named_parameters() if p.requires_grad]
    if mesh is not None:
        Collectives().mean_([g for _, g in named])
    return {n: g.numpy().copy() for n, g in named}


def collectives(rank):
    """The mesh helpers on 2 ranks: placements, shard_batch, replicate, the
    collectives, the global batch mean and its gradient."""
    from diffse_tpu_torch.parallel import batch_sharding, stacked_batch_sharding
    from diffse_tpu_torch.train.loop import _maybe_mesh

    mesh = make_mesh("cpu")
    out = {"placements": [repr(batch_sharding(mesh)), repr(stacked_batch_sharding(mesh, 2))]}
    batch = (np.arange(24.0).reshape(2, 4, 3), torch.arange(8.0))
    rows = shard_batch(mesh, batch[:1], lead_axes=1), shard_batch(mesh, batch[1:])
    out["rows"] = [rows[0][0].tolist(), rows[1][0].tolist()]
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    replicate(mesh, module)
    out["replicated"] = module.weight.flatten().tolist()
    coll = Collectives()
    t = torch.arange(4.0) + 10 * rank
    out["mean"] = coll.mean(t).tolist()
    out["gather"] = coll.all_gather(t[:2]).tolist()
    out["reduce_scatter"] = coll.reduce_scatter(t.clone()).tolist()
    out["any"] = [coll.any(rank == 1), coll.any(False)]
    # the global batch mean: value and gradient as one process over both rows
    x = torch.tensor([[1.0 + rank, 2.0 * rank]], requires_grad=True)
    with batch_shard(mesh):
        m = batch_mean(x * x, (0, 1))
    m.backward()
    out["batch_mean"] = [float(m.detach()), x.grad.tolist()]
    out["maybe_mesh"] = [_maybe_mesh(False, 8) is None, _maybe_mesh(True, 3) is None,
                         tuple(_maybe_mesh(True, 4, device_type="cpu").mesh.shape),
                         _maybe_mesh(True, 4, tp_size=3) is None,
                         tuple(_maybe_mesh(True, 4, tp_size=2, device_type="cpu").mesh.shape)]
    return out


def enhance(rank, spec):
    """``batch_enhance`` over a 2-rank data mesh; every rank's whole list."""
    from diffse_tpu_torch.evaluation.batch_eval import batch_enhance

    model = port_model(spec["model"])
    return batch_enhance(model, spec["x"], spec["y"], spec["branch"], seed=spec["seed"],
                         batch_size=spec["batch_size"], est_snrs=spec["est"],
                         mesh=make_mesh("cpu"))


class ProgressLogger:
    """A metrics logger that appends each record's step to a file and waits
    ``pause`` seconds (so that a signal can land mid-run)."""

    def __init__(self, path, pause):
        self.path, self.pause = path, pause

    def log(self, metrics, step=None):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")
        time.sleep(self.pause)

    def log_artifact(self, path, name):
        pass


class OneBatchData:
    """One batch of two random waveform pairs of the tiny STFT's 16 frames
    an epoch (the same every epoch), no validation batches: an epoch is one
    step."""

    class cfg:
        batch_size = 2

    def setup(self, stage):
        pass

    def train_dataloader(self):
        rng = np.random.default_rng(0)
        n = 15 * 8  # (num_frames - 1) * hop_length
        x = rng.standard_normal((2, n)).astype(np.float32)
        yield x, (x + 0.3 * rng.standard_normal((2, n))).astype(np.float32)

    def val_dataloader(self):
        return []


def train(rank, spec):
    """``train_score_model`` on the synthetic data module of the spec, over
    a data mesh of the group's ranks; returns the step, the preemption flag
    (whether it stopped early) and the final weights' sums."""
    from diffse_tpu_torch.train.loop import train_score_model

    model = port_model(spec["model"])
    logger = ProgressLogger(spec["progress"], spec["pause"]) if spec.get("progress") else None
    state = train_score_model(model, spec["data"](), max_epochs=spec["epochs"],
                              ckpt_dir=spec["ckpt"], logger=logger, seed=0, resume=spec["resume"],
                              log_every_n_steps=1)
    return {"step": state.step, "rank": world_rank(),
            "params": {n: p.detach().numpy().copy() for n, p in
                       zip(state.names, state.params)}}


def signal_rank_after(procs, rank, progress, lines, timeout=120):
    """``launch``'s ``on_start``: SIGTERM to ``procs[rank]`` once the
    progress file has ``lines`` lines."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(progress) and len(open(progress).readlines()) >= lines:
            break
        if any(not p.is_alive() for p in procs):
            return
        time.sleep(0.05)
    os.kill(procs[rank].pid, signal.SIGTERM)


def clis(rank, train_argv, snr_argv, no_mesh_argv):
    """The training CLIs under 2 ranks: ``cli.train`` (tensor parallel,
    chained), ``cli.train_snr_est``, and ``cli.train --no_mesh`` (a parser
    error under several ranks)."""
    from diffse_tpu_torch.cli import train as train_cli
    from diffse_tpu_torch.cli import train_snr_est

    rank_device("cpu")
    state = train_cli.main(train_argv)
    snr_state = train_snr_est.main(snr_argv)
    try:
        train_cli.main(no_mesh_argv)
        refused = None
    except SystemExit as e:
        refused = e.code
    return {"step": state.step, "tp": state.layout.n_model, "snr_step": snr_state.step,
            "snr_mesh": snr_state.mesh is not None, "no_mesh": refused,
            "params": {n: p.detach().numpy().copy() for n, p in zip(state.names, state.params)}}
