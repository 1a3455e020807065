"""Spawn ranks and run a function on each (``launch``), and the multi-rank dry
run (port of ``__graft_entry__.dryrun_multichip``): one data-parallel train
step of a small SNR-conditioned NCSN++ on a 1-D mesh of ``n`` ranks, then,
for an even ``n``, one tensor-parallel step on an ``(n / 2, 2)`` mesh.

    python -m diffse_tpu_torch.parallel.dryrun 2                 # the cards
    python -m diffse_tpu_torch.parallel.dryrun 4 --device cpu    # CPU, gloo

Every rank runs in a process of its own, spawned (not forked: a forked CUDA
context is unusable), joined to a process group on a free localhost port.
A rank that fails or outlives ``timeout`` fails the launch: the others are
killed, and nothing falls back to fewer ranks. Ranks that use the CUDA
kernels load the library that the parent built (``build_library`` first).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp

from .mesh import default_backend, free_port, initialize_distributed

TINY_BACKBONE = dict(nf=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                     image_size=16)
TINY_CONFIG = dict(backbone="ncsnpp", sde="bbed", model_type="sebridge_v3",
                   snr_conditioned="true", fixed_snr=0.17783, sigma_max=1.0, num_frames=16)
TINY_SDE = dict(T_sampling=0.999, k=2.6, theta=0.52, N=30)


def _rank_main(rank: int, world: int, port: int, backend: str, device: str, threads: int,
               out_dir: str, fn: Callable, args: tuple) -> None:
    try:
        torch.set_num_threads(threads)
        if torch.device(device).type == "cuda":
            # "cuda" without an index: the ranks round-robin over the cards
            index = torch.device(device).index
            torch.cuda.set_device(rank % torch.cuda.device_count() if index is None else index)
        initialize_distributed(device=device, backend=backend,
                               init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                               rank=rank)
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def launch_backend(device: str, world: int) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU and for more
    ranks than cards (NCCL refuses two ranks on one card)."""
    backend = default_backend(device)
    if backend == "nccl" and world > torch.cuda.device_count():
        return "gloo"
    return backend


def launch(fn: Callable, world: int, args: Sequence = (), device: str = "cuda",
           backend: Optional[str] = None, timeout: float = 600.0, threads: int = 1,
           on_start: Optional[Callable[[List[Any]], None]] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks of one process
    group (``backend``, unless given: ``launch_backend``) on ``device`` (the
    cards, rank ``r`` on card ``r`` modulo their count, unless the caller
    asks for the CPU) and return each rank's result (``torch.save``-able),
    in rank order. ``fn`` must be importable by name.
    ``on_start(processes)`` runs once all are started (to signal one, say).
    Raises, after killing the others, when a rank fails or the launch
    outlives ``timeout`` seconds."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        from ..ops.cuda_kernels import build_library

        build_library()  # here once, so that the ranks load it and none runs nvcc
    backend = backend or launch_backend(device, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="diffse_ranks_") as out_dir:
        port = free_port()
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, world, port, backend, device, threads, out_dir, fn,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            if on_start is not None:
                on_start(procs)
            deadline = time.monotonic() + timeout
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if not p.is_alive() and p.exitcode != 0]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if not p.is_alive() and p.exitcode != 0]
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(30)
        if failed or alive:
            errors = []
            for r in failed or alive:
                path = os.path.join(out_dir, f"rank{r}.err")
                errors.append(f"rank {r}: " + (open(path).read() if os.path.exists(path)
                                               else f"exit code {procs[r].exitcode}"))
            what = "failed" if failed else f"outlived {timeout} s"
            raise RuntimeError(f"launch of {world} ranks {what}:\n" + "\n".join(errors))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def tiny_batch(b: int, seed: int = 0):
    """``b`` complex (clean, noisy) spectrogram pairs of 16 x 16, as the JAX
    dry run draws them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 1, 16, 16))
         + 1j * rng.standard_normal((b, 1, 16, 16))).astype(np.complex64)
    y = x + 0.3 * (rng.standard_normal((b, 1, 16, 16))
                   + 1j * rng.standard_normal((b, 1, 16, 16))).astype(np.complex64)
    return torch.from_numpy(x), torch.from_numpy(y)


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the dry run: a data-parallel step, then a ``(world / 2,
    2)`` tensor-parallel step from the same weights, on the same global
    batch; returns the losses and the step counts."""
    from ..models.score_model import ScoreModel, ScoreModelConfig
    from ..train import TrainState, make_train_step
    from .mesh import make_mesh, replicate, shard_batch
    from .model_sharding import make_2d_mesh

    def model():
        m = ScoreModel(ScoreModelConfig(**TINY_CONFIG), backbone_kwargs=TINY_BACKBONE,
                       sde_kwargs=TINY_SDE, device=device,
                       generator=torch.Generator().manual_seed(0))
        return m

    batch = tiny_batch(2 * world)
    out = {}
    meshes = [("dp", lambda: make_mesh(torch.device(device).type))]
    if world % 2 == 0:
        meshes.append(("tp", lambda: make_2d_mesh(world // 2, 2, torch.device(device).type)))
    for label, make in meshes:
        m = model()
        mesh = make()
        replicate(mesh, m.backbone)
        state = TrainState(m.backbone, lr=m.cfg.lr, ema_decay=m.cfg.ema_decay, mesh=mesh)
        step = make_train_step(m, mesh=mesh)
        rows = shard_batch(mesh, tuple(t.to(m.device) for t in batch))
        state, metrics = step(state, rows, torch.Generator(m.device).manual_seed(1))
        loss = float(metrics["train_loss"])
        if not np.isfinite(loss) or state.step != 1:
            raise AssertionError(f"{label}: loss {loss}, step {state.step}")
        out[label] = loss
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: Optional[str] = None,
                     timeout: float = 600.0) -> str:
    """Spawn ``n_devices`` ranks (``launch``: on the cards unless ``device``
    is the CPU) and run one data-parallel train step on a 1-D mesh and, for
    an even count, one tensor-parallel step on an ``(n / 2, 2)`` mesh;
    prints and returns ``"dryrun_multichip(n): ok, train_loss=..."``.
    Raises when a rank fails."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    results = launch(_dryrun_rank, n_devices, (n_devices, device), device=device,
                     backend=backend, timeout=timeout)
    losses = results[0]
    if any(r != losses for r in results[1:]):
        raise AssertionError(f"the ranks disagree: {results}")
    msg = f"dryrun_multichip({n_devices}): ok, train_loss={losses['dp']:.4f}"
    if "tp" in losses:
        msg += f"; dp{n_devices // 2}xtp2 train_loss={losses['tp']:.4f}"
    print(msg)
    return msg


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None,
                        help="NCCL for ranks on cards of their own, else gloo")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
