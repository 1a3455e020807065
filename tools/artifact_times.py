#!/usr/bin/env python3
"""Export, save and load times of a ``bbed_pc`` artifact at a given N, on one GPU.

    python3 tools/artifact_times.py [--N 30] [--seconds 1.0] [--reps 5]
        [--dtypes float32 bf16] [--out DIR]

For each trunk dtype, builds the 65.6M bbed model of ``diffse_tpu_torch``
(every weight redrawn from seed 4, as chip_smoke's export phase does),
exports its ``bbed_pc`` enhance programs (start, one PC step, finish: 2
forwards traced whatever N) for one width bucket with
``serving.export.save_artifact`` and loads them with ``load_artifact``
(which captures start, N replays of the step and finish as one CUDA graph),
then prints, beside the card's name and power limit:

  - the export (trace) and save seconds, the load seconds (deserialisation,
    the warm-up and the capture) and the capture's, the programs' graph
    nodes, the size on disk of the programs, the weights and (bf16) the
    prepared casts and packed weights;
  - the kernels' launches recorded inside the captured program, per
    forward, and the weight casts it recorded (none);
  - the wall per utterance of the artifact and of ``ScoreModel.enhance``'s
    captured program on the same seed (median of ``--reps`` calls after one
    warm-up call each), and whether their outputs are bitwise equal.

The last line is one JSON object of these numbers (one entry per dtype).
The artifacts are written under ``--out`` (default a temporary directory,
removed after).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig  # noqa: E402
from diffse_tpu_torch.serving.export import load_artifact, save_artifact  # noqa: E402


def redraw(model, seed):
    """Every trained weight from a seeded generator at a non-zero scale."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            z = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                p.copy_(z / (p.shape[0] if name.endswith(".W") else p[0].numel()) ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.1 * z)
            else:
                p.copy_(0.1 * z)


def median_wall(fn, reps):
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def measure(args, dtype, root, card, y):
    """One dtype's artifact: export, save, load, and the walls."""
    dev = torch.device("cuda", 0)
    backbone = {} if dtype == "float32" else {"dtype": dtype}
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                        snr_conditioned="false", sigma_max=0.5),
                       backbone_kwargs=backbone,
                       sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=30), device=dev,
                       generator=torch.Generator().manual_seed(0))
    redraw(model.backbone, seed=4)
    path = os.path.join(root, dtype)
    meta = save_artifact(path, model, None, "bbed_pc", y.shape[0], n_steps=args.N)
    (bucket_meta,) = meta["buckets"]
    sizes = {name: os.path.getsize(os.path.join(path, name)) / 1e6
             for name in sorted(os.listdir(path))}
    enhance, meta = load_artifact(path)
    (bucket,) = enhance.buckets
    nodes = {role: len(module.graph.nodes) for role, (_, module) in bucket.programs.items()}
    launches = {k: v / meta["nfe"] for k, v in bucket.program.launch_counts.items()}

    def artifact_call():
        return enhance(y, seed=5)

    def enhance_call():
        return model.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(5),
                             N=args.N)

    art_wall = median_wall(artifact_call, args.reps)
    enhance_wall = median_wall(enhance_call, args.reps)
    equal = bool(np.array_equal(artifact_call(), enhance_call()))
    result = {"card": card, "branch": "bbed_pc", "dtype": dtype, "N": args.N,
              "nfe": meta["nfe"], "frames": bucket_meta["t_pad_frames"],
              "export_s": meta["seconds"][0]["export"],
              "save_s": meta["seconds"][0]["save"] + meta["weights_save_seconds"],
              "load_s": meta["load_seconds"], "capture_s": bucket.capture_seconds,
              "graph_nodes": nodes, "files_mb": sizes, "launches_per_forward": launches,
              "weight_casts_at_capture": bucket.program.weight_casts,
              "artifact_wall_s": art_wall, "enhance_replay_wall_s": enhance_wall,
              "bitwise_equal": equal}
    print(f"{card}: bbed_pc artifact, {dtype}, N = {args.N} ({meta['nfe']} forwards), "
          f"{bucket_meta['t_pad_frames']} frames: export {result['export_s']:.1f} s, save "
          f"{result['save_s']:.1f} s, load {result['load_s']:.1f} s (capture "
          f"{result['capture_s']:.2f} s), graph nodes {nodes}, files (MB) {sizes}; launches "
          f"per forward {launches}, weight casts at capture {result['weight_casts_at_capture']}"
          f"; wall per utterance artifact {art_wall:.4f} s, enhance (replay) "
          f"{enhance_wall:.4f} s; bitwise equal {equal}")
    del enhance, bucket, model
    torch.cuda.empty_cache()
    return result


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--dtypes", type=str, nargs="+", default=["float32"],
                        choices=["float32", "bf16"])
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    rng = np.random.default_rng(3)
    y = (0.1 * rng.standard_normal(int(args.seconds * 16000))).astype(np.float32)
    root = args.out or tempfile.mkdtemp(prefix="diffse_artifact_times_")
    try:
        results = [measure(args, dtype, root, card, y) for dtype in args.dtypes]
    finally:
        if args.out is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
