#!/usr/bin/env python3
"""Export, save and load times of a ``bbed_pc`` artifact at a given N, on one GPU.

    python3 tools/artifact_times.py [--N 30] [--seconds 1.0] [--reps 5] [--out DIR]

Builds the 65.6M bbed model of ``diffse_tpu_torch`` (every weight redrawn
from seed 4, as chip_smoke's export phase does), exports its ``bbed_pc``
enhance program (N reverse steps unrolled, 2N forwards) for one width
bucket with ``serving.export.save_artifact`` and loads it with
``load_artifact`` (which captures the program as a CUDA graph), then
prints, beside the card's name and power limit:

  - the export (trace) and save seconds, the load seconds (deserialisation,
    the warm-up and the capture), the program's graph nodes and its file's
    size, the weights' file's size;
  - the kernels' launches recorded inside the program, per forward;
  - the wall per utterance of the artifact and of ``ScoreModel.enhance``'s
    captured program on the same seed (median of ``--reps`` calls after one
    warm-up call each), and whether their outputs are bitwise equal.

The last line is one JSON object of these numbers. The artifact is written
under ``--out`` (default a temporary directory, removed after).
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--N", type=int, default=30)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    model = ScoreModel(ScoreModelConfig(backbone="ncsnpp", sde="bbed", model_type="bbed",
                                        snr_conditioned="false", sigma_max=0.5),
                       sde_kwargs=dict(T_sampling=0.999, k=2.6, theta=0.52, N=30), device=dev,
                       generator=torch.Generator().manual_seed(0))
    redraw(model.backbone, seed=4)
    rng = np.random.default_rng(3)
    n = int(args.seconds * 16000)
    y = (0.1 * rng.standard_normal(n)).astype(np.float32)

    root = args.out or tempfile.mkdtemp(prefix="diffse_artifact_times_")
    try:
        meta = save_artifact(root, model, None, "bbed_pc", n, n_steps=args.N)
        (bucket_meta,) = meta["buckets"]
        program_mb = os.path.getsize(os.path.join(root, bucket_meta["file"])) / 1e6
        weights_mb = os.path.getsize(os.path.join(root, "weights.pt")) / 1e6
        enhance, meta = load_artifact(root)
        (bucket,) = enhance.buckets
        nodes = len(bucket.module.graph.nodes)
        launches = {k: v / meta["nfe"] for k, v in bucket.program.launch_counts.items()}

        def artifact_call():
            return enhance(y, seed=5)

        def enhance_call():
            return model.enhance(y[None], y[None], generator=torch.Generator(dev).manual_seed(5),
                                 N=args.N)

        art_wall = median_wall(artifact_call, args.reps)
        enhance_wall = median_wall(enhance_call, args.reps)
        equal = bool(np.array_equal(artifact_call(), enhance_call()))
    finally:
        if args.out is None:
            shutil.rmtree(root, ignore_errors=True)
    result = {"card": card, "branch": "bbed_pc", "N": args.N, "nfe": meta["nfe"],
              "frames": bucket_meta["t_pad_frames"],
              "export_s": meta["seconds"][0]["export"], "save_s": meta["seconds"][0]["save"],
              "load_s": meta["load_seconds"], "capture_s": bucket.program.capture_seconds,
              "graph_nodes": nodes, "program_mb": program_mb, "weights_mb": weights_mb,
              "launches_per_forward": launches, "artifact_wall_s": art_wall,
              "enhance_replay_wall_s": enhance_wall, "bitwise_equal": equal}
    print(f"{card}: bbed_pc artifact, N = {args.N} ({meta['nfe']} forwards), "
          f"{bucket_meta['t_pad_frames']} frames: export {result['export_s']:.1f} s, save "
          f"{result['save_s']:.1f} s, load {result['load_s']:.1f} s (capture "
          f"{result['capture_s']:.2f} s), {nodes} graph nodes, program {program_mb:.1f} MB, "
          f"weights {weights_mb:.1f} MB; launches per forward {launches}; wall per utterance "
          f"artifact {art_wall:.4f} s, enhance (replay) {enhance_wall:.4f} s; bitwise equal "
          f"{equal}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
