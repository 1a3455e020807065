#!/usr/bin/env python3
"""How far apart two float32 computations of the paper model's training
gradients lie: the floor under chip_smoke's kernel-path-vs-plain-path check.

    python3 tools/train_grad_floor.py [--cpu] [--seeds 17 23]

The paper's 65.6M model (sebridge_v3, SNR-conditioned) with the weights,
batch (4 x 256 frames) and draws of chip_smoke's phase 9 (its
``check_train_model``), for each draw seed: loss and gradients through the
kernel path on the card, the plain path on the card (cuDNN), the plain path
on the card with cuDNN off, and with ``--cpu`` the plain path on the CPU
(~75 s a run on an 8-core host); then for each pair the loss's relative gap
and the gradients' gaps, each over the gradient's largest magnitude
(``chip_smoke.gradient_scale``): worst, median, share above 1e-4 and the
five worst parameters. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig  # noqa: E402
from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from diffse_tpu_torch.utils import float32_precision  # noqa: E402


def loss_and_grads(model, batch, draws, plain, cudnn=True):
    model.backbone.zero_grad(set_to_none=True)
    t0 = time.time()
    with (cs.plain_versions(ck) if plain else torch.enable_grad()), \
            torch.backends.cudnn.flags(enabled=cudnn), float32_precision(batch[0].device):
        loss = model.loss_from_draws(batch, draws)
        loss.backward()
    grads = {n: p.grad.detach().cpu().clone() for n, p in model.backbone.named_parameters()
             if p.requires_grad}
    return loss.item(), grads, time.time() - t0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="also the plain path on the CPU")
    parser.add_argument("--seeds", type=int, nargs="+", default=[17, 23])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_grad_floor: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.build_library()
    cfg = ScoreModelConfig(**cs.PAPER_CONFIG)
    model = ScoreModel(cfg, sde_kwargs=cs.PAPER_SDE_KWARGS, device=dev,
                       generator=torch.Generator().manual_seed(0))
    cs.redraw_weights(torch, model.backbone, seed=cs.TRAIN_WEIGHT_SEED)
    cpu = None
    if args.cpu:
        cpu = ScoreModel(cfg, sde_kwargs=cs.PAPER_SDE_KWARGS, device="cpu")
        cpu.backbone.load_state_dict(model.backbone.state_dict())
    batch = model.prepare_batch(cs.train_wavs(16))
    for seed in args.seeds:
        draws = model.draw_loss_noise(batch[0], torch.Generator(dev).manual_seed(seed))
        runs = {"kernel (card)": loss_and_grads(model, batch, draws, plain=False),
                "plain (card)": loss_and_grads(model, batch, draws, plain=True),
                "plain, cuDNN off (card)": loss_and_grads(model, batch, draws, plain=True,
                                                          cudnn=False)}
        if cpu is not None:
            runs["plain (CPU)"] = loss_and_grads(
                cpu, tuple(b.cpu() for b in batch[:2]), {k: v.cpu() for k, v in draws.items()},
                plain=True)
        print(f"draws {seed}: " + ", ".join(f"{k} {v[2]:.1f} s" for k, v in runs.items()))
        ref_loss, ref_grads, _ = runs["plain (card)"]
        for name, (loss, grads, _) in runs.items():
            if name == "plain (card)":
                continue
            gaps = {n: ((grads[n] - ref_grads[n]).abs().max() / cs.gradient_scale(ref_grads, n)
                        ).item() for n in ref_grads}
            top = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
            values = np.array(list(gaps.values()))
            print(f"  {name} vs plain (card): loss {loss:.9g} vs {ref_loss:.9g}, relative "
                  f"{abs(loss - ref_loss) / abs(ref_loss):.3e}; gradients worst {top[0][1]:.3e}, "
                  f"median {np.median(values):.3e}, above 1e-4 {(values > 1e-4).sum()} of "
                  f"{len(values)}; worst five {[(n, f'{v:.2e}') for n, v in top]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
