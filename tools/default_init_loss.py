#!/usr/bin/env python3
"""The paper model's training loss over its first steps from the default
initialisation, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/default_init_loss.py [--nf 32] [--frames 64] \
        [--batch 2] [--steps 10]

The paper's configuration (chip_smoke's ``PAPER_CONFIG``: sebridge_v3,
SNR-conditioned, fixed_snr 0.17783, ``--sigma-max 1.0``) at the full depth
with ``--nf`` channels, each package from its own seeded default
initialisation (every block's last conv at 1e-10), Adam at lr 1e-4, on one
fixed synthetic batch with the same draws every step (the same key, the
same generator seed); prints each package's losses. Their draws and
initial weights differ, so the two lines are alike in shape, not in value.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def batch(frames: int, b: int):
    import chip_smoke as cs

    rng = np.random.default_rng(18)
    pairs = [cs.synthetic_pair(rng, (frames - 1) * 128) for _ in range(b)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def port_losses(nf, frames, b, steps):
    import torch

    import chip_smoke as cs
    from diffse_tpu_torch.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu_torch.train import TrainState, make_train_step

    model = ScoreModel(ScoreModelConfig(**cs.PAPER_CONFIG), backbone_kwargs=dict(nf=nf),
                       sde_kwargs=cs.PAPER_SDE_KWARGS, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    state = TrainState(model.backbone, lr=model.cfg.lr)
    step = make_train_step(model, preprocess=model.prepare_batch)
    wavs = batch(frames, b)
    out = []
    for _ in range(steps):
        state, metrics = step(state, wavs, torch.Generator().manual_seed(19))
        out.append(metrics["train_loss"].item())
    return out


def jax_losses(nf, frames, b, steps):
    import jax
    import jax.numpy as jnp
    import optax

    import chip_smoke as cs
    from diffse_tpu.models.score_model import ScoreModel, ScoreModelConfig
    from diffse_tpu.train.state import create_train_state
    from diffse_tpu.train.steps import make_train_step

    model = ScoreModel(ScoreModelConfig(**cs.PAPER_CONFIG), backbone_kwargs=dict(nf=nf),
                       sde_kwargs=cs.PAPER_SDE_KWARGS)
    variables = jax.jit(lambda k: model.init_variables(k, num_frames=frames))(
        jax.random.PRNGKey(0))
    opt = optax.adam(model.cfg.lr)
    state = create_train_state(variables, opt)
    step = make_train_step(model, opt, preprocess=model.prepare_batch, donate=False)
    wavs = tuple(jnp.asarray(a) for a in batch(frames, b))
    out = []
    for _ in range(steps):
        state, metrics = step(state, wavs, jax.random.PRNGKey(19))
        out.append(float(metrics["train_loss"]))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nf", type=int, default=32)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    for name, fn in (("diffse_tpu_torch", port_losses), ("diffse_tpu", jax_losses)):
        losses = fn(args.nf, args.frames, args.batch, args.steps)
        print(f"{name} (CPU, nf {args.nf}, {args.batch} x {args.frames} frames): losses "
              f"{[round(v, 5) for v in losses]}; last / first {losses[-1] / losses[0]:.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
