"""The GroupNorm kernels' shapes on the main path: every ``gn_silu_conv3x3``
and ``groupnorm_silu`` call of one forward of the 65M NCSN++ (F=256), at
T=64 frames; at T=128 and T=192 every width W scales by 2 and 3, and the
calls per forward stay the same. The batch and the activations' dtype come
from the run (``RUNS``): the float32 enhance paths take one utterance at a
time, the bf16 trunk one utterance or bench.py's batch of 16 at 64 frames.

The launch plans are held to these shapes on the CPU
(tests/test_torch_conv_plan.py) and timed at them on the card
(tools/conv_plan_sweep.py)."""

from __future__ import annotations

import torch

FRAMES = (64, 128, 192)
# bench.py's program: 16 utterances of 64 frames through the bf16 trunk
BENCH_BATCH = 16
BENCH_FRAMES = 64
# (batch, frames, activation dtype) of the main path's forwards
RUNS = [(1, 64, torch.float32), (1, 128, torch.float32), (1, 192, torch.float32),
        (1, 64, torch.bfloat16), (BENCH_BATCH, BENCH_FRAMES, torch.bfloat16)]

# (H, W, Cin, Cout, calls per forward) of gn_silu_conv3x3, with and without skip
CONV_SHAPES_T64 = [
    (4, 1, 256, 4, 1), (4, 1, 256, 256, 11), (4, 1, 512, 256, 3), (8, 2, 256, 4, 1),
    (8, 2, 256, 256, 7), (8, 2, 512, 256, 3), (16, 4, 256, 4, 1), (16, 4, 256, 256, 7),
    (16, 4, 512, 256, 3), (32, 8, 256, 4, 1), (32, 8, 256, 256, 7), (32, 8, 512, 256, 3),
    (64, 16, 128, 256, 1), (64, 16, 256, 4, 1), (64, 16, 256, 256, 6), (64, 16, 384, 256, 1),
    (64, 16, 512, 256, 2), (128, 32, 128, 4, 1), (128, 32, 128, 128, 7),
    (128, 32, 256, 128, 2), (128, 32, 384, 128, 1), (256, 64, 128, 4, 1),
    (256, 64, 128, 128, 7), (256, 64, 256, 128, 3),
]
# (H, W, C) of groupnorm_silu
GN_SHAPES_T64 = [(4, 1, 256), (8, 2, 256), (16, 4, 256), (32, 8, 256), (64, 16, 128),
                 (64, 16, 256), (128, 32, 128), (128, 32, 256), (256, 64, 128)]


def at_frames(frames: int, shapes):
    """``shapes`` (H, W, ...) at ``frames`` wide: W scaled by frames / 64."""
    return [(s[0], s[1] * frames // 64, *s[2:]) for s in shapes]
