"""The paper's 65.6M NCSN++ forward of this checkout against another's (e.g.
the parent commit unpacked under ``build/``), on the card, on the same
redrawn weights and input: equal bit for bit or not, and each tree's kernel
launches per forward.

Each tree runs in a process of its own (both hold a package named
``diffse_tpu_torch``), builds its kernels from its own sources, and writes
its outputs to a ``.npy`` file that this script compares.

    python3 tools/compare_trees_forward.py --other build/parent [--frames 64 128]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

WORKER = r"""
import json, sys
import numpy as np
import torch
from diffse_tpu_torch.models.ncsnpp import NCSNpp
from diffse_tpu_torch.ops import cuda_kernels as ck

out_path, frames, dtype = sys.argv[1], [int(f) for f in sys.argv[2].split(",")], sys.argv[3]
ck.build_library()
dev = torch.device("cuda", 0)
model = NCSNpp(generator=torch.Generator().manual_seed(0),
               **({} if dtype == "float32" else {"dtype": dtype}))
g = torch.Generator().manual_seed(1)
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
model = model.to(dev).eval()
rng = np.random.default_rng(2)
outs, launches = {}, {}
for t in frames:
    shape = (1, 2, 256, t)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(dev), torch.tensor([0.5], device=dev))
    torch.cuda.synchronize()
    outs[str(t)] = out.cpu().numpy()
    launches[str(t)] = dict(ck.launch_counts)
np.savez(out_path, **outs)
print(json.dumps(launches))
"""


def run_tree(tree: str, out_path: str, frames, dtype: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER, out_path, ",".join(map(str, frames)),
                           dtype], cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="the other checkout's root")
    parser.add_argument("--frames", type=int, nargs="+", default=[64, 128])
    parser.add_argument("--dtype", choices=("float32", "bf16"), nargs="+",
                        default=["float32", "bf16"])
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in args.dtype:
            results = {}
            for label, tree in (("this", here), ("other", os.path.abspath(args.other))):
                path = os.path.join(tmp, f"{label}_{dtype}.npz")
                launches = run_tree(tree, path, args.frames, dtype)
                results[label] = (np.load(path), launches)
            for t in map(str, args.frames):
                a, b = results["this"][0][t], results["other"][0][t]
                equal = bool(np.array_equal(a, b))
                same &= equal
                print(f"{dtype} NCSN++ forward, F=256 T={t}: bitwise equal {equal}, "
                      f"max|diff| {float(np.max(np.abs(a - b))):.3e}; launches this "
                      f"{results['this'][1][t]}, other {results['other'][1][t]}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
