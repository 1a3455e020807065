"""Time the two ways of building diffse_tpu_torch's CUDA kernel library.

  - ``parallel``: ``cuda_kernels.build_library()``, one ``nvcc -c`` per
    ``csrc/*.cu`` started together, then one link;
  - ``single``: one ``nvcc -shared`` over all sources, which compiles them
    one after another.

Each build starts from an empty directory under ``build/`` of the checkout
(nothing cached), in the order parallel, single, single, parallel, repeated
``--reps`` times. Prints one JSON line with every wall time in seconds. Needs
``nvcc``; no card.

    python tools/time_kernel_build.py --reps 2
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffse_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


def build_parallel(out_dir: Path) -> None:
    ck.BUILD_DIR = out_dir
    ck.build_library()


def build_single(out_dir: Path) -> None:
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-o", str(out_dir / "lib.so"),
                    *map(str, ck._sources())], check=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    root = ck.BUILD_DIR.parent
    root.mkdir(parents=True, exist_ok=True)
    times = {"parallel": [], "single": []}
    builders = {"parallel": build_parallel, "single": build_single}
    for _ in range(args.reps):
        for name in ("parallel", "single", "single", "parallel"):
            out_dir = Path(tempfile.mkdtemp(prefix=f"time_{name}_", dir=root))
            try:
                start = time.perf_counter()
                builders[name](out_dir)
                times[name].append(time.perf_counter() - start)
            finally:
                shutil.rmtree(out_dir)
    print(json.dumps({"sources": [p.name for p in ck._sources()], "seconds": times}))


if __name__ == "__main__":
    main()
