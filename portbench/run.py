#!/usr/bin/env python3
#
# The benchmark of spark_rapids_ml_tpu_torch (the PyTorch and CUDA port) on
# NVIDIA cards.  From the root of a checkout:
#
#   python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
#
# runs one cell of BENCHMARK.json on this machine's card and prints, as the
# last line of standard output, one JSON object: correct, attempted,
# failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
# per-layer metrics), device, with --trace 1 breakdown, and last the
# numbers the check compared, each with its limit (also the last lines of
# standard error).  Without a CUDA card, with fewer cards than the cell
# asks for, or with JAX or the JAX package loaded once the window has
# closed, it prints no result and exits non-zero.
#
# Caches of the program (the port's nvcc libraries under build/torch_kernels,
# and any Triton, extension or CUDA cache) stay at fixed paths inside the
# checkout.
#

import time

T_START = time.perf_counter()  # setup_s counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)  # import the harness as the package portbench
else:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import cell, harness

    chips = cell.workload(cell.load_benchmark(), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has {count}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
