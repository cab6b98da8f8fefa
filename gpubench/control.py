"""Readings for the limits of the correctness check: the program's numbers
and the control's, on the same sampled windows, over several seeds of one
cell, in one process. The benchmark's own runs do not run this.

    python3 gpubench/control.py --workload NAME --seconds S --seeds N [N ...]

For each seed: one run of the cell as gpubench/run.py makes it (a window
of S seconds), then the control (the reference at TF32 operand precision,
gpubench/reference/chain.py) in the program's place on the windows that
run sampled. One JSON line per seed: the program's numbers, the control's,
and the share of positions each certified.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    cache = os.path.join(ROOT, "build", "gpubench_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch_kernels")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    from gpubench.harness import run_cell

    for seed in a.seeds:
        line = run_cell(ROOT, a.workload, seed, a.seconds, False, control=True)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "correct": line["correct"],
            "program": {k: c["value"] for k, c in line["checks"].items()},
            "control": line["control"]["numbers"],
            "cert_share": [line["sampled"]["cert_share"], line["control"]["cert_share"]],
            "windows": line["sampled"]["windows"],
            "windows_per_s": line["metrics"]["windows_per_s"]["value"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
