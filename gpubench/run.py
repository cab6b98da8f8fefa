"""The benchmark of nucleoatac_torch: one run of one cell.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds BENCHMARK.json, gpubench/ and
nucleoatac_torch/. Needs as many CUDA cards as the cell asks for; without
them it exits with code 2 and prints no result. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (spans, counters and a bounded device trace). The last
line of standard output is the result as one JSON object; the numbers the
correctness check compared are the last lines of standard error and the
last key of the result. Kernel and compiler caches live in build/ of the
checkout.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, whose module
# names (trace, data, ...) would shadow the standard library's
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    cache = os.path.join(ROOT, "build", "gpubench_cache")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch_kernels")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    import torch

    # one host thread for torch's own CPU work: its intra-op pool only adds
    # wake-ups to the loop's small host copies, and load from one thread
    # spreads less from run to run
    torch.set_num_threads(1)
    from gpubench.harness import Cell, forbidden_modules, run_cell

    need = Cell(ROOT, a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: the cell needs {need} CUDA card(s), {n} available", file=sys.stderr)
        return 2
    line = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                    t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
