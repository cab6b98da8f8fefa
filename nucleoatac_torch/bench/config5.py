"""BASELINE config 5: a multi-sample run sharded over N >= 2 hosts, then
finalized, held byte for byte against one host.

Counterpart of scripts/bench_config5.py. For each of ``--samples``
synthetic samples (seeds 7, 21, ...; bench/common.py :: dataset, cached
under ``--workdir``):

1. ``python -m nucleoatac_torch.cli.nucleoatac run --num_hosts N --host_id
   k --device D`` once per shard, each a process of its own, one after
   the other (real hosts run them at once, so the critical path is the
   slowest shard plus the finalize);
2. ``run --num_hosts N --finalize`` (the shards' rows concatenated and
   re-indexed, then merge and nfr);
3. a one-host ``run`` on the same sample;
4. every one of the ten merged outputs compared byte for byte with the
   one-host run's;
5. the walls, the parallel efficiency ((one host / N) / critical path)
   and the windows into the port's record (bench/common.py) as kind
   "config5".

The windows are counted with models/data.py :: tile_chunks, as e2e.py
counts them, where the reference estimates peaks * 2. A byte difference,
or a process that fails, ends the run with a nonzero exit (after the
sample's JSON line).

Run: python3 -m nucleoatac_torch.bench.config5 [--peaks 10000]
[--frags-per-peak 500] [--chroms 10] [--hosts 2] [--samples 2]
[--skip-single] [--workdir DIR] [--batch N] [--timeout S] [--record PATH]
[--device cuda]
One JSON line per sample, then one with every sample.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

from nucleoatac_torch.bench import common
from nucleoatac_torch.config import RunConfig

OUTPUTS = [
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
    ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
    ".nucpos.bed.gz", ".nucpos.redundant.bed.gz",
    ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
]


def run_cli(args_list: list, device: str, log_path: str, timeout: float | None = None):
    """One process of the port's CLI on ``device``, its output appended to
    ``log_path``; returns (wall s, the largest resident set of any child so
    far, MB). Raises, with the log's end, when the process fails."""
    cmd = [sys.executable, "-m", "nucleoatac_torch.cli.nucleoatac", *args_list,
           "--device", device, "--no_plots"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(common.ROOT), env.get("PYTHONPATH"))
                                        if p)
    t0 = time.perf_counter()
    with open(log_path, "ab") as log:
        log.write((" ".join(cmd) + "\n").encode())
        log.flush()
        proc = subprocess.run(cmd, cwd=common.ROOT, env=env, stdout=log, stderr=log,
                              timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        with open(log_path, errors="replace") as fh:
            tail = fh.read()[-4000:]
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}; log:\n{tail}")
    return wall, resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024


def compare_outputs(a: str, b: str) -> list:
    """The suffixes of OUTPUTS whose files under prefixes ``a`` and ``b``
    differ or are missing."""
    diff = []
    for sfx in OUTPUTS:
        if not (os.path.exists(a + sfx) and os.path.exists(b + sfx)):
            diff.append(sfx + " (missing)")
            continue
        with open(a + sfx, "rb") as fa, open(b + sfx, "rb") as fb:
            if fa.read() != fb.read():
                diff.append(sfx)
    return diff


def run_sample(si: int, args) -> dict:
    """Sample ``si``: the shards, the finalize, the one-host run and the
    comparison; returns its JSON line."""
    seed = 7 + 14 * si
    bam, bed, fa = common.dataset(args.workdir, args.chroms, args.peaks, 2000,
                                  args.frags_per_peak, seed=seed)
    base = os.path.join(args.workdir, f"nucleoatac_torch_cfg5_s{si}")
    os.makedirs(base, exist_ok=True)
    log = os.path.join(base, "cli.log")
    common_args = ["run", "--bam", bam, "--bed", bed, "--fasta", fa]
    if args.batch is not None:
        common_args += ["--batch", str(args.batch)]

    def cli(extra):
        return run_cli(common_args + extra, args.device, log, args.timeout)

    out_sh = os.path.join(base, "sharded")
    hosts = ["--num_hosts", str(args.hosts)]
    shard_walls = []
    for k in range(args.hosts):
        w, _ = cli(["--out", out_sh, *hosts, "--host_id", str(k)])
        shard_walls.append(w)
        print(f"# sample {si} shard {k}/{args.hosts}: {w:.1f} s", flush=True)
    t_fin, rss = cli(["--out", out_sh, *hosts, "--finalize"])
    print(f"# sample {si} finalize: {t_fin:.1f} s", flush=True)

    out_1 = os.path.join(base, "single")
    t_single = None
    if not (args.skip_single and os.path.exists(out_1 + OUTPUTS[-1])):
        t_single, rss = cli(["--out", out_1])
        print(f"# sample {si} single-host: {t_single:.1f} s", flush=True)

    diff = compare_outputs(out_sh, out_1)
    crit = max(shard_walls) + t_fin
    return {
        "sample": si, "seed": seed, "shard_walls_s": shard_walls, "finalize_s": t_fin,
        "critical_path_s": crit, "single_host_s": t_single,
        "parallel_efficiency": (t_single / args.hosts) / crit if t_single else None,
        "outputs_identical": not diff, "diff_files": diff,
        "windows": common.count_windows(bam, bed, RunConfig()),
        "peak_rss_MB": rss,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--peaks", type=int, default=10000)
    ap.add_argument("--frags-per-peak", type=int, default=500)
    ap.add_argument("--chroms", type=int, default=10)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--skip-single", action="store_true",
                    help="reuse an existing one-host run")
    ap.add_argument("--workdir", default=tempfile.gettempdir())
    ap.add_argument("--batch", type=int, default=None, help="the CLI's --batch")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds each CLI process may take")
    common.add_record_arg(ap)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.device(args.device)
    results = []
    for si in range(args.samples):
        results.append(run_sample(si, args))
        print(json.dumps(results[-1]), flush=True)
        if not results[-1]["outputs_identical"]:
            print(f"# sample {si}: outputs differ from one host's: "
                  f"{results[-1]['diff_files']}", file=sys.stderr)
            return 1
    windows = results[0]["windows"]
    crit = max(r["critical_path_s"] for r in results)
    common.record({
        "kind": "config5", "hosts": args.hosts, "samples": args.samples,
        "peaks": args.peaks, "wall_s": crit, "windows": windows,
        "windows_per_s": windows / crit, "per_sample": results,
    }, dev, args.record)
    print(json.dumps({"config5": results, "device": common.card(dev) or "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
