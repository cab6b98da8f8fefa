"""Host finishing of the fused occ+nuc pass under cProfile.

Counterpart of scripts/profile_finish.py. Runs run_pipeline with inline
finishing (``finish_threads=0``, so that cProfile sees the finishing on
the main thread) on synth_dataset's data (scripts/bench_e2e.py's
generator), after a warm-up run at 8 peaks outside the profile that
builds the kernels and the CUDA context. Prints the wall time and ms per
peak, the cumulative table, the tottime of the reference's component
groups, and the fused pass's own wall-clock terms
(NUCLEOATAC_FUSED_TIMERS, models/fused.py) beside them.

cProfile adds a cost to every Python call and none to native code, so it
shifts the proportions; its table names candidates, the timers measure.

Run: python3 -m nucleoatac_torch.profiling.finish [--peaks 1000]
[--frags-per-peak 500] [--chroms 4] [--top 40] [--strict]
[--device cuda]
One JSON line at the end holds the numbers.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import os
import pstats
import sys
import tempfile
import time

import torch

from nucleoatac_torch.device import resolve_device
from nucleoatac_torch.profiling.stages import smi

# label -> (file, function) whose tottime the group sums: the reference's
# groups, at the same names in the port
GROUPS = {
    "TileSession build (F/B0)": ("nuc_exact.py", "__init__"),
    "f64 point stats (stats_at)": ("nuc_exact.py", "stats_at"),
    "lean norm columns": ("nuc_exact.py", "norm_cols"),
    "FFT full tracks": ("nuc_exact.py", "full_stat_tracks"),
    "SmoothResolver.ensure": ("nuc_exact.py", "ensure"),
    "occ _f64_picks": ("occ.py", "_f64_picks"),
    "RLE+format (prepare_bedgraph)": ("tabix.py", "prepare_bedgraph"),
    "nfr occ-track scan": ("standalone.py", "get"),
}


def group_tottime(stats: pstats.Stats) -> dict:
    """tottime (s) of each GROUPS entry, summed over every function of
    that name in a file of that name."""
    return {label: sum(v[2] for k, v in stats.stats.items()
                       if k[0].endswith(fname) and k[2] == func)
            for label, (fname, func) in GROUPS.items()}


def profile_finish(peaks: int = 1000, frags_per_peak: int = 500, chroms: int = 4,
                   top: int = 40, strict: bool = False, device="cuda",
                   out_dir: str | None = None, stream=None) -> dict:
    """The profiled run on ``device`` (raises without a card for "cuda"):
    prints its tables to ``stream`` (stdout) and returns {wall_s,
    ms_per_peak, groups, fused_timers, prefix, ...}. The outputs are kept
    under ``out_dir`` (prefix ``run``) when it is given."""
    from nucleoatac_torch.config import NucParams, RunConfig, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.synthetic import synth_dataset

    dev = resolve_device(device)
    stream = stream or sys.stdout
    cfg = RunConfig(window=WindowParams(finish_threads=0))
    if strict:
        cfg = dataclasses.replace(cfg, nuc=NucParams(strict=True))
    with tempfile.TemporaryDirectory(prefix="nucleoatac_profile_") as tmp:
        d = out_dir or tmp
        os.makedirs(os.path.join(d, "warm"), exist_ok=True)
        bam, bed, fa = synth_dataset(d, chroms, peaks, 2000, frags_per_peak)
        wbam, wbed, wfa = synth_dataset(os.path.join(d, "warm"), 1, 8, 2000, frags_per_peak)
        # the warm-up builds the kernels and the CUDA context outside the profile
        run_pipeline(wbam, wbed, os.path.join(d, "warm", "run"), fasta_path=wfa, cfg=cfg,
                     write_plots=False, device=str(dev))
        prefix = os.path.join(d, "run")
        old = os.environ.get("NUCLEOATAC_FUSED_TIMERS")
        os.environ["NUCLEOATAC_FUSED_TIMERS"] = "1"
        pr = cProfile.Profile()
        try:
            t0 = time.perf_counter()
            pr.enable()
            res = run_pipeline(bam, bed, prefix, fasta_path=fa, cfg=cfg,
                               write_plots=False, device=str(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            pr.disable()
            wall = time.perf_counter() - t0
        finally:
            if old is None:
                os.environ.pop("NUCLEOATAC_FUSED_TIMERS", None)
            else:
                os.environ["NUCLEOATAC_FUSED_TIMERS"] = old
    print(f"\n=== fused occ+nuc wall: {wall:.2f} s ({peaks} peaks, "
          f"{wall / peaks * 1e3:.2f} ms/peak) on {dev} ===\n", file=stream)
    table = io.StringIO()
    st = pstats.Stats(pr, stream=table)
    st.sort_stats("cumulative").print_stats(top)
    print(table.getvalue(), file=stream)
    groups = group_tottime(st)
    timers = res.nuc.fused_timers
    print("component tottime (s):", file=stream)
    for label, tot in groups.items():
        print(f"  {label:34s} {tot:8.3f}", file=stream)
    print("fused pass timers (s; main thread exclusive, workers cpu-s):", file=stream)
    for name, v in timers.items():
        print(f"  {name:34s} {v:8.3f}", file=stream)
    return {"profile": "finish", "device": dev.type, "peaks": peaks,
            "frags_per_peak": frags_per_peak, "chroms": chroms, "strict": strict,
            "wall_s": wall, "ms_per_peak": wall / peaks * 1e3, "groups": groups,
            "fused_timers": timers, "batches": res.engine.steps,
            "prefix": prefix if out_dir else None,
            "card": smi() if dev.type == "cuda" else None,
            "device_count": torch.cuda.device_count() if dev.type == "cuda" else 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--peaks", type=int, default=1000)
    ap.add_argument("--frags-per-peak", type=int, default=500)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--strict", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rep = profile_finish(args.peaks, args.frags_per_peak, args.chroms, args.top,
                         args.strict, args.device)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
