"""End-to-end bench: the whole ``nucleoatac run`` at scale.

Counterpart of scripts/bench_e2e.py. ``main`` synthesizes an ATAC-like
dataset (synth_dataset: peaks with nucleosome arrays and an NFR, millions
of fragments), cached under ``--workdir`` by the md5 of its parameters,
then ``run_e2e`` times run_pipeline on it: BAM ingest, the mixture fit,
the fused occ+nuc pass on the device, merge, nfr and the BGZF and tabix
writers. Before the run, the ingest alone (io/bam.py :: scan_bam) gives
ingest MB/s. The windows come from models/data.py :: tile_chunks; the
peak resident set is the process's (ru_maxrss), whatever ran in it
before. ``main`` appends the run to the port's record (bench/common.py)
as kind "e2e".

Differences from the reference: --device replaces --platform; there is no
compilation cache; the line adds "windows", "windows_per_s" and
"device".

Run: python3 -m nucleoatac_torch.bench.e2e [--peaks 500] [--peak-bp 2000]
[--frags-per-peak 2000] [--chroms 4] [--workdir DIR] [--out DIR]
[--strict] [--seed 7] [--batch N] [--finish-threads N] [--record PATH]
[--device cuda]
One JSON line at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import sys
import tempfile
import time

from nucleoatac_torch.bench import common
from nucleoatac_torch.config import NucParams, RunConfig


def run_config(strict: bool = False, batch: int | None = None,
               finish_threads: int | None = None) -> RunConfig:
    """The default RunConfig with the bench's overrides."""
    cfg = RunConfig()
    if strict:
        cfg = dataclasses.replace(cfg, nuc=NucParams(strict=True))
    wkw = {k: v for k, v in (("batch", batch), ("finish_threads", finish_threads))
           if v is not None}
    if wkw:
        cfg = dataclasses.replace(cfg, window=dataclasses.replace(cfg.window, **wkw))
    return cfg


def run_e2e(bam: str, bed: str, fasta: str, out: str, cfg: RunConfig, device: str) -> dict:
    """Time run_pipeline on existing files (outputs at prefix ``out``) on
    ``device`` ("cuda" shards over every visible card, as ``run`` does),
    after the standalone ingest probe. Returns the bench line (the
    reference's keys but ``synth_s``, plus windows, windows_per_s, steps
    and device)."""
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.models.pipeline import run_pipeline

    dev = common.device(device)
    t0 = time.perf_counter()
    frags = scan_bam(bam)
    t_ingest = time.perf_counter() - t0
    n_ingested = frags.n_fragments()
    del frags
    bam_mb = os.path.getsize(bam) / 1e6

    t0 = time.perf_counter()
    res = run_pipeline(bam, bed, out, fasta_path=fasta, cfg=cfg, write_plots=False,
                       device=device)
    common.sync(res.engine.devices)
    t_run = time.perf_counter() - t0

    with open(bed) as fh:
        rows = [line.split("\t") for line in fh if line.strip()]
    total_bp = sum(int(r[2]) - int(r[1]) for r in rows)
    n_windows = common.count_windows(bam, bed, cfg)
    return {
        "metric": "e2e pipeline peak-bp/s (ingest+occ+nuc+merge+nfr+writers)",
        "value": round(total_bp / t_run, 1),
        "unit": "bp/s",
        "wall_s": t_run,
        "peaks": len(rows),
        "fragments": n_ingested,
        "ingest_MBps": bam_mb / t_ingest,
        "ingest_frags_per_s": n_ingested / t_ingest,
        "bam_MB": bam_mb,
        "peak_rss_MB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "dyads_called": len(res.nuc.calls),
        "nfrs": len(res.nfrs),
        "windows": n_windows,
        "windows_per_s": n_windows / t_run,
        "steps": res.engine.steps,
        "device": common.card(dev) or "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--peaks", type=int, default=500)
    ap.add_argument("--peak-bp", type=int, default=2000)
    ap.add_argument("--frags-per-peak", type=int, default=2000)
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--workdir", default=tempfile.gettempdir(),
                    help="where the dataset is cached (default: the temporary directory)")
    ap.add_argument("--out", default=None, help="output directory (default: under --workdir)")
    ap.add_argument("--strict", action="store_true",
                    help="NucParams(strict=True): f64-refinish the smoothed-score "
                         "column of every printed row")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=None, help="override WindowParams.batch")
    ap.add_argument("--finish-threads", type=int, default=None,
                    help="override WindowParams.finish_threads")
    common.add_record_arg(ap)
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.device(args.device)
    t0 = time.perf_counter()
    bam, bed, fa = common.dataset(args.workdir, args.chroms, args.peaks, args.peak_bp,
                                  args.frags_per_peak, seed=args.seed)
    t_synth = time.perf_counter() - t0
    outdir = args.out or os.path.join(args.workdir, "nucleoatac_e2e_out")
    os.makedirs(outdir, exist_ok=True)
    cfg = run_config(args.strict, args.batch, args.finish_threads)
    line = run_e2e(bam, bed, fa, os.path.join(outdir, "run"), cfg, args.device)
    line["synth_s"] = t_synth
    common.record({
        "kind": "e2e", "strict": bool(args.strict), "finish_threads": args.finish_threads,
        "batch": args.batch, "peaks": args.peaks,
        "fragments": args.peaks * args.frags_per_peak, "wall_s": line["wall_s"],
        "windows": line["windows"], "windows_per_s": line["windows_per_s"],
    }, dev, args.record)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
