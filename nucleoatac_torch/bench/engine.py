"""Engine bench: windows/s of the production batch loop on one device,
beside a float64 CPU baseline and the whole pipeline.

Counterpart of the reference's bench.py. The timed loop is the fused run
loop: each batch's fragments are encoded on the host into a fresh buffer
(wire v6 under ``--wire delta12``, 2-byte delta pairs under ``--wire
delta``), uploaded, run through TorchEngine.run_step_delta12 or
run_step_delta, downloaded and unpacked (TorchEngine.unpack_run), with
``--depth`` batches in flight (models/occ.py :: _pipelined). The wall
starts after torch.cuda.synchronize() on the warmed card and ends when the
last batch's download event has been waited on. Every batch's inputs are
distinct, as in the reference, which keeps the host's encode and upload in
the loop as production has them. ``--wire delta`` is also
scripts/roofline.py's ``pipe`` row (the same loop on run_step_delta).
``--breakdown`` splits a repeat into the host encode, the loop without it
and the pinning of its host buffers, and prints the resident set after
each repeat. On a card both steps replay their CUDA graph (models/graphs.py),
captured in the warm-up: the line gives the engine's captures and the
bytes its graph pools reserve.

vs_baseline divides by the time per window of the port's float64 mirror
(nucleoatac_torch/mirror: rasterize, occupancy_window, bias_mat with the
PWM bias, nuc_scores, gauss_smooth) on one host thread of numpy, best of
two; the host's core count stands beside it.

``--e2e-peaks N`` (default 100; 0 skips) also runs the whole run_pipeline
on synth_dataset's data (1 chrom x N peaks x 2,000 bp x 500 fragments): a
warm-up run, then a timed one. The at-scale rows (config4_*, config5_*)
come from the port's run record (bench/common.py), which e2e.py and
config5.py write; the reference's ATSCALE.json holds TPU runs and is not
read.

Differences from the reference: --device replaces --platform; there is no
--fetch-threads (a relay setting) and no compilation cache; --core sets
the window core (default 1024, the reference's); any failure exits
nonzero.

Run: python3 -m nucleoatac_torch.bench.engine [--batch 128]
[--frag-cap 2048] [--batches 24] [--repeats 4] [--depth 3]
[--wire delta12|delta] [--cpu-windows 8] [--breakdown] [--e2e-peaks 100]
[--e2e-transfer pool] [--core 1024] [--record PATH] [--device cuda]
One JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from nucleoatac_torch import mirror
from nucleoatac_torch.bench import common
from nucleoatac_torch.models.data import (
    delta12_entry_capacity,
    encode_delta12_batch,
    encode_delta_batch,
    pack_nibble_codes,
)
from nucleoatac_torch.models.occ import _pipelined

WIRES = ("delta12", "delta")
# the at-scale rows: e2e and config5 runs of at least this many peaks
ATSCALE_PEAKS = 10000


def make_inputs(rng, n_batches: int, B: int, F: int, W: int, wp: int):
    """n_batches distinct raw fragment sets and nibble-packed sequence
    codes, drawn as bench.py's make_inputs draws them (one seed, the same
    numbers): (mids [n, B, F] int64 sorted per window, sizes [n, B, F]
    int64, [n x [B, ceil(wp/2)] uint8])."""
    mids = np.sort(rng.integers(0, W, size=(n_batches, B, F)), axis=2).astype(np.int64)
    szs = np.concatenate(
        [rng.normal(147, 20, size=(n_batches, B, F // 2)),
         rng.exponential(45, size=(n_batches, B, F - F // 2)) + 20],
        axis=2,
    )
    szs = np.clip(szs, 1, 250).astype(np.int64)
    nibs = [pack_nibble_codes(rng.integers(0, 4, size=(B, wp)).astype(np.uint8))
            for _ in range(n_batches)]
    return mids, szs, nibs


def encode(wire: str, mids: np.ndarray, szs: np.ndarray, W: int) -> np.ndarray:
    """One batch's upload, encoded on the host into a fresh buffer."""
    B, F = mids.shape
    if wire == "delta12":
        E = delta12_entry_capacity(F, W)
        buf = np.zeros((B, E // 2 + E), np.uint8)
        encode_delta12_batch(mids, szs, buf)
    else:
        buf = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
        encode_delta_batch(mids, szs, buf)
    return buf


def _step(eng, wire: str):
    return eng.run_step_delta12 if wire == "delta12" else eng.run_step_delta


def run_loop(eng, wire: str, mids, szs, nibs, depth: int = 3, collect=None) -> float:
    """The production loop over len(nibs) batches: host encode -> upload ->
    the chained step -> pipelined download and unpack_run. Returns the wall
    in seconds, from a synchronised device to the last batch's download;
    ``collect`` (a list) receives each batch's unpack_run."""
    step = _step(eng, wire)

    def batches():
        for i in range(len(nibs)):
            yield i, encode(wire, mids[i], szs[i], eng.width)

    def dispatch(item):
        i, buf = item
        return step(buf, nibs[i])

    common.sync(eng.devices)
    t0 = time.perf_counter()
    for _, out in _pipelined(batches(), dispatch, depth=depth):
        unpacked = eng.unpack_run(out)
        if collect is not None:
            collect.append(unpacked)
    return time.perf_counter() - t0


def rss_mb() -> float:
    """This process's resident set now, in MB (Linux)."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


def breakdown(eng, wire: str, mids, szs, nibs, depth: int) -> dict:
    """ms per batch of the host encode alone, of the loop on pre-encoded
    buffers, and (on a card) of pinning each batch's upload and download
    buffers, as to_device and _pipelined pin them."""
    n = len(nibs)
    t0 = time.perf_counter()
    bufs = [encode(wire, mids[i], szs[i], eng.width) for i in range(n)]
    t_enc = (time.perf_counter() - t0) / n
    step = _step(eng, wire)
    common.sync(eng.devices)
    t0 = time.perf_counter()
    for _, out in _pipelined(range(n), lambda i: step(bufs[i], nibs[i]), depth=depth):
        eng.unpack_run(out)
    t_noenc = (time.perf_counter() - t0) / n
    t_pin = None
    if eng.device.type == "cuda":
        n_out = out.shape
        t0 = time.perf_counter()
        for i in range(n):
            torch.from_numpy(bufs[i]).pin_memory()
            torch.from_numpy(nibs[i]).pin_memory()
            torch.empty(n_out, dtype=torch.uint8, pin_memory=True)
        t_pin = (time.perf_counter() - t0) / n * 1e3
    return {"encode_ms": t_enc * 1e3, "loop_without_encode_ms": t_noenc * 1e3,
            "pin_ms": t_pin}


# ---------------- the float64 CPU baseline ---------------------------------
def baseline_inputs(rng, eng, n: int, F: int):
    """The baseline's n windows, drawn as bench.py draws them: (sequences
    of W + L - 1 bases, mids [n, F], sizes [n, F], log-bias rows [n, W]
    used without a PWM)."""
    W, pwm = eng.width, eng.pwm
    wp = W + (pwm.length - 1 if pwm is not None else 0)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=wp)) for _ in range(n)]
    mids = rng.integers(0, W, size=(n, F)).astype(np.int64)
    szs = np.clip(rng.normal(147, 40, size=(n, F)), 1, 250).astype(np.int64)
    logb = (0.3 * rng.standard_normal((n, W))).astype(np.float64)
    return seqs, mids, szs, logb


def baseline_window(eng, mids, szs, seq: str, logb) -> dict:
    """One window's float64 work (the reference's stand-in for
    NucleoATAC's per-window Python): the raster, the occupancy MLE and CI,
    the PWM log bias, the bias matrix, the template scores and the
    smoothed norm."""
    cfg, W, pwm = eng.cfg, eng.width, eng.pwm
    mat = mirror.rasterize(mids, szs, 0, cfg.sizes.upper, W)
    occ = mirror.occupancy_window(mat, np.asarray(eng.log_mix, np.float64),
                                  np.asarray(eng.alpha_grid, np.float64), cfg.occ.flank)
    lb = pwm.bias_track(seq)[pwm.up: pwm.up + W] if pwm is not None else logb
    # the engine's float32 size probabilities, as the reference's bench reads them
    q = np.asarray(eng.size_probs64, np.float32).astype(np.float64)
    b0 = mirror.bias_mat(lb, q, cfg.vmat.lower, cfg.vmat.upper, eng.core_lo, eng.core_hi)
    scores = mirror.nuc_scores(mat[cfg.vmat.lower: cfg.vmat.upper], b0, eng.vmat.mat)
    return {"mat": mat, "occ": occ, "log_bias": lb, "b0": b0, "scores": scores,
            "smooth": mirror.gauss_smooth(scores.norm, cfg.nuc.smooth_sd)}


def baseline_s(eng, inputs) -> float:
    """Seconds per window of baseline_window, best of two passes."""
    seqs, mids, szs, logb = inputs
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for b in range(len(seqs)):
            baseline_window(eng, mids[b], szs[b], seqs[b], logb[b])
        best = min(best, (time.perf_counter() - t0) / len(seqs))
    return best


# ---------------- the pipeline and the at-scale rows ------------------------
def e2e(device: str, peaks: int, transfer: str) -> dict:
    """The whole run_pipeline on 1 chrom x ``peaks`` peaks x 2,000 bp x
    500 fragments (cached in the temporary directory): a warm-up run,
    then the timed one. Returns the wall, the windows and each run's
    batches."""
    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline

    bam, bed, fa = common.dataset(tempfile.gettempdir(), 1, peaks, 2000, 500)
    cfg = RunConfig(window=WindowParams(transfer=transfer))
    n_windows = common.count_windows(bam, bed, cfg)
    steps, walls = [], []
    for name in ("warm-up", "timed"):
        with tempfile.TemporaryDirectory(prefix="nucleoatac_bench_e2e_") as d:
            t0 = time.perf_counter()
            res = run_pipeline(bam, bed, os.path.join(d, "run"), fasta_path=fa, cfg=cfg,
                               write_plots=False, device=device)
            common.sync(res.engine.devices)
            walls.append(time.perf_counter() - t0)
        steps.append(res.engine.steps)
        print(f"# e2e {name} run: {walls[-1]:.2f} s", file=sys.stderr)
    return {"windows": n_windows, "wall_s": walls[-1], "steps": steps}


def atscale_rows(runs: list, min_peaks: int = ATSCALE_PEAKS) -> dict:
    """bench.py's at-scale keys from the port's record: the best of the
    last ten e2e runs of at least ``min_peaks`` peaks (not --strict), and
    the latest config5 run of as many."""
    out = {}
    c4 = [r for r in runs if r.get("kind") == "e2e"
          and r.get("peaks", 0) >= min_peaks and not r.get("strict")][-10:]
    c5 = [r for r in runs if r.get("kind") == "config5" and r.get("peaks", 0) >= min_peaks]
    if c4:
        r = max(c4, key=lambda r: r.get("windows_per_s", 0))
        out.update(config4_windows_per_s=r["windows_per_s"], config4_wall_s=r["wall_s"],
                   config4_peaks=r["peaks"], config4_backend=r["backend"],
                   config4_device=r["device"], config4_ts=r["ts"])
    if c5:
        r = c5[-1]
        out.update(config5_windows_per_s=r["windows_per_s"], config5_wall_s=r["wall_s"],
                   config5_hosts=r.get("hosts"), config5_samples=r.get("samples"),
                   config5_backend=r["backend"], config5_device=r["device"],
                   config5_ts=r["ts"])
    return out


def bench(args, hold=None) -> dict:
    """The bench's JSON line (see the module's docstring). ``hold``, when
    given, is called as hold(engine, wire, mids, sizes, nibs) on the first
    timed repeat's inputs before that repeat is timed."""
    from nucleoatac_torch.entry import _tiny_engine

    dev = common.device(args.device)
    _, eng = _tiny_engine(core=args.core, batch=args.batch, device=dev)
    B, F, W = args.batch, args.frag_cap, eng.width
    wp = eng.seq_codes_width()
    rng = np.random.default_rng(1)

    # warm-up: the kernels' build and the first launches, on throwaway batches
    t0 = time.perf_counter()
    run_loop(eng, args.wire, *make_inputs(rng, 2, B, F, W, wp), depth=args.depth)
    common.sync([dev])
    print(f"# warmed in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    walls, rss = [], []
    for r in range(max(1, args.repeats)):
        mids, szs, nibs = make_inputs(rng, args.batches, B, F, W, wp)
        if r == 0 and hold is not None:
            hold(eng, args.wire, mids, szs, nibs)
        walls.append(run_loop(eng, args.wire, mids, szs, nibs, depth=args.depth))
        rss.append(rss_mb())
        print(f"# repeat {r}: {args.batches * B / walls[-1]:,.0f} w/s, resident "
              f"{rss[-1]:.0f} MB", file=sys.stderr)
    dev_wps = args.batches * B / min(walls)

    split = None
    if args.breakdown:
        split = breakdown(eng, args.wire, *make_inputs(rng, args.batches, B, F, W, wp),
                          args.depth)
        pin = "not measured" if split["pin_ms"] is None else f"{split['pin_ms']:.2f} ms"
        print(f"# breakdown per batch of {B}: host encode {split['encode_ms']:.2f} ms, "
              f"pipelined loop w/o encode {split['loop_without_encode_ms']:.2f} ms, "
              f"full loop {min(walls) / args.batches * 1e3:.2f} ms, pinning {pin}; "
              f"resident after each repeat {[round(x) for x in rss]} MB", file=sys.stderr)

    n_cpu = max(1, args.cpu_windows)
    cpu_wps = 1.0 / baseline_s(eng, baseline_inputs(rng, eng, n_cpu, F))

    per = "GPU" if dev.type == "cuda" else "CPU process (plain versions)"
    out = {
        "metric": f"occ+nuc candidate windows/s per {per} ({args.core}bp cores)",
        "value": round(dev_wps, 2),
        "unit": "windows/s",
        "vs_baseline": round(dev_wps / cpu_wps, 2),
        "repeats_windows_per_s": [round(args.batches * B / t, 2) for t in walls],
        "wire": args.wire,
        "batch": B,
        "frag_cap": F,
        "batches": args.batches,
        "steps": eng.steps,
        "captures": eng.programs.captures,
        "graph_pool_bytes": eng.programs.pool_bytes,
        "cpu_windows_per_s": round(cpu_wps, 4),
        "cpu_windows": n_cpu,
        "host_cores": os.cpu_count(),
        "device": common.card(dev) or "cpu",
    }
    if split is not None:
        out["breakdown_ms"] = split
        out["resident_mb"] = [round(x, 1) for x in rss]
    if args.e2e_peaks > 0:
        e = e2e(args.device, args.e2e_peaks, args.e2e_transfer)
        out.update(e2e_windows_per_s=round(e["windows"] / e["wall_s"], 2),
                   e2e_peaks=args.e2e_peaks, e2e_wall_s=round(e["wall_s"], 2),
                   e2e_vs_engine=round(e["windows"] / e["wall_s"] / dev_wps, 4),
                   e2e_steps=e["steps"])
    out.update(atscale_rows(common.read_record(args.record)))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frag-cap", type=int, default=2048)
    ap.add_argument("--batches", type=int, default=24,
                    help="distinct batches per timed repeat")
    ap.add_argument("--repeats", type=int, default=4,
                    help="timed repeats (fresh inputs each); the best is the value")
    ap.add_argument("--depth", type=int, default=3, help="batches in flight")
    ap.add_argument("--wire", default="delta12", choices=WIRES,
                    help="upload format (delta12 = wire v6; delta = roofline.py's pipe row)")
    ap.add_argument("--cpu-windows", type=int, default=8)
    ap.add_argument("--breakdown", action="store_true",
                    help="print the encode/loop/pinning split to stderr")
    ap.add_argument("--e2e-peaks", type=int, default=100,
                    help="also time run_pipeline on this many synthetic peaks (0 = skip)")
    ap.add_argument("--e2e-transfer", default="pool", help="the e2e run's wire")
    ap.add_argument("--core", type=int, default=1024, help="window core, bp")
    common.add_record_arg(ap)
    common.add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    print(json.dumps(bench(parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
