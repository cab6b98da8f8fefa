#!/usr/bin/env python
"""Check and time the port's multi-GPU run on one machine with several GPUs.

    python3 scripts/multi_gpu_check.py [--peaks 1000] [--ranks N [N ...]] [--device cuda]

1. guard — each kernel on the last card while cuda:0 is the current
   device: launched there, and equal to its plain version there.
2. run   — run_pipeline on cuda:0 over chip_smoke.py's synthetic dataset.
2b. devices — run_pipeline on "cuda" in one process: each window batch
   sharded over every visible card (parallel/mesh.py :: auto_devices).
   All ten output files (decompressed) and nuc_dist must equal step 2's;
   both walls are printed.
3. ranks — for each N of --ranks (default: the GPU count), `torchrun
   --nproc_per_node N -m nucleoatac_torch.cli.nucleoatac run ...
   --num_hosts N`: each rank on its own card (cuda:{LOCAL_RANK}), rank 0
   finalizing after the gloo barrier. All ten output files (decompressed)
   and nuc_dist must equal step 2's. Each rank's shard wall and rank 0's
   finalize wall are read from the ranks' stage log.
Prints one line per step and a JSON summary (also written to
chiprun_out/multi_gpu_check.json, step by step); exits nonzero on any
failure. ``--device cpu --ranks 2`` rehearses steps 2, 2b (two shards on
the CPU) and 3 without a GPU (plain kernel versions, every rank on the
CPU).
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax in this process)


def check_guard() -> dict:
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch
    from nucleoatac_torch.ops.xcorr import conv_stack_diag

    cfg = RunConfig()
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(5)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    mat, logb = chip_smoke._synthetic_batch(last, cfg.window.batch, W, rng)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=last)
    b0 = bias_mat_batch(logb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo)
    fmat = mat[:, cfg.vmat.lower - cfg.sizes.lower:]
    tabs = chip_smoke._template_tables(last)
    n1, n2 = k1.LAUNCHES, k2.LAUNCHES
    got2 = k2.nuc_scores(fmat, b0, *tabs, 1e-12)
    got1 = k1.diag_xcorr(fmat, tabs[0])
    torch.cuda.synchronize(last)
    if (k1.LAUNCHES - n1, k2.LAUNCHES - n2) != (1, 1):
        raise AssertionError("the kernels did not launch")
    if torch.cuda.current_device() != 0 or got2.device != last:
        raise AssertionError("the current device or the output's card moved")
    want2 = k2.nuc_scores_plain(fmat, b0, *tabs, 1e-12)
    want1 = conv_stack_diag(fmat, tabs[0])
    torch.testing.assert_close(got2, want2, rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(got1, want1, rtol=1e-4, atol=1e-4)
    err = {"nuc_scores": float((got2 - want2).abs().max()),
           "diag_xcorr": float((got1 - want1).abs().max())}
    chip_smoke.phase("guard", f"K1 and K2 on {last} with cuda:0 current: launched "
                     f"there, max|k - plain| {err}")
    return err


def digest(path: str) -> tuple:
    """(rows, sha256) of a gzip file's decompressed text."""
    h, rows = hashlib.sha256(), 0
    with gzip.open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 22), b""):
            h.update(block)
            rows += block.count(b"\n")
    return rows, h.hexdigest()


def run_devices(data: dict, device: str, ref: dict, one: str, t_one: float) -> dict:
    """run_pipeline over every visible card in one process (two CPU
    shards under --device cpu); its outputs against step 2's digests."""
    import numpy as np

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.parity import RUN_SUFFIXES

    multi = os.path.join(data["dir"], "devices")
    k2.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_pipeline(data["bam"], data["bed"], multi, fasta_path=data["fasta"],
                       cfg=RunConfig(), write_plots=False,
                       device="cuda" if device == "cuda" else ["cpu", "cpu"])
    wall = time.perf_counter() - t0
    devs = [str(d) for d in res.engine.devices]
    if len(devs) < 2:
        raise AssertionError(f"devices: one process ran on {devs} alone")
    rows = 0
    for sfx in RUN_SUFFIXES:
        got = digest(multi + sfx)
        if got != ref[sfx] or not got[0]:
            raise AssertionError(f"{sfx}: {len(devs)} shards differ from one card")
        rows += got[0]
    if not (np.loadtxt(one + ".nuc_dist.txt") == np.loadtxt(multi + ".nuc_dist.txt")).all():
        raise AssertionError("devices: nuc_dist differs")
    if device == "cuda" and k2.LAUNCHES != res.engine.steps:
        raise AssertionError(f"devices: {k2.LAUNCHES} K2 launches for "
                             f"{res.engine.steps} shard batches")
    for sfx in RUN_SUFFIXES:
        os.remove(multi + sfx)
    chip_smoke.phase("devices", f"one process on {devs}: {wall:.2f} s against one "
                     f"card's {t_one:.2f} s; {res.engine.steps} shard batches; "
                     f"{len(RUN_SUFFIXES)} files, {rows} rows and nuc_dist equal to "
                     "one card")
    return {"wall_s": wall, "one_s": t_one, "devices": devs,
            "shard_batches": res.engine.steps, "rows": rows}


def run_ranks(data: dict, ranks: int, device: str, ref: dict, one: str) -> dict:
    """One torchrun of `run --num_hosts ranks`; its outputs against the
    one-process run's digests ``ref``."""
    import numpy as np

    from nucleoatac_torch.parity import RUN_SUFFIXES

    multi = os.path.join(data["dir"], f"ranks{ranks}")
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={ranks}", "-m", "nucleoatac_torch.cli.nucleoatac",
           "run", "--bam", data["bam"], "--bed", data["bed"], "--fasta",
           data["fasta"], "--out", multi, "--no_plots", "--device", device,
           "--num_hosts", str(ranks)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n{log[-4000:]}")
    placed = sorted(set(re.findall(r"host (\d+)/\d+ on (\S+):", log)))
    want = [(str(k), f"cuda:{k}" if device == "cuda" else "cpu") for k in range(ranks)]
    if placed != want:
        raise AssertionError(f"ranks placed on {placed}, expected {want}")
    shard = [float(s) for s in re.findall(r"host \d+ shard: done in ([0-9.]+)s", log)]
    fin = [float(s) for s in re.findall(r"finalize: done in ([0-9.]+)s", log)]
    if len(shard) != ranks or len(fin) != 1:
        raise AssertionError(f"stage log: shard walls {shard}, finalize walls {fin}")
    rows = 0
    for sfx in RUN_SUFFIXES:
        got = digest(multi + sfx)
        if got != ref[sfx] or not got[0]:
            raise AssertionError(f"{sfx}: {ranks} ranks differ from one process")
        rows += got[0]
    if not (np.loadtxt(one + ".nuc_dist.txt") == np.loadtxt(multi + ".nuc_dist.txt")).all():
        raise AssertionError("nuc_dist differs")
    for sfx in RUN_SUFFIXES:  # keep the disk for the next torchrun
        os.remove(multi + sfx)
    chip_smoke.phase("ranks", f"torchrun {ranks} ranks on {[p[1] for p in placed]}: "
                     f"{wall:.2f} s with process start; shard walls {shard} s, "
                     f"rank 0's finalize {fin[0]:.2f} s; {len(RUN_SUFFIXES)} files, "
                     f"{rows} rows and nuc_dist equal to one process")
    return {"wall_s": wall, "shard_s": shard, "finalize_s": fin[0], "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--peaks", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="process counts to run, in order (default: the GPU count)")
    args = ap.parse_args()
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import RUN_SUFFIXES

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    summary = {"peaks": args.peaks}

    def save():
        with open(os.path.join(out_dir, "multi_gpu_check.json"), "w") as fh:
            json.dump(summary, fh, indent=1)

    if args.device == "cuda":
        chip_smoke.phase_device()
        if torch.cuda.device_count() < 2:
            raise SystemExit("multi_gpu_check: needs at least two GPUs")
        summary["gpus"] = torch.cuda.device_count()
        summary["card"] = chip_smoke.smi()
        chip_smoke.phase_build()
        summary["guard_max_abs_err"] = check_guard()
        save()
    for n in args.ranks or [torch.cuda.device_count()]:
        if args.device == "cuda" and n > torch.cuda.device_count():
            raise SystemExit(f"multi_gpu_check: {n} ranks need {n} GPUs")
    with tempfile.TemporaryDirectory() as d:
        data = chip_smoke.make_dataset(d, n_peaks=args.peaks)
        one = os.path.join(d, "one")
        cfg = RunConfig()
        t0 = time.perf_counter()
        res = run_pipeline(data["bam"], data["bed"], one, fasta_path=data["fasta"],
                           cfg=cfg, write_plots=False,
                           device=f"{args.device}:0" if args.device == "cuda" else "cpu")
        t_one = time.perf_counter() - t0
        windows = len(tile_chunks(res.occ.chunks, cfg.window, cfg.occ, cfg.vmat))
        chip_smoke.phase("run", f"one process on {args.device}: {t_one:.2f} s = "
                         f"{windows / t_one:.1f} windows/s, {windows} windows, "
                         f"{len(res.nuc.calls)} dyads (data synthesis "
                         f"{data['t_data']:.1f} s, not timed)")
        summary.update({"one_s": t_one, "windows": windows, "t_data": data["t_data"]})
        save()
        ref = {sfx: digest(one + sfx) for sfx in RUN_SUFFIXES}
        summary["devices"] = run_devices(data, args.device, ref, one, t_one)
        save()
        for n in args.ranks or [torch.cuda.device_count()]:
            summary[f"ranks{n}"] = run_ranks(data, n, args.device, ref, one)
            save()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
