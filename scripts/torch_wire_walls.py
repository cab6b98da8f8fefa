#!/usr/bin/env python
"""Wall time of nucleoatac_torch's `run_pipeline` on one GPU, per wire, on
the full-width dataset of chip_smoke.py's phase 5 (1,000 peaks of 2,000 bp,
2,000 fragments per peak, the default RunConfig but for the wire).

    python3 scripts/torch_wire_walls.py --data DIR
        writes the dataset (and a small warm-up one) into DIR;
    python3 scripts/torch_wire_walls.py --data DIR --tree CHECKOUT --wires pool,delta12
        times each wire with the nucleoatac_torch of CHECKOUT.

``--tree`` puts a checkout first on the import path, so that two commits
run on the same card in one session (parent, change, change, parent).
Each process first runs the pool wire on the warm-up dataset (CUDA
context, kernel build), untimed. One JSON line per timed run: the tree,
the wire, wall seconds, windows/s, nuc batches, K2 launches, the sha256 of
the decompressed nucpos rows, and the card's name and power limit as
nvidia-smi prints them. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(d: str) -> tuple:
    return tuple(os.path.join(d, n) for n in ("synth.bam", "peaks.bed", "synth.fa"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="dataset directory")
    ap.add_argument("--tree", default=ROOT, help="checkout whose nucleoatac_torch runs")
    ap.add_argument("--wires", default="", help="comma-separated wires to time")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    if not args.wires:
        from nucleoatac_torch.synthetic import synth_dataset

        os.makedirs(os.path.join(args.data, "warm"), exist_ok=True)
        synth_dataset(args.data, 4, 1000, 2000, 2000)
        synth_dataset(os.path.join(args.data, "warm"), 1, 8, 2000, 200)
        return 0

    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.ops import nuc_scores as k2

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    label = os.path.basename(tree.rstrip("/"))
    out = os.path.join(args.data, f"out_{label}_{os.getpid()}")
    os.makedirs(out)
    bam, bed, fa = _files(os.path.join(args.data, "warm"))
    run_pipeline(bam, bed, os.path.join(out, "warm"), fasta_path=fa, cfg=RunConfig(),
                 write_plots=False, device="cuda")
    bam, bed, fa = _files(args.data)
    for wire in args.wires.split(","):
        cfg = RunConfig(window=WindowParams(transfer=wire))
        prefix = os.path.join(out, wire)
        k2.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_pipeline(bam, bed, prefix, fasta_path=fa, cfg=cfg, write_plots=False,
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        windows = len(tile_chunks(res.occ.chunks, cfg.window, cfg.occ, cfg.vmat))
        with gzip.open(prefix + ".nucpos.bed.gz", "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        print(json.dumps({
            "tree": label, "wire": wire, "wall_s": wall, "windows_per_s": windows / wall,
            "windows": windows, "nuc_batches": res.engine.steps,
            "k2_launches": k2.LAUNCHES, "nucpos_sha256": digest, "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
