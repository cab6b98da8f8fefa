"""Shared pieces of the bench drivers: the device, the card's label, the
cached synthetic dataset, the window count and the port's run record.

The record (``build/atscale_torch.json`` in the checkout, or ``--record
PATH``) is the port's counterpart of the reference's ATSCALE.json, which
holds TPU runs and is neither read nor written here. e2e.py and config5.py
append their runs to it; engine.py reads the at-scale rows back. Every row
names its backend ("cuda" or "cpu") and the card (nvidia-smi's name and
power limit; null on the CPU).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
from pathlib import Path

import torch

from nucleoatac_torch.parallel.mesh import local_device
from nucleoatac_torch.profiling.stages import smi

ROOT = Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "atscale_torch.json"
KEEP = 100  # rows the record keeps, as ATSCALE.json
# the device asked for ("cuda", "cuda:k" or "cpu"); an absent card raises
device = local_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card), cuda:k or cpu "
                         "(the kernels' plain versions)")


def add_record_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--record", default=None, metavar="PATH",
                    help=f"the run record (default {RECORD.relative_to(ROOT)})")


def card(dev: torch.device) -> str | None:
    """nvidia-smi's name and power limit of the card; None on the CPU."""
    return smi() if dev.type == "cuda" else None


def sync(devices) -> None:
    """Wait for every card among ``devices``."""
    for d in dict.fromkeys(torch.device(d) for d in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dataset(workdir: str, n_chroms: int, n_peaks: int, peak_bp: int,
            frags_per_peak: int, seed: int = 7):
    """(bam, bed, fasta) of synth_dataset's data, cached under ``workdir``
    in a directory keyed by the md5 of the parameters, as
    scripts/bench_e2e.py keys it: a second call with the same parameters
    reads the files it finds."""
    from nucleoatac_torch.synthetic import synth_dataset

    key = hashlib.md5(
        f"{n_chroms}-{n_peaks}-{peak_bp}-{frags_per_peak}-{seed}".encode()
    ).hexdigest()[:10]
    d = os.path.join(workdir, f"nucleoatac_e2e_{key}")
    paths = tuple(os.path.join(d, n) for n in ("synth.bam", "peaks.bed", "synth.fa"))
    if all(os.path.exists(p) for p in paths):
        return paths
    os.makedirs(d, exist_ok=True)
    return synth_dataset(d, n_chroms, n_peaks, peak_bp, frags_per_peak, seed=seed)


def count_windows(bam: str, bed: str, cfg) -> int:
    """The windows a run tiles the merged peaks into (tile_chunks)."""
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.models.data import tile_chunks

    chunks = ChunkList.read(bed, scan_bam(bam).chrom_dict).merge()
    return len(tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat))


def read_record(path: str | None = None) -> list:
    """The record's rows, oldest first ([] before the first run)."""
    p = Path(path or RECORD)
    if not p.exists():
        return []
    with open(p) as fh:
        return json.load(fh)["runs"]


def record(row: dict, dev: torch.device, path: str | None = None) -> dict:
    """Append ``row`` with its backend, card and time to the record (the
    last KEEP rows stay); returns the row as written."""
    row = {**row, "backend": dev.type, "device": card(dev),
           "ts": time.strftime("%Y-%m-%dT%H:%M:%S")}
    p = Path(path or RECORD)
    runs = read_record(str(p)) + [row]
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as fh:
        json.dump({"runs": runs[-KEEP:]}, fh, indent=1)
        fh.write("\n")
    return row
