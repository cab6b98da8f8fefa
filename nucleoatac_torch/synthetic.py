"""Seeded synthetic ATAC-seq data, written with the port's own BAM and
FASTA writers: what the smoke run on the card (chip_smoke.py) and the
port's tests read. The same seed gives the same fragments."""
from __future__ import annotations

import os

import numpy as np

from nucleoatac_torch.io.bam_writer import write_bam
from nucleoatac_torch.io.fasta import write_fasta


def synth_dataset(d: str, n_chroms: int, n_peaks: int, peak_bp: int,
                  frags_per_peak: int, seed: int = 7, dinuc: float = 0.0):
    """ATAC-like synthetic data, the generator of scripts/bench_e2e.py
    (same seed, same fragments): per peak, a nucleosome array at ~180 bp
    spacing with one NFR gap, nucleosomal fragments (~147+9 raw) around the
    dyads and short fragments in linker and NFR space; a random genome.
    With ``dinuc`` > 0 that share of the nucleosomal fragments becomes
    di-nucleosomal: centred between two dyads 180 bp apart, raw size
    180 + 156 +- 14 (about 300-380 bp adjusted). At 0 (the default) the
    bytes are the generator's."""
    bam, bed, fa = (os.path.join(d, n) for n in ("synth.bam", "peaks.bed", "synth.fa"))
    rng = np.random.default_rng(seed)
    per_chrom = n_peaks // n_chroms
    gap = 5000
    chrom_len = (peak_bp + gap) * per_chrom + 2 * gap
    names = [f"chr{i + 1}" for i in range(n_chroms)]
    frags, bed_rows = [], []
    for ci, name in enumerate(names):
        for pi in range(per_chrom):
            start = gap + pi * (peak_bp + gap)
            end = start + peak_bp
            bed_rows.append((name, start, end))
            dyads = list(range(start + 90, end - 90, 180))
            if len(dyads) > 4:
                del dyads[len(dyads) // 2]
            n_nuc = int(frags_per_peak * 0.55)
            n_short = frags_per_peak - n_nuc
            dy = rng.choice(dyads, size=n_nuc)
            szs = np.clip(rng.normal(156, 14, n_nuc), 130, 250).astype(int)
            mids = dy + np.clip(rng.normal(0, 12, n_nuc), -40, 40).astype(int)
            if dinuc > 0:
                left = np.array([a for a, b in zip(dyads, dyads[1:]) if b - a == 180])
                two = np.flatnonzero(rng.random(n_nuc) < dinuc)
                mids[two] = (rng.choice(left, size=len(two)) + 90
                             + np.clip(rng.normal(0, 12, len(two)), -40, 40).astype(int))
                szs[two] = np.clip(rng.normal(336, 14, len(two)), 290, 400).astype(int)
            for m, sz in zip(mids, szs):
                frags.append((ci, int(m) - (int(sz) - 1) // 2 - 4, int(sz)))
            sl = np.clip(rng.exponential(42, n_short) + 24, 24, 128).astype(int)
            ll = rng.integers(start, end - 40, n_short)
            for left, sz in zip(ll, sl):
                frags.append((ci, int(left), int(sz)))
    frags.sort(key=lambda t: (t[0], t[1]))
    write_bam(bam, names, [chrom_len] * n_chroms, frags)
    with open(bed, "w") as fh:
        for name, a, b in bed_rows:
            fh.write(f"{name}\t{a}\t{b}\n")
    write_fasta(fa, {n: "".join(rng.choice(list("ACGT"), chrom_len)) for n in names})
    return bam, bed, fa


def make_example(d: str, seed: int = 42, n_per_dyad: int = 300, n_nfr: int = 500,
                 n_bg: int = 200) -> dict:
    """The small example of tests/synth.py (same seed, same bytes): four
    planted dyads and one NFR on a 6,000 bp chromosome, one peak."""
    rng = np.random.default_rng(seed)
    frags = []
    for dyad in (1000, 1200, 1500, 2600):
        for _ in range(n_per_dyad):
            size = int(np.clip(rng.normal(156, 12), 120, 250))
            mid = dyad + int(np.clip(rng.normal(0, 8), -30, 30))
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    for _ in range(n_nfr):
        size = int(np.clip(rng.exponential(40) + 24, 24, 119))
        left = int(rng.integers(1700, 2500 - 50))
        frags.append((0, left, size))
    for _ in range(n_bg):
        size = int(np.clip(rng.exponential(45) + 24, 24, 245))
        left = int(rng.integers(500, 3400))
        frags.append((0, left, size))
    bam = os.path.join(d, "example.bam")
    write_bam(bam, ["chr1"], [6000], frags)
    fa = os.path.join(d, "example.fa")
    write_fasta(fa, {"chr1": "".join(rng.choice(list("ACGT"), 6000))})
    bed = os.path.join(d, "peaks.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t500\t3500\tpeak1\n")
    return {"dir": d, "bam": bam, "fasta": fa, "bed": bed}


def make_long_example(d: str, seed: int = 9, n_long: int = 150) -> dict:
    """make_example's four planted dyads plus long fragments centred
    between adjacent dyads (raw size 280 +- 14, clipped to 256-320, so most
    fall inside --upper 300 and past the uint8 wires), background
    fragments, and two peaks, so that two hosts split the chunks."""
    dyads = (1000, 1200, 1500, 2600)
    rng = np.random.default_rng(seed)
    frags = []
    for dyad in dyads:
        for _ in range(300):
            size = int(np.clip(rng.normal(156, 12), 120, 250))
            mid = dyad + int(np.clip(rng.normal(0, 8), -30, 30))
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    for a, b in zip(dyads, dyads[1:]):
        for _ in range(n_long):
            size = int(np.clip(rng.normal(280, 14), 256, 320))
            mid = (a + b) // 2 + int(np.clip(rng.normal(0, 8), -30, 30))
            frags.append((0, mid - (size - 1) // 2 - 4, size))
    for _ in range(700):
        size = int(np.clip(rng.exponential(45) + 24, 24, 245))
        frags.append((0, int(rng.integers(500, 5400)), size))
    frags.sort()
    bam, fa, bed = (os.path.join(d, n) for n in ("long.bam", "long.fa", "peaks.bed"))
    write_bam(bam, ["chr1"], [6000], frags)
    write_fasta(fa, {"chr1": "".join(rng.choice(list("ACGT"), 6000))})
    with open(bed, "w") as fh:
        fh.write("chr1\t500\t3500\tpeak1\nchr1\t3600\t5600\tpeak2\n")
    return {"dir": d, "bam": bam, "fasta": fa, "bed": bed}
