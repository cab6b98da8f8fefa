"""The seeded dataset: ATAC-like fragments over peaks, and a random genome.

One general generator, driven by the numbers of a configuration's "data"
block (which a traffic file may override):

- ``chroms`` chromosomes of ``peaks_per_chrom`` peaks of ``peak_bp`` bp,
  ``gap_bp`` apart, starting ``gap_bp`` in, the chromosome ending
  ``gap_bp`` after its last peak;
- per peak, a nucleosome array: dyads every ``dyad_spacing`` bp from
  ``dyad_edge`` bp in, the middle one left out (the nucleosome-free gap)
  when there are more than four;
- ``frags_per_peak`` fragments, a share ``nuc_share`` nucleosomal: a dyad
  drawn uniformly, the midpoint jittered by N(0, ``dyad_jitter_sd``)
  truncated to +-``dyad_jitter_max``, the raw length N(``nuc_len_mean``,
  ``nuc_len_sd``) clipped to [``nuc_len_min``, ``nuc_len_max``]; the rest
  short: raw length exp(``short_len_scale``) + ``short_len_min`` clipped to
  [``short_len_min``, ``short_len_max``], the read's left uniform over
  [start, end - 40);
- each chromosome's bases uniform over A, C, G, T.

Fragments are raw reads (left end, template length), as a BAM holds them;
a nucleosomal read's left is midpoint - (length - 1) // 2 - 4, so that the
Tn5-adjusted fragment centres on its dyad. Everything is drawn in a few
vectorised calls from one generator seeded by ``--seed``: the same seed
gives the same dataset, and every seed the same counts and shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    names: list  # chromosome names
    lengths: list  # chromosome lengths
    lefts: dict  # chrom -> raw read lefts int64, sorted
    tlens: dict  # chrom -> raw template lengths int64, co-indexed
    peaks: list  # (chrom, start, end)
    genome: dict  # chrom -> base codes uint8 (0..3 = A, C, G, T)

    def n_fragments(self) -> int:
        return sum(len(v) for v in self.lefts.values())


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole number: the seed's bits, sign and all."""
    s = int(seed)
    return np.random.default_rng([abs(s) & (2**64 - 1), abs(s) >> 64, int(s < 0)])


def make_dataset(spec: dict, seed: int) -> Dataset:
    rng = rng_for(seed)
    C, P, pbp, gap = spec["chroms"], spec["peaks_per_chrom"], spec["peak_bp"], spec["gap_bp"]
    n = spec["frags_per_peak"]
    n_nuc = int(n * spec["nuc_share"])
    n_short = n - n_nuc
    chrom_len = (pbp + gap) * P + 2 * gap
    names = [f"chr{i + 1}" for i in range(C)]
    starts = gap + np.arange(P, dtype=np.int64) * (pbp + gap)  # per chrom
    edge, step = spec["dyad_edge"], spec["dyad_spacing"]
    dyads = np.arange(edge, pbp - edge, step, dtype=np.int64)
    if len(dyads) > 4:
        dyads = np.delete(dyads, len(dyads) // 2)
    lefts, tlens, genome, peaks = {}, {}, {}, []
    acgt = rng.integers(0, 4, size=(C, chrom_len), dtype=np.uint8)
    for ci, name in enumerate(names):
        st = starts[:, None]
        dy = st + dyads[rng.integers(0, len(dyads), size=(P, n_nuc))]
        ln = np.clip(rng.normal(spec["nuc_len_mean"], spec["nuc_len_sd"], (P, n_nuc)),
                     spec["nuc_len_min"], spec["nuc_len_max"]).astype(np.int64)
        jit = np.clip(rng.normal(0.0, spec["dyad_jitter_sd"], (P, n_nuc)),
                      -spec["dyad_jitter_max"], spec["dyad_jitter_max"]).astype(np.int64)
        nuc_left = dy + jit - (ln - 1) // 2 - 4
        sl = np.clip(rng.exponential(spec["short_len_scale"], (P, n_short))
                     + spec["short_len_min"], spec["short_len_min"],
                     spec["short_len_max"]).astype(np.int64)
        sleft = rng.integers(st, st + pbp - 40, size=(P, n_short))
        left = np.concatenate([nuc_left.ravel(), sleft.ravel()])
        tlen = np.concatenate([ln.ravel(), sl.ravel()])
        order = np.argsort(left, kind="stable")
        lefts[name], tlens[name] = left[order], tlen[order]
        genome[name] = acgt[ci]
        peaks.extend((name, int(s), int(s) + pbp) for s in starts)
    return Dataset(names, [chrom_len] * C, lefts, tlens, peaks, genome)
