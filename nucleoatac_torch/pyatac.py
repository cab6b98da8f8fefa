"""pyatac utility commands on PyTorch.

Counterpart of nucleoatac_tpu/pyatac.py. Its host functions are JAX-free
and are imported as they are; the two that reach JAX there are rewritten
here: ``aggregate_vplot_device`` (the batched raster runs as torch ops on
an explicit device) and ``bias_vplot`` (which needs the port's
``chunk_log_bias``).
"""
from __future__ import annotations

import numpy as np
import torch

from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import BamFragments
from nucleoatac_tpu.io.fasta import FastaFile
from nucleoatac_tpu.mirror.windows import bias_mat as mirror_bias_mat
from nucleoatac_tpu.pyatac import (  # noqa: F401  (re-exported host utilities)
    aggregate_vplot,
    coverage_track,
    fragment_ends,
    insertion_track,
    nucleotide_freq_matrix,
    pwm_from_data,
    region_counts,
    sizes_histogram,
    track_signal_matrix,
)
from nucleoatac_torch.device import resolve_device, to_device
from nucleoatac_torch.models.nuc import chunk_log_bias
from nucleoatac_torch.ops.rasterize import rasterize_batch


def aggregate_vplot_device(
    frags: BamFragments,
    features: ChunkList,
    lower: int = 105,
    upper: int = 251,
    flank: int = 73,
    batch: int = 256,
    device: str = "cuda",
) -> np.ndarray:
    """Batched device aggregation of the V-plot: sites scatter into a
    [B, S, W] raster on ``device`` (ops/rasterize.py, the raster of the
    main pipeline), minus-strand rows flip, and the batch sums there.
    Counts are integers below 2^24, so the result equals
    :func:`aggregate_vplot` exactly."""
    dev = resolve_device(device)
    W = 2 * flank + 1
    sites = []
    cap = 1
    for c in features:
        center = c.center()
        m, s = frags.window(c.chrom, center - flank, center + flank + 1)
        sites.append((m - (center - flank), s, c.strand == "-"))
        cap = max(cap, len(m))
    F = 64
    while F < cap:
        F *= 2

    total = torch.zeros((upper - lower, W), dtype=torch.float64, device=dev)
    for i in range(0, len(sites), batch):
        group = sites[i : i + batch]
        mids = np.zeros((batch, F), np.int64)
        szs = np.zeros((batch, F), np.int64)
        valid = np.zeros((batch, F), bool)
        neg = np.zeros(batch, bool)
        for r, (m, s, isneg) in enumerate(group):
            mids[r, : len(m)] = m
            szs[r, : len(s)] = s
            valid[r, : len(m)] = True
            neg[r] = isneg
        mat = rasterize_batch(
            to_device(mids, dev), to_device(szs, dev), to_device(valid, dev),
            lower, upper, W,
        )
        mat = torch.where(to_device(neg, dev)[:, None, None], mat.flip(2), mat)
        total += mat.sum(dim=0).double()
    return total.cpu().numpy()


def bias_vplot(
    frags: BamFragments,
    fasta: FastaFile,
    pwm: PWM,
    features: ChunkList,
    sizes: FragmentSizes,
    lower: int = 105,
    upper: int = 251,
    flank: int = 73,
) -> np.ndarray:
    """Expected (bias-only) aggregate V-plot (reference `pyatac
    bias_vplot`): per feature, the DESIGN.md §6 bias matrix scaled to the
    feature's observed fragment count, summed over features."""
    W = 2 * flank + 1
    h = sizes.get(lower, upper).astype(np.float64)
    q = h / h.sum() if h.sum() > 0 else np.full_like(h, 1.0 / len(h))
    pad = (upper - 1) // 2 + 1
    out = np.zeros((upper - lower, W), dtype=np.float64)
    for c in features:
        center = c.center()
        lo = center - flank - pad
        hi = center + flank + 1 + pad
        logb = chunk_log_bias(fasta, pwm, c.chrom, lo, hi)
        b0 = mirror_bias_mat(logb, q, lower, upper, pad, pad + W)
        m, s = frags.window(c.chrom, center - flank, center + flank + 1)
        nfrag = int(((s >= lower) & (s < upper)).sum())
        seg = b0[:, pad : pad + W]
        if c.strand == "-":
            seg = seg[:, ::-1]
        out += seg * nfrag
    return out
