"""Peaks -> merged intervals -> fixed-core windows.

Overlapping or touching peaks of a chromosome merge into one interval. An
interval is cut into cores of exactly ``core`` bp from its start, the last
core right-aligned to its end (cores may overlap, never pass the end); an
interval shorter than ``core`` is one core. A window spans the core and a
halo on each side wide enough for every per-core output (the occupancy
flank, the template's half-width plus the largest fragment's half), and is
padded on the right to a multiple of 128 columns.
"""
from __future__ import annotations


def merge(peaks: list) -> list:
    """(chrom, start, end) -> merged, sorted by (chrom, start, end)."""
    out: list = []
    for chrom, a, b in sorted(peaks):
        if out and out[-1][0] == chrom and a <= out[-1][2]:
            out[-1] = (chrom, out[-1][1], max(out[-1][2], b))
        else:
            out.append((chrom, a, b))
    return out


def halo(flank: int, v_width: int, v_upper: int) -> int:
    return max(flank, v_width // 2 + (v_upper - 1) // 2 + 1)


def width(core: int, h: int) -> int:
    w = core + 2 * h
    return w + (-w) % 128


def tiles(merged: list, core: int, h: int) -> list:
    """(chrom, core_start, core_end, win_start) of every window."""
    out = []
    for chrom, a, b in merged:
        if b - a <= core:
            out.append((chrom, a, b, a - h))
            continue
        s = a
        while s + core < b:
            out.append((chrom, s, s + core, s - h))
            s += core
        out.append((chrom, b - core, b, b - core - h))
    return out
