"""Compare the output files of two `run` invocations (same inputs).

The bar is the one the reference meets between its own backends:
  * occ, occ.lower_bound, occ.upper_bound, occpeaks, nucmap_combined and
    nfrpos: equal decompressed rows;
  * nucpos and nucpos.redundant: equal rows except column 8 (0-based),
    the f32 smoothed score;
  * the two nucleoatac_signal bedgraphs hold device values: per-bp values
    within a tolerance (callers pass nuc.exact_tol).

Non-exact mode (occ.exact and nuc.exact False) prints device f32 values
in the nucpos columns too, so ``compare_runs_nonexact`` holds it to:
  * every file: equal coordinates (chrom, start, end of every row);
  * occ, occ.lower_bound, occ.upper_bound, occpeaks and nfrpos: equal
    rows; nucpos* columns 4-6 (occ stats) equal, nucmap_combined's
    source column equal;
  * nucpos* columns 3 and 8 (z, smoothed z) and nucmap_combined's score
    within the signal tolerance; columns 7, 9 and 10 (lr, signal, fuzz)
    within NONEXACT_STAT_TOL, the bars the JAX package's scores meet
    against its float64 mirror (tests/test_ops_vs_mirror.py);
  * the signal bedgraphs as above.
Printed values carry 5 significant digits, so two values within a bar
may print one unit of the last digit further apart: each float bar
allows that unit on top.
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List

import numpy as np

from nucleoatac_torch.config import RunConfig

EXACT_SUFFIXES = (
    ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
    ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
    ".nucmap_combined.bed.gz", ".nfrpos.bed.gz",
)
NUCPOS_SUFFIXES = (".nucpos.bed.gz", ".nucpos.redundant.bed.gz")
SIGNAL_SUFFIXES = (
    ".nucleoatac_signal.bedgraph.gz", ".nucleoatac_signal.smooth.bedgraph.gz",
)
RUN_SUFFIXES = EXACT_SUFFIXES + NUCPOS_SUFFIXES + SIGNAL_SUFFIXES
# nucpos column -> (rtol, atol) of the non-exact bar: lr, signal, fuzz
NONEXACT_STAT_TOL = {7: (1e-3, 5e-2), 9: (1e-4, 1e-5), 10: (1e-3, 1e-2)}


def port_config(cfg) -> RunConfig:
    """The port's own RunConfig holding the field values of ``cfg``, a
    RunConfig of either package, so that a comparison hands each package
    a config of its own built from the same fields."""
    return RunConfig(**{
        f.name: type(getattr(RunConfig(), f.name))(**dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(RunConfig)
    })


def read_rows(path: str) -> List[List[str]]:
    with gzip.open(path, "rt") as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]


def _same_text(path_a: str, path_b: str):
    """The decompressed bytes of two gzip files if they are equal, else
    None."""
    with gzip.open(path_a, "rb") as fa, gzip.open(path_b, "rb") as fb:
        a = fa.read()
        return a if a == fb.read() else None


def _per_bp(path: str) -> Dict[str, tuple]:
    """A bedgraph as {chrom: (positions, values)}, one entry per bp,
    positions ascending; a later row overrides an earlier one at the same
    position."""
    with gzip.open(path, "rb") as fh:
        tok = np.array(fh.read().split()).reshape(-1, 4)
    out = {}
    for name in np.unique(tok[:, 0]):
        rows = tok[tok[:, 0] == name]
        start = rows[:, 1].astype(np.int64)
        n = rows[:, 2].astype(np.int64) - start
        pos = np.repeat(start, n) + np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        val = np.repeat(rows[:, 3].astype(np.float64), n)
        pos, last = np.unique(pos[::-1], return_index=True)
        out[name.decode()] = (pos, val[::-1][last])
    return out


def _print_unit(x: np.ndarray) -> np.ndarray:
    """One unit of the last digit of x printed with %.5g."""
    mag = np.floor(np.log10(np.maximum(np.abs(x), 1e-300)))
    return np.where(x == 0, 0.0, 10.0 ** (mag - 4))


def _signal_diff(prefix_a: str, prefix_b: str, sfx: str, signal_tol: float) -> float:
    """Max per-bp |a - b| of two bedgraphs (0 where a file has no row)."""
    a, b = _per_bp(prefix_a + sfx), _per_bp(prefix_b + sfx)
    none = (np.zeros(0, np.int64), np.zeros(0))
    worst, at = 0.0, None
    for chrom in sorted(set(a) | set(b)):
        (pa, va), (pb, vb) = a.get(chrom, none), b.get(chrom, none)
        pos = np.union1d(pa, pb)
        d = np.zeros(len(pos))
        d[np.searchsorted(pos, pa)] += va
        d[np.searchsorted(pos, pb)] -= vb
        d = np.abs(d)
        if len(d) and d.max() > worst:
            worst, at = float(d.max()), (chrom, int(pos[int(d.argmax())]))
    if worst > signal_tol:
        raise AssertionError(f"{sfx}: max |a - b| {worst:.3e} > {signal_tol} at {at}")
    return worst


def _close_cols(sfx: str, a, b, col: int, rtol: float, atol: float) -> float:
    """Max |a - b| of one float column; raise past rtol/atol + one
    printed unit."""
    x = np.array([float(r[col]) for r in a])
    y = np.array([float(r[col]) for r in b])
    if not len(x):
        return 0.0
    d = np.abs(x - y)
    bar = atol + rtol * np.abs(y) + np.maximum(_print_unit(x), _print_unit(y))
    if (d > bar).any():
        i = int(np.argmax(d - bar))
        raise AssertionError(
            f"{sfx} column {col}: |{x[i]} - {y[i]}| = {d[i]:.3e} past the bar "
            f"(rtol {rtol}, atol {atol}) at {a[i][:3]}"
        )
    return float(d.max())


def compare_runs_nonexact(prefix_a: str, prefix_b: str, signal_tol: float) -> Dict[str, float]:
    """The non-exact bar (module docstring). Raise AssertionError at the
    first difference beyond it; return {file suffix: rows compared} plus
    the max |a - b| of each float column and signal track."""
    stats: Dict[str, float] = {}
    row_equal = EXACT_SUFFIXES[:4] + (".nfrpos.bed.gz",)
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        a, b = read_rows(prefix_a + sfx), read_rows(prefix_b + sfx)
        keep = list(range(3)) if sfx not in row_equal else None
        if sfx in NUCPOS_SUFFIXES:
            keep = [0, 1, 2, 4, 5, 6]
        elif sfx == ".nucmap_combined.bed.gz":
            keep = [0, 1, 2, 4]
        ka = a if keep is None else [[r[i] for i in keep] for r in a]
        kb = b if keep is None else [[r[i] for i in keep] for r in b]
        if ka != kb:
            bad = next(
                (i for i, (x, y) in enumerate(zip(ka, kb)) if x != y),
                min(len(ka), len(kb)),
            )
            raise AssertionError(
                f"{sfx}: rows differ ({len(a)} vs {len(b)} rows; first at "
                f"row {bad}: {ka[bad] if bad < len(ka) else None} vs "
                f"{kb[bad] if bad < len(kb) else None})"
            )
        stats[sfx] = len(a)
        if sfx in NUCPOS_SUFFIXES:
            for col in (3, 8):
                stats[f"{sfx} col{col} max_abs_diff"] = _close_cols(sfx, a, b, col, 0.0, signal_tol)
            for col, (rtol, atol) in NONEXACT_STAT_TOL.items():
                stats[f"{sfx} col{col} max_abs_diff"] = _close_cols(sfx, a, b, col, rtol, atol)
        elif sfx == ".nucmap_combined.bed.gz":
            stats[f"{sfx} col3 max_abs_diff"] = _close_cols(sfx, a, b, 3, 0.0, signal_tol)
    for sfx in SIGNAL_SUFFIXES:
        stats[sfx + " max_abs_diff"] = _signal_diff(prefix_a, prefix_b, sfx, signal_tol)
    return stats


def compare_runs(prefix_a: str, prefix_b: str, signal_tol: float) -> Dict[str, float]:
    """Raise AssertionError at the first difference beyond the bar; return
    {file suffix: rows compared} plus the signal tracks' max |a - b|."""
    stats: Dict[str, float] = {}
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        raw = _same_text(prefix_a + sfx, prefix_b + sfx)
        if raw is not None and sfx in EXACT_SUFFIXES:  # equal text: equal rows
            stats[sfx] = sum(1 for ln in raw.split(b"\n") if ln.strip())
            continue
        a, b = read_rows(prefix_a + sfx), read_rows(prefix_b + sfx)
        if sfx in NUCPOS_SUFFIXES:
            a = [r[:8] + r[9:] for r in a]
            b = [r[:8] + r[9:] for r in b]
        if a != b:
            bad = next(
                (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)),
            )
            raise AssertionError(
                f"{sfx}: rows differ ({len(a)} vs {len(b)} rows; first at "
                f"row {bad}: {a[bad] if bad < len(a) else None} vs "
                f"{b[bad] if bad < len(b) else None})"
            )
        stats[sfx] = len(a)
    for sfx in SIGNAL_SUFFIXES:
        stats[sfx + " max_abs_diff"] = _signal_diff(prefix_a, prefix_b, sfx, signal_tol)
    return stats
