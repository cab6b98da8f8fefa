"""The comparison that decides ``correct``.

Once the window has closed, the reference (gpubench/reference, float64
NumPy) works out each sampled window again from the raw inputs, and the
program's decoded outputs of that window are held to it:

- ``occ_cert_mismatch``: positions the program certified whose occupancy
  pick or CI bounds differ from the reference's (certified picks are
  exact by the program's own contract);
- ``occ_ll_gap``: the widest gap, over every compared position, by which
  the reference's log-likelihood at the program's pick lies below its
  best (0 where the picks agree);
- ``nuc_norm_steps``: the widest gap between the program's decoded norm
  and the reference's, over the core and the smoothing margins, in units
  of the window's u16 step (range / 65535 of the reference's norm there);
- ``tile_mismatch``: windows in one pass of the program's batches and not
  in the reference's tiling of the peaks, or the other way round.

Each number has its limit in gpubench/limits/ (the cell's file, else
default.json). The control puts the reference at TF32 operand precision in
the program's place (gpubench/reference/chain.py, ``control=True``) and
goes through the same comparison.
"""
from __future__ import annotations

import json
import os

import numpy as np

from gpubench.reference import chain, fit, tiles


class Reference:
    """The reference's view of one run: its own decoding of the raw
    fragments, tiling, histogram, mixture and tables."""

    def __init__(self, stated: dict, data, template: np.ndarray, pwm_probs: np.ndarray,
                 pwm_up: int):
        def g(group, key):
            return stated[group][key]

        self.lower, self.upper = g("sizes", "lower"), g("sizes", "upper")
        self.flank, self.ci_drop = g("occ", "flank"), g("occ", "ci_drop")
        self.exact_tol = g("occ", "exact_tol")
        self.vlo, self.vhi = g("vmat", "lower"), g("vmat", "upper")
        self.var_floor = g("nuc", "var_floor")
        self.core = g("window", "core")
        sd = g("nuc", "smooth_sd")
        self.margin = max(1, int(round(3 * sd))) if sd > 0 else 0
        shift, shrink = (4, 9) if g("ingest", "atac") else (0, 0)
        self.frags = {c: chain.adjust_fragments(data.lefts[c], data.tlens[c],
                                                g("ingest", "max_size"), shift, shrink)
                      for c in data.names}
        self.chrom_len = dict(zip(data.names, data.lengths))
        self.genome = data.genome
        self.halo = tiles.halo(self.flank, template.shape[1], self.vhi)
        self.width = tiles.width(self.core, self.halo)
        merged = tiles.merge(data.peaks)
        self.tiles = tiles.tiles(merged, self.core, self.halo)
        hist = fit.size_histogram(self.frags, merged, self.lower, self.upper)
        nuc, nfr = fit.mixture(hist, self.lower, stated["mixture"])
        self.log_mix = fit.log_mix(nuc, nfr, g("occ", "grid_size"), g("occ", "mix_floor"))
        self.q = fit.size_probs(hist, self.lower, self.vlo, self.vhi)
        self.template = template
        self.log_ratio = np.log(np.clip(pwm_probs, 1e-12, None) / 0.25)
        self.up = pwm_up

    def raster(self, chrom: str, ws: int) -> np.ndarray:
        m, s = chain.window_fragments(*self.frags[chrom], ws, ws + self.width)
        return chain.raster(m - ws, s, self.lower, self.upper, self.width)

    def occ(self, chrom: str, ws: int, control: bool = False) -> chain.OccPicks:
        return chain.occupancy(self.raster(chrom, ws), self.log_mix, self.flank,
                               self.ci_drop, self.halo, self.core, control, self.exact_tol)

    def norm(self, chrom: str, ws: int, control: bool = False) -> np.ndarray:
        """The norm over [core_lo - margin, core_lo + core + margin)."""
        mat = self.raster(chrom, ws)
        lb = chain.log_bias(self.genome[chrom], self.chrom_len[chrom], ws, self.width,
                            self.up, self.log_ratio)
        b0 = chain.bias_matrix(lb, self.q, self.vlo, self.vhi, self.halo,
                               self.width - self.halo)
        F = mat[self.vlo - self.lower:self.vhi - self.lower]
        norm = chain.nuc_norm(F, b0, self.template, self.var_floor, control)
        return norm[self.halo - self.margin:self.halo + self.core + self.margin]


def control_outputs(ref: Reference, kind: str, meta) -> dict:
    """The control's decoded outputs of one window, as the program's."""
    got = {}
    if kind in ("run", "occ"):
        p = ref.occ(meta.chrom, meta.win_start, control=True)
        got["idx"] = np.stack([p.best, p.first, p.last])
        got["cert"] = p.cert
    if kind in ("run", "nuc"):
        got["norm"], got["qstep"] = chain.u16_roundtrip(
            ref.norm(meta.chrom, meta.win_start, control=True).astype(np.float32))
    return got


def window_numbers(ref: Reference, kind: str, t, got: dict) -> dict:
    """The compared numbers of one window (tile_mismatch aside), with the
    certified and non-empty position counts."""
    out = {}
    if "idx" in got:
        p = ref.occ(t.chrom, t.win_start)
        idx, cert = np.asarray(got["idx"]), np.asarray(got["cert"], bool)
        want = np.stack([p.best, p.first, p.last])
        out["occ_cert_mismatch"] = int((cert & (idx != want).any(axis=0)).sum())
        G = p.ll.shape[1]
        if (idx[0] >= G).any():
            out["occ_ll_gap"] = float("inf")
        else:
            rows = np.arange(len(p.best))
            out["occ_ll_gap"] = float((p.ll[rows, p.best] - p.ll[rows, idx[0]]).max())
        out["_cert"], out["_pos"] = int(cert.sum()), int((~p.empty).sum())
    if "norm" in got:
        want = ref.norm(t.chrom, t.win_start)
        err = float(np.abs(np.asarray(got["norm"], np.float64) - want).max())
        step = chain.u16_step(want)
        out["nuc_norm_steps"] = err / step if step > 0 else (0.0 if err == 0 else float("inf"))
    return out


def compare(ref: Reference, samples: list, pass_tiles: list) -> dict:
    """``samples``: (kind, TileMeta, decoded outputs of that window).
    Each number is the largest (a count: the sum) over the windows."""
    per = [window_numbers(ref, kind, t, got) for kind, t, got in samples]
    numbers = {"occ_cert_mismatch": sum(w.get("occ_cert_mismatch", 0) for w in per)}
    for k in ("occ_ll_gap", "nuc_norm_steps"):
        numbers[k] = max((w[k] for w in per if k in w), default=0.0)
    seen = {(t.chrom, t.core_start, t.core_end, t.win_start) for t in pass_tiles}
    numbers["tile_mismatch"] = len(seen ^ set(ref.tiles)) + len(pass_tiles) - len(seen)
    n_pos = sum(w.get("_pos", 0) for w in per)
    return {"numbers": numbers, "windows": per,
            "cert_share": sum(w.get("_cert", 0) for w in per) / n_pos if n_pos else None}


def limits(root: str, config: str, traffic: str) -> dict:
    d = os.path.join(root, "gpubench", "limits")
    own = os.path.join(d, f"{config}.{traffic}.json")
    with open(own if os.path.exists(own) else os.path.join(d, "default.json")) as fh:
        return json.load(fh)


def judge(result: dict, lim: dict):
    """(correct, failed windows, [(name, value, limit)]): every number at
    or under its limit, and at least one window compared."""
    numbers, per = result["numbers"], result["windows"]
    rows = [(k, numbers[k], lim[k]) for k in lim]
    failed = sum(1 for w in per if any(w.get(k, 0) > lim[k] for k in lim))
    ok = bool(per) and all(v <= lm for _, v, lm in rows)
    return ok, failed, rows
