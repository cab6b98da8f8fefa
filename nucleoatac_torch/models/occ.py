"""`nucleoatac occ` stage: mixture fit, per-bp occupancy + CI tracks with
f64-exact finishing, occ peaks, and the pipelined batch loop.

Counterpart of nucleoatac_tpu/models/occ.py. The host logic is the
reference's; the device loop (_pipelined) is rewritten for CUDA streams.
``OccStage.run`` (the standalone and two-pass occ stage) uploads the
configured wire (pool falls back to per-window delta12 records; delta,
packed, frags and dense as in the reference) and downloads wire v8 occ
bytes in exact mode, or wire v2 (full CI indices, no f64 refinisher) when
occ.exact is False.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.chunk import Chunk, ChunkList
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.io.bam import BamFragments
from nucleoatac_torch.io.tabix import TabixWriter
from nucleoatac_torch.models.data import (
    ChunkAssembler,
    make_batches,
    make_delta12_batches,
    make_delta_batches,
    make_dense_batches,
    make_packed_batches,
    tile_chunks,
)
from nucleoatac_torch.utils.numerics import greedy_select_fast, local_max_candidates_fast
from nucleoatac_torch.utils.trace import open_loop, span


@dataclass
class OccPeak:
    chrom: str
    pos: int  # dyad-like center position
    occ: float
    lower: float
    upper: float


# host->device wire formats (cfg.window.transfer), as the reference's
WIRES = ("pool", "delta12", "delta", "packed", "frags", "dense")


def stage_wire(cfg: RunConfig) -> str:
    """The wire the two-pass stages upload: the configured one, except that
    the pool wire (a fused-pass format) falls back to per-window delta12
    records, the same device programs after the raster."""
    transfer = cfg.window.transfer
    if transfer not in WIRES:
        raise ValueError(f"unknown transfer {transfer!r}; expected one of {WIRES}")
    return "delta12" if transfer == "pool" else transfer


def wire_batches(cfg: RunConfig, wire: str, frags: BamFragments, tiles, width: int):
    """The host batches of ``wire`` over ``tiles`` (models/data.py)."""
    B = cfg.window.batch
    if wire == "dense":  # int16 counts rasterized on the host
        return make_dense_batches(frags, tiles, width, B, cfg.sizes.lower, cfg.sizes.upper)
    return {"delta12": make_delta12_batches, "delta": make_delta_batches,
            "packed": make_packed_batches, "frags": make_batches}[wire](
        frags, tiles, width, B)


def wire_arrays(wire: str, b) -> tuple:
    """The host arrays of a ``wire`` batch, in the order of the engine's
    named steps' arguments."""
    if wire == "frags":
        return b.mids, b.sizes, b.valid
    return (getattr(b, {"delta12": "buf", "delta": "delta", "packed": "packed",
                        "dense": "mats"}[wire]),)


@dataclass
class OccStageResult:
    mix: FragmentMixDistribution
    fragmentsizes: FragmentSizes
    # per-chunk dense tracks, keyed by chunk index in the merged ChunkList.
    # After `run_pipeline` these are the PRINTED surface — values re-read
    # from the 5-decimal bedgraphs just written (_LazyOccTracks) — so the
    # NFR stage consumes the same occ surface as the reference's nfr,
    # which reads the bedgraph.
    tracks: Dict[int, Dict[str, np.ndarray]] = field(default_factory=dict)
    peaks: List[OccPeak] = field(default_factory=list)
    chunks: Optional[ChunkList] = None


def fit_mixture(
    frags: BamFragments, chunks: ChunkList, cfg: RunConfig
) -> Tuple[FragmentSizes, FragmentMixDistribution]:
    """Genome-wide (peak-restricted) fragment-size histogram + mixture fit
    (reference: FragmentSizes.calculateSizes + FragmentMixDistribution
    .fitDists)."""
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper)
    for c in chunks:
        _, sizes = frags.window(c.chrom, c.start, c.end)
        fs.add_sizes(sizes)
    mix = FragmentMixDistribution(
        cfg.sizes.lower, cfg.sizes.upper, cfg.mixture
    ).fit(fs)
    return fs, mix


def call_occ_peaks(
    chunk: Chunk, occ: np.ndarray, lower: np.ndarray, cfg: RunConfig
) -> List[OccPeak]:
    """DESIGN.md §4: local maxima of occ (±occ_sep//2) where the CI lower
    bound clears min_occ; greedy by occ with min separation occ_sep."""
    p = cfg.occ
    mask = lower >= p.min_occ
    cand = local_max_candidates_fast(occ, p.occ_sep // 2, mask)
    sel = greedy_select_fast(occ, cand, p.occ_sep)
    return [
        OccPeak(chunk.chrom, chunk.start + i, float(occ[i]), float(lower[i]), float(0))
        for i in sel
    ]


def _pipelined(batches, dispatch, depth: int = 3):
    """Keep up to ``depth`` (>= 2) batches in flight and yield
    ``(batch, numpy result)`` in dispatch order.

    ``dispatch(batch)`` enqueues the batch's device chain and returns its
    output tensor. On a CUDA tensor the download is started at once —
    ``.to("cpu", non_blocking=True)`` into pinned memory, with one CUDA
    event per batch — and the host waits only on the event of the batch
    it yields, so later batches compute and copy while the host finishes
    earlier ones. CPU results are yielded as they are.

    Each call opens a loop record of the tracer (utils/trace.py) and
    times the host's parts of each batch in it: ``loop.dispatch`` (the
    dispatch call), ``loop.download`` (the pinned buffer, the copy and the
    event) and ``loop.wait`` (the wait on the yielded batch's event, one
    call per batch yielded)."""
    depth = max(2, depth)
    q: deque = deque()
    open_loop("pipelined")

    def start(out: torch.Tensor):
        if out.device.type != "cuda":
            return out, None
        with span("loop.download"):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(out.device))  # the copy's stream
        return host, ev

    def finish(item):
        b, host, ev = item
        with span("loop.wait"):
            if ev is not None:
                ev.synchronize()
        return b, host.numpy()

    for b in batches:
        with span("loop.dispatch"):
            out = dispatch(b)
        host, ev = start(out)
        q.append((b, host, ev))
        if len(q) > depth:
            yield finish(q.popleft())
    while q:
        yield finish(q.popleft())


def open_writers(prefix: Optional[str]) -> Dict[str, TabixWriter]:
    """The occ stage's bgzip+tabix writers ({} without a prefix)."""
    if not prefix:
        return {}
    return {
        "occ": TabixWriter(f"{prefix}.occ.bedgraph.gz"),
        "lower": TabixWriter(f"{prefix}.occ.lower_bound.bedgraph.gz"),
        "upper": TabixWriter(f"{prefix}.occ.upper_bound.bedgraph.gz"),
        "peaks": TabixWriter(f"{prefix}.occpeaks.bed.gz"),
    }


class OccStage:
    """The `occ` stage (run) and the per-chunk occ finishing (f64
    refinish, spot check, peaks, payloads) it shares with the fused run."""

    def __init__(self, cfg: RunConfig, engine):
        self.cfg = cfg
        self.engine = engine

    def track_names(self) -> List[str]:
        return ["occ", "lower", "upper"] + (
            ["cert"] if self.cfg.occ.exact else []
        )

    def prepare_exact(self, mix: FragmentMixDistribution) -> None:
        """Float64 host tables for _exact_refinish."""
        if self.cfg.occ.exact:
            self._m64 = mix.log_mix_table(self.cfg.occ)
            self._grid64 = mix.alpha_grid(self.cfg.occ)
            # Runtime guard on the certification tolerance: exact_tol was
            # validated per backend offline; on the first chunks of every
            # run a sample of CERTIFIED positions is recomputed in f64 and
            # must reproduce the device's grid picks exactly — failing
            # loudly beats silently losing exactness. Decremented from
            # finisher worker threads without a lock: a lost decrement
            # only spot-checks an extra chunk.
            self._spot_chunks = 8
            self.n_spot_checked = 0

    def run(
        self,
        frags: BamFragments,
        chunks: ChunkList,
        mix: FragmentMixDistribution,
        fragmentsizes: FragmentSizes,
        out_prefix: Optional[str] = None,
        keep_tracks: bool = True,
    ) -> OccStageResult:
        cfg = self.cfg
        eng = self.engine
        exact = cfg.occ.exact
        result = OccStageResult(mix=mix, fragmentsizes=fragmentsizes, chunks=chunks)
        writers = open_writers(out_prefix)
        tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
        self.prepare_exact(mix)
        asm = ChunkAssembler(chunks, self.track_names())
        asm.expect(tiles)

        # exact, wire v8: argmax + certified bit, CI bounds as 5-bit deltas
        # whose overflow clears the certified bit and routes the position
        # through the f64 refinisher; non-exact, wire v2: full CI indices
        # (no refinisher to fall back on)
        batches, dispatch = self._batches(frags, tiles)
        # occupancy values live on the discrete alpha grid; the wire carries
        # grid INDICES, decoded here with the f64 grid — lossless
        grid64 = mix.alpha_grid(cfg.occ)
        for batch, out in _pipelined(batches, dispatch):
            if exact:  # wire v8
                idx, cert_b = eng.decode_occ2(out)
                cert = cert_b.astype(np.float64)
            else:  # wire v2: [B, 3, core]
                idx = out.astype(np.int64) & 0x7F
            occ_b = grid64[idx[:, 0]]
            lo_b = grid64[idx[:, 1]]
            up_b = grid64[idx[:, 2]]
            for r, t in enumerate(batch.meta):
                # arrays are core-only: column 0 == t.core_start
                vals = {"occ": occ_b[r], "lower": lo_b[r], "upper": up_b[r]}
                if exact:
                    vals["cert"] = cert[r]
                for cid, chunk, tracks in asm.add(t, vals, 0):
                    if exact:
                        self._exact_refinish(chunk, tracks, frags)
                    result.peaks.extend(self._finish_chunk(chunk, tracks, writers))
                    if keep_tracks:
                        result.tracks[cid] = tracks

        for w in writers.values():
            w.close()
        return result

    def _batches(self, frags: BamFragments, tiles):
        """(batches, dispatch) of ``run`` on the stages' wire
        (``stage_wire``): the engine's named step occ_step[_<wire>]_<p2|c3>,
        as the reference's OccStage.run picks it. The frags wire packs its
        lists into ``(size << 16) | mid`` words on the host and takes the
        packed wire's step."""
        cfg, eng = self.cfg, self.engine
        wire = stage_wire(cfg)
        form = "p2" if cfg.occ.exact else "c3"
        step = getattr(eng, f"occ_step_{form}" if wire == "dense" else
                       f"occ_step_{'packed' if wire == 'frags' else wire}_{form}")

        def dispatch(b):
            if wire == "frags":
                s = np.where(b.valid, b.sizes, 0).astype(np.int32)
                m = np.where(b.valid, b.mids, 0).astype(np.int32)
                return step((s << 16) | m)
            return step(*wire_arrays(wire, b))

        return wire_batches(cfg, wire, frags, tiles, eng.width), dispatch

    def _exact_refinish(self, chunk: Chunk, tracks, frags: BamFragments) -> None:
        """Re-finish uncertified positions in float64 (DESIGN.md §4).

        Device f32 LL surfaces select the same discrete grid values as
        the f64 mirror except at near-ties; the device bounds the
        distance to the nearest tie and sets the `cert` flag when both
        the argmax and CI-boundary margins clear exact_tol
        (ops/occupancy.py :: occupancy_packed2), so certified positions
        are provably f64-equal and only the rest are recomputed here from
        raw fragment windows — integer counts, so the f64 finishing step
        is deterministic and mirror-identical."""
        cert = tracks.pop("cert")
        flagged = np.flatnonzero(cert < 0.5)
        if getattr(self, "_spot_chunks", 0) > 0:
            self._spot_chunks -= 1
            self._spot_check(chunk, tracks, frags, np.flatnonzero(cert >= 0.5))
        if len(flagged) == 0:
            return
        occ_v, lo_v, up_v = self._f64_picks(chunk, flagged, frags)
        tracks["occ"][flagged] = occ_v
        tracks["lower"][flagged] = lo_v
        tracks["upper"][flagged] = up_v

    def _f64_picks(self, chunk: Chunk, positions: np.ndarray, frags: BamFragments):
        """Float64 occ/lower/upper grid values at chunk-relative positions.
        One chunk-wide fragment fetch + vectorized per-window histograms.
        The LL is computed as `counts_f64 @ M64` — the same operation and
        summation order as the f64 mirror's per-window `cnt @ M64`, so
        grid picks stay mirror-identical."""
        cfg = self.cfg
        p0 = cfg.occ
        lower, upper = cfg.sizes.lower, cfg.sizes.upper
        S = upper - lower
        M64, grid64 = self._m64, self._grid64
        G = len(grid64)
        m, s = frags.window(
            chunk.chrom, chunk.start - p0.flank, chunk.end + p0.flank + 1
        )
        keep = (s >= lower) & (s < upper)
        m, s = m[keep], s[keep]
        pos_abs = chunk.start + positions
        lo = np.searchsorted(m, pos_abs - p0.flank)
        hi = np.searchsorted(m, pos_abs + p0.flank + 1)
        # Dedup identical fragment windows: at low coverage, runs of
        # adjacent positions see the same [lo, hi) fragment slice, so
        # compute each distinct window once and fan the picks back out.
        key = lo.astype(np.int64) * (np.int64(len(m)) + 1) + hi
        _, ui, inv = np.unique(key, return_index=True, return_inverse=True)
        lo, hi = lo[ui], hi[ui]
        tot = hi - lo
        P = len(ui)
        counts = np.zeros((P, S), np.float64)
        if tot.sum() > 0:
            rows = np.repeat(np.arange(P), tot)
            offs = np.arange(tot.sum()) - np.repeat(np.cumsum(tot) - tot, tot)
            cols = s[np.repeat(lo, tot) + offs] - lower
            np.add.at(counts, (rows, cols), 1.0)
        ll = counts @ M64  # [P, G] float64
        best = np.argmax(ll, axis=1)
        ok = ll >= (ll[np.arange(P), best] - p0.ci_drop)[:, None]
        first = np.argmax(ok, axis=1)
        last = G - 1 - np.argmax(ok[:, ::-1], axis=1)
        empty = tot == 0
        return (
            np.where(empty, 0.0, grid64[best])[inv],
            np.where(empty, 0.0, grid64[first])[inv],
            np.where(empty, 1.0, grid64[last])[inv],
        )

    def _spot_check(
        self, chunk: Chunk, tracks, frags: BamFragments, certified: np.ndarray
    ) -> None:
        """Recompute a sample of device-CERTIFIED positions in f64 and fail
        loudly if any grid pick differs — a live guard that occ.exact_tol
        still holds on THIS device."""
        if len(certified) == 0:
            return
        sample = certified[:: max(1, len(certified) // 32)][:32]
        occ_v, lo_v, up_v = self._f64_picks(chunk, sample, frags)
        for name, want in (("occ", occ_v), ("lower", lo_v), ("upper", up_v)):
            got = tracks[name][sample]
            bad = np.flatnonzero(got != want)
            if len(bad):
                i = int(bad[0])
                raise RuntimeError(
                    f"occ certification spot-check FAILED at "
                    f"{chunk.chrom}:{chunk.start + int(sample[i])} "
                    f"({name}: device {got[i]!r} != f64 {want[i]!r}). "
                    "The device f32 LL error on this device exceeds "
                    f"occ.exact_tol={self.cfg.occ.exact_tol}; re-validate "
                    "the tolerance on this device and raise exact_tol."
                )
        self.n_spot_checked += len(sample)

    def _finish_chunk(self, chunk: Chunk, tracks, writers) -> List[OccPeak]:
        peaks, payloads = self.compute_chunk(
            chunk, tracks, want_payloads=bool(writers)
        )
        self.emit_chunk(chunk, peaks, payloads, writers)
        return peaks

    def compute_chunk(self, chunk: Chunk, tracks, want_payloads):
        """Thread-safe compute phase: peak calling + pre-formatted track
        payloads; no shared mutable state."""
        from nucleoatac_torch.io.tabix import prepare_bedgraph

        cfg = self.cfg
        occ, lo, up = tracks["occ"], tracks["lower"], tracks["upper"]
        peaks_raw = call_occ_peaks(chunk, occ, lo, cfg)
        peaks = [
            OccPeak(p.chrom, p.pos, p.occ,
                    float(lo[p.pos - chunk.start]), float(up[p.pos - chunk.start]))
            for p in peaks_raw
        ]
        payloads = None
        if want_payloads:
            payloads = {
                name: prepare_bedgraph(chunk.chrom, chunk.start, arr)
                for name, arr in (("occ", occ), ("lower", lo), ("upper", up))
            }
            flank = cfg.occ.flank
            rows = []
            for p in peaks:
                s = max(0, p.pos - flank)
                e = p.pos + flank + 1
                rows.append((
                    s, e,
                    f"{p.chrom}\t{s}\t{e}\t{p.occ:.5g}\t{p.lower:.5g}\t"
                    f"{p.upper:.5g}",
                ))
            payloads["peaks"] = rows
        return peaks, payloads

    def emit_chunk(self, chunk: Chunk, peaks, payloads, writers) -> None:
        if not writers:
            return
        for name in ("occ", "lower", "upper"):
            writers[name].add_prepared(chunk.chrom, payloads[name])
        rows = payloads["peaks"]
        writers["peaks"].add_many(
            chunk.chrom, [r[0] for r in rows], [r[1] for r in rows],
            [r[2] for r in rows],
        )
