"""Per-stage device profile of TorchEngine's chain, with the wire and the
whole step beside it.

Counterpart of scripts/profile_stages.py, with the stage, wire and chain
rows of scripts/roofline.py. Each stage of one window batch is timed
alone through the engine's own stage method, its inputs resident on the
device: the stage rows sum to a figure that stands beside the whole public
step (``e2e_device``). Also timed: the per-batch upload (a distinct pinned
host buffer per iteration), the download of freshly computed outputs, and
``enqueue``, the host-clock time to enqueue one whole step without a
synchronise (if it reaches ``e2e_device``, the chain is bound by its
launches).

On a card the pool2 step is a step program (models/graphs.py): the public
step replays its CUDA graph, so ``e2e_device`` and ``enqueue`` time the
replay, and ``e2e_eager`` and ``enqueue_eager`` time the eager chain
(TorchEngine._run_pool2, the reference's step before jit) on the same
inputs; ``captures`` counts the engine's graphs. The stage rows stay
eager: they are the stage methods. On the CPU, and on the delta wire's
named steps, both forms are the eager chain and the report says so
(``step_form``).

Times on the card are CUDA events around ``iters`` launches after a
warm-up, the median of three rounds (the reference's median of three, with
events in place of block_until_ready). Each row carries its least time on
the card (``bound``): its bytes (each input read once, each output written
once, at the stage's real dtypes) over HBM's rate, against its operations
over the rate of the pipe that runs them. The FLOP model is the
reference's (``flop_model``); the xcorr kernels count their 2-D sums as
three TF32 tensor-core products per term, the torch stages run on the
FP32 pipes (TF32 is off, device.py). Elementwise stages count their bytes
only: their few operations per byte are far below the card's 20 FLOP per
byte. On the CPU the rows are host-clock times labelled "cpu", with no
bound or share.

Row sets (``--wire``):
  pool2  the main path's run_step_pool2: _raster_pool, _occ_packed2,
         _logbias_2bit, _bias, the xcorr route, _u16 of _margin, _pack_run;
  delta  the reference's own rows: _raster_delta, _occ_packed (wire v1),
         _logbias_nib, _bias, the xcorr route, _finish5 (its e2e is
         occ_step_delta_c + nuc_step_delta_seq_c, as the reference's).
The xcorr route (``--conv``): "diag" is one K2 row (_xcorr: the
reference's convs and the epilogue of its finish in one launch);
"diag_pallas" is _convs (two K1 launches and the rank-1 sums) and
_finish, with each K1 launch also timed alone (rows outside the sum);
"direct" is _convs (two conv1d) and _finish.

``--trace DIR`` takes one torch.profiler trace of 8 (replayed) steps in a
row and reads it back (read_trace): kernels per batch, the host's
cudaGraphLaunch calls, the device's busy share, the device operations
with the most time and the longest idle gaps between device operations,
each with the host op that was running then. On one card it also splits
each replay's device time by stage (``replay_stages``): three eager
steps, traced under the engine's ``engine.<stage>`` ranges
(utils/trace.py), give the step's sequence of device operations, each
with the innermost range around its launch (stage_sequence); each replay's operations, in
start order, are checked name for name against it and summed by stage,
and the operations outside the graphs are named by the span that
launched them. ``--shards 2`` runs the step sharded over two copies of
the device; the stage rows stay whole batches on the first.

Run: python3 -m nucleoatac_torch.profiling.stages [--batch 64]
[--core 1024] [--frags 2048] [--iters 20] [--wire pool2|delta]
[--conv diag|diag_pallas|direct] [--shards 1|2] [--trace DIR]
[--device cuda]
One JSON line at the end holds every number (ms per batch).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from nucleoatac_torch.device import resolve_device
from nucleoatac_torch.ops import diag_xcorr as k1
from nucleoatac_torch.ops import nuc_scores as k2
from nucleoatac_torch.ops import occ_window as k3

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
FP64_ADD_PER_S = 33.5e12 / 2  # the FP64 pipes' 33.5 TFLOP/s count an FMA as two

WIRES = ("pool2", "delta")
KERNELS = ("nuc_scores", "diag_xcorr", "occ_window")


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bound(tc_flops: float, fp32_flops: float, nbytes: float) -> dict:
    """The least time of a kernel's work on the card: the larger of its
    bytes (each input read once, each output written once) over HBM's rate
    and its operations over the rate of the pipe that runs them. The tile
    runs its 2-D sums (tc_flops) as three TF32 tensor-core products per
    term, so they count three times at the TF32 rate; the rest
    (fp32_flops) run on the FP32 pipes beside them. Also returned: the
    same work all on the FP32 pipes, the bound of an FMA tile."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(3 * tc_flops / TF32_FLOP_PER_S, fp32_flops / FP32_FLOP_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "3 TF32 tensor-core products per term at 495 TFLOP/s",
            "fp32_pipe_bound_ms": max(t_bytes, (tc_flops + fp32_flops) / FP32_FLOP_PER_S * 1e3),
            "flops": tc_flops + fp32_flops, "bytes": nbytes}


def k1_work(B: int, S: int, W: int, K: int, C: int = 2) -> tuple:
    """(tensor-core FLOPs, FP32 FLOPs, bytes) of one K1 launch: x [B, S, W]
    against C kernels [K, S] -> [B, C, W - K + 1], f32."""
    Wo = W - K + 1
    return 2.0 * B * C * S * K * Wo, 0.0, 4.0 * (B * S * W + C * K * S + B * C * Wo)


def k2_work(B: int, S: int, W: int, K: int) -> tuple:
    """(tensor-core FLOPs, FP32 FLOPs, bytes) of one K2 launch: the four
    2-D sums on the tensor cores; the four rank-1 sums and the column sums
    on the FP32 pipes; F and B0 [B, S, W], the tables and [B, 5, W] out."""
    Wo = W - K + 1
    return (2.0 * B * Wo * 4 * S * K, 2.0 * B * Wo * 4 * K + 2.0 * B * S * W,
            4.0 * (2 * B * S * W + 4 * K * S + 4 * K + 5 * B * W))


def k3_bound(B: int, G: int, W: int, core_lo: int, core: int, flank: int,
             run: int = 8) -> dict:
    """The least time of one K3 launch: the projection's core and halo
    columns and their counts read once and the wire-v8 bytes written once,
    over HBM's rate, against K3's float64 adds on the FP64 pipes. K3 sums
    runs of ``run`` positions of a grid row (G rows and the counts' row),
    whose windows of 2*flank + 1 terms share all but run - 1 terms on each
    side: the shared terms once, the others for their own positions, two
    more per position to join them. ``direct_adds`` counts the same sums
    window by window."""
    span = 2 * flank + 1
    per_run = run * (run - 1) + span - run + 1 + 2 * run if span >= run else run * span
    cols = min(W, core_lo + core + flank) - max(0, core_lo - flank)
    nbytes = 4.0 * B * (G + 1) * cols + B * (2 * core + -(-core // 4))
    adds = float(B) * (G + 1) * -(-core // run) * per_run
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, adds / FP64_ADD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "adds": adds, "direct_adds": float(B) * (G + 1) * core * span, "bytes": nbytes}


def flop_model(cfg, width: int) -> dict:
    """FLOPs per window of the reference's model (profile_stages.py): the
    occupancy einsum and window sum, the two conv stacks over every
    template tap, and the bias matrix."""
    S = cfg.sizes.upper - cfg.sizes.lower
    Sv = cfg.vmat.upper - cfg.vmat.lower
    K, G, W = cfg.vmat.width, cfg.occ.grid_size, width
    Wo = W - K + 1
    return {
        "occ_matmul": 2 * S * G * W,
        "occ_slide": (2 * cfg.occ.flank + 1) * (G + 1) * W,
        "convs_f": 2 * 5 * Sv * K * Wo,
        "convs_b": 2 * 3 * Sv * K * Wo,
        "bias_mat": 4 * Sv * W,
    }


# ---------------- inputs ---------------------------------------------------
def batch_inputs(eng, frags, tiles, codes: np.ndarray) -> dict:
    """One window batch on both wires, host arrays: the pool wire
    (pool, table, emax) and the 2-bit sequence plane (packed2, esc) of
    run_step_pool2; the delta pairs (db) and nibble codes (nib) of the
    delta steps. ``tiles`` (at most one batch) index ``frags``; ``codes``
    are their sequence-code rows."""
    from nucleoatac_torch.models.data import (
        make_delta_batches,
        make_pool_batches,
        pack_2bit_codes,
        pack_nibble_codes,
    )

    B, W = eng.cfg.window.batch, eng.width
    if not 0 < len(tiles) <= B:
        raise ValueError(f"{len(tiles)} tiles for one batch of {B}")
    # one group: every record in one pool, as a run's group holds it
    (pb,) = make_pool_batches(frags, tiles, W, B, budget=sys.maxsize)
    (dbatch,) = make_delta_batches(frags, tiles, W, B)
    packed2, esc, ok = pack_2bit_codes(codes)
    if not ok:
        raise ValueError("the batch's N bases overflow the 2-bit escape list")
    return {"pool": pb.pool, "table": pb.table, "emax": pb.emax,
            "packed2": packed2, "esc": esc, "db": dbatch.delta,
            "nib": pack_nibble_codes(codes)}


def synthetic_batch(eng, frags: int = 2048, seed: int = 1) -> dict:
    """batch_inputs of ``frags`` fragments per window drawn as the
    reference's profiler draws them (uniform midpoints, half nucleosomal
    sizes ~ N(147, 20), half 20 + Exp(45), clipped to [1, 250]) and
    uniform random sequence, one window per chunk, side by side."""
    from nucleoatac_torch.io.bam import BamFragments
    from nucleoatac_torch.models.data import TileMeta

    B, W, F = eng.cfg.window.batch, eng.width, frags
    rng = np.random.default_rng(seed)
    mids = rng.integers(0, W, size=(B, F))
    szs = np.clip(np.concatenate(
        [rng.normal(147, 20, size=(B, F // 2)),
         rng.exponential(45, size=(B, F - F // 2)) + 20], axis=1), 1, 250).astype(np.int32)
    order = np.argsort(mids, axis=1, kind="stable")
    mids = np.take_along_axis(mids, order, 1) + W * np.arange(B)[:, None]
    szs = np.take_along_axis(szs, order, 1)
    chrom = "chrS"
    bam = BamFragments([chrom], [B * W], {chrom: mids.ravel().astype(np.int64)},
                       {chrom: szs.ravel()})
    tiles = [TileMeta(b, chrom, b * W + eng.halo, b * W + eng.halo + eng.core, b * W)
             for b in range(B)]
    codes = rng.integers(0, 4, size=(B, eng.seq_codes_width())).astype(np.uint8)
    return batch_inputs(eng, bam, tiles, codes)


def dataset_batch(eng, bam: str, bed: str, fasta: str) -> dict:
    """batch_inputs of a dataset's first window batch: the windows of a
    run's first dispatch on it."""
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.io.fasta import FastaFile
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.models.nuc import SeqCodesProvider

    cfg, B = eng.cfg, eng.cfg.window.batch
    frags = scan_bam(bam, cfg.ingest)
    chunks = ChunkList.read(bed, frags.chrom_dict).merge()
    tiles = tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)[:B]
    codes = SeqCodesProvider(FastaFile(fasta), chunks, eng, B).rows(tiles)
    return batch_inputs(eng, frags, tiles, codes)


# ---------------- rows -----------------------------------------------------
def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(a) for a in x)
    return int(x)  # a byte count


@dataclass
class Row:
    """One timed stage: ``fn()`` recomputes ``out`` from resident inputs."""
    name: str
    fn: Callable[[], object]
    out: object
    nbytes: int  # inputs read once + outputs written once
    tc_flops: float = 0.0
    fp32_flops: float = 0.0
    in_sum: bool = True
    per_call: tuple = (0, 0, 0)  # (K2, K1, K3) launches per call on the card
    note: str = ""


def _row(name, fn, reads, tc=0.0, fp32=0.0, in_sum=True, per_call=(0, 0, 0), note=""):
    out = fn()
    return Row(name, fn, out, _nbytes(reads) + _nbytes(out), tc, fp32, in_sum,
               per_call, note)


def resident(eng, batch: dict) -> dict:
    """The batch's arrays as tensors on the engine's first device (emax
    stays an int)."""
    return {k: v if isinstance(v, int) else torch.from_numpy(np.ascontiguousarray(v))
            .to(eng.device) for k, v in batch.items()}


def stage_rows(eng, batch: dict, wire: str = "pool2") -> list:
    """The stage rows of one resident batch on ``wire``'s row set, each
    computed once in chain order (a row's ``out`` is the next row's
    input), so composing the outputs is the chain. Whole batches on the
    engine's first device."""
    if wire not in WIRES:
        raise ValueError(f"wire={wire!r}; expected one of {WIRES}")
    cfg, t = eng.cfg, resident(eng, batch)
    B, W = cfg.window.batch, eng.width
    S = cfg.sizes.upper - cfg.sizes.lower
    fm = flop_model(cfg, W)
    tab = eng.tables
    f2d, f1d, b2d, b1d = tab["_diag_kernels"]
    K = f2d.shape[1]
    rows = []
    if wire == "pool2":
        # the pool's records this batch reads: 1.5 bytes each (nibble and
        # size planes), as the table counts them
        recs = int(batch["table"][:, 1].astype(np.int64).sum()) * 3 // 2
        rows.append(_row("_raster_pool",
                         lambda: eng._raster_pool(t["pool"], t["table"], t["emax"]),
                         (t["table"], recs), note="pool records -> f32 counts"))
    else:
        rows.append(_row("_raster_delta", lambda: eng._raster_delta(t["db"]), t["db"],
                         note="delta pairs -> f32 counts"))
    mat = rows[-1].out
    occ = "_occ_packed2" if wire == "pool2" else "_occ_packed"
    rows.append(_row(occ, lambda: getattr(eng, occ)(mat), (mat, tab["log_mix"]),
                     fp32=B * (fm["occ_matmul"] + fm["occ_slide"]),
                     per_call=(0, 0, int(wire == "pool2")),
                     note=f"LL SGEMM over {S} sizes, window sum, picks"
                     + (" (K3)" if wire == "pool2" else "")))
    L = tab["pwm_log_ratio"].shape[1]
    if wire == "pool2":
        rows.append(_row("_logbias_2bit",
                         lambda: eng._logbias_2bit(t["packed2"], t["esc"]),
                         (t["packed2"], t["esc"], tab["pwm_log_ratio"]), fp32=B * W * L))
    else:
        rows.append(_row("_logbias_nib", lambda: eng._logbias_nib(t["nib"]),
                         (t["nib"], tab["pwm_log_ratio"]), fp32=B * W * L))
    logb = rows[-1].out
    rows.append(_row("_bias", lambda: eng._bias(logb), (logb, tab["size_probs"]),
                     fp32=B * fm["bias_mat"]))
    b0 = rows[-1].out
    fmat = eng._fmat(mat)
    Sv = fmat.shape[1]
    kernels = (f2d, f1d, b2d, b1d)
    if eng.conv == "diag" or eng.use_pallas:
        tc, fp32, _ = k2_work(B, Sv, W, K)
        rows.append(_row("_xcorr", lambda: eng._xcorr(mat, b0), (fmat, b0, kernels),
                         tc=tc, fp32=fp32, per_call=(1, 0, 0),
                         note="K2: the 8 footprint sums and the epilogue"))
    else:
        if eng.conv == "diag_pallas":
            tc1, _, _ = k1_work(B, Sv, W, K)
            Wo = W - K + 1
            convs = _row("_convs", lambda: eng._convs(mat, b0), (fmat, b0, kernels),
                         tc=2 * tc1, fp32=2.0 * B * Wo * 4 * K + 2.0 * B * Sv * W,
                         per_call=(0, 2, 0), note="two K1 launches and the rank-1 sums")
            rows.append(convs)
            for name, x, k2d in (("K1 F", fmat, f2d), ("K1 B0", b0, b2d)):
                rows.append(_row(name, lambda x=x, k2d=k2d: k1.diag_xcorr(x, k2d),
                                 (x, k2d), tc=tc1, in_sum=False, per_call=(0, 1, 0),
                                 note="one K1 launch alone (inside _convs)"))
        else:
            convs = _row("_convs", lambda: eng._convs(mat, b0),
                         (fmat, b0, tab["f_kernels"], tab["b_kernels"]),
                         fp32=B * (fm["convs_f"] + fm["convs_b"]),
                         note="two float32 conv1d")
            rows.append(convs)
        fo, bo = convs.out
        rows.append(_row("_finish", lambda: eng._finish(fo, bo), (fo, bo),
                         note="padding and the norm/lr/fuzz epilogue"))
    scores = rows[-1].out
    if wire == "pool2":
        rows.append(_row("_u16", lambda: eng._u16(eng._margin(scores[0])),
                         eng._margin(scores[0]), note="margin slice, u16 quantization"))
        occ2, u16 = rows[1].out, rows[-1].out
        rows.append(_row("_pack_run", lambda: eng._pack_run(occ2, u16), (occ2, u16)))
    else:
        ks = len(eng.smooth_kernel)
        rows.append(_row("_finish5", lambda: eng._finish5(scores), scores[:4],
                         fp32=2.0 * B * W * ks, note="smooth and the [B, 5, W] stack"))
    return rows


def composed(rows: list, wire: str = "pool2"):
    """The chain's output composed from the stage rows: run_step_pool2's
    bytes (pool2), or (occ_step_delta_c, nuc_step_delta_seq_c) (delta)."""
    return rows[-1].out if wire == "pool2" else (rows[1].out, rows[-1].out)


def step_fn(eng, batch: dict, wire: str = "pool2", eager: bool = False):
    """The whole public step on the batch, inputs resident on the first
    device (the pool replicated to every shard once, as a run uploads it
    once per group). With ``eager``, pool2's step runs the eager chain
    (_run_pool2, sharded as the step shards it) in place of its step
    program; the delta wire's named steps are eager either way."""
    from nucleoatac_torch.models.engine import Escapes

    t = resident(eng, batch)
    if wire == "pool2":
        pool = eng.replicate(batch["pool"]) if len(eng.devices) > 1 else t["pool"]
        if eager:
            esc = Escapes(t["esc"], eng.seq_codes_width())
            return lambda: eng.shard(eng._run_pool2, pool, t["table"], t["packed2"], esc,
                                     t["emax"])
        return lambda: eng.run_step_pool2(pool, t["table"], t["packed2"], t["esc"],
                                          t["emax"])
    return lambda: (eng.occ_step_delta_c(t["db"]), eng.nuc_step_delta_seq_c(t["db"], t["nib"]))


# ---------------- timing ---------------------------------------------------
def _launches() -> Counter:
    return Counter({"nuc_scores": k2.LAUNCHES, "diag_xcorr": k1.LAUNCHES,
                    "occ_window": k3.LAUNCHES})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(run, n: int, dev: torch.device) -> float:
    """ms per item of ``run()``, which does ``n`` items: CUDA events on
    ``dev``'s current stream on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(stream)
        run()
        e1.record(stream)
        e1.synchronize()
        return e0.elapsed_time(e1) / n
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3 / n


def time_ms(fn, iters: int, dev: torch.device, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean time of ``iters`` calls in a row,
    after one warm-up call (1 + rounds * iters calls)."""
    def loop():
        for _ in range(iters):
            fn()

    fn()
    _sync(dev)
    return statistics.median(_timed(loop, iters, dev) for _ in range(rounds))


def enqueue_ms(fn, iters: int, dev: torch.device, rounds: int = 3) -> float:
    """Median host-clock time to enqueue one call, ``iters`` calls in a row
    from an idle device, with no synchronise inside the timed loop (as
    many calls as time_ms)."""
    fn()
    _sync(dev)
    runs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
        _sync(dev)
    return statistics.median(runs)


def _host_copies(arrays, n: int, pin: bool) -> list:
    """``n`` distinct host copies of ``arrays`` (pinned for a card)."""
    def copy(a):
        h = torch.from_numpy(np.array(a, copy=True))
        return h.pin_memory() if pin else h
    return [[copy(a) for a in arrays] for _ in range(n)]


def upload_ms(arrays, iters: int, dev: torch.device) -> float:
    """Per-batch upload of ``arrays``: a distinct host buffer each
    iteration, copied to ``dev`` without blocking."""
    bufs = _host_copies(arrays, iters, dev.type == "cuda")
    nxt = itertools.cycle(bufs).__next__
    return time_ms(lambda: [b.to(dev, non_blocking=True) for b in nxt()], iters, dev)


def download_ms(step, iters: int, dev: torch.device, rounds: int = 3) -> float:
    """Download of freshly computed step outputs into pinned host buffers:
    each round computes ``iters`` outputs, waits for them, then times
    their copies (the first round warms up)."""
    runs = []
    for _ in range(rounds + 1):
        outs = [step() for _ in range(iters)]
        outs = [o for x in outs for o in (x if isinstance(x, tuple) else (x,))]
        hosts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=dev.type == "cuda")
                 for o in outs]
        _sync(dev)
        runs.append(_timed(lambda: [h.copy_(o, non_blocking=True)
                                    for o, h in zip(outs, hosts)], iters, dev))
    return statistics.median(runs[1:])


# ---------------- trace ----------------------------------------------------
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _trace_events(path: str) -> list:
    """The complete ("X") events of a chrome trace, with t0 and t1 (us)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    for e in events:
        e["t0"], e["t1"] = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return events


def _corr(e):
    return e.get("args", {}).get("correlation")


def _launch_calls(events: list) -> dict:
    """{correlation id: the runtime call (a kernel launch, a copy, a graph
    launch) that carries it}."""
    return {_corr(e): e for e in events
            if e.get("cat") in RUNTIME_CATS and _corr(e) is not None}


def _innermost(events: list, names, cats) -> Callable:
    """A function of a time (us): the shortest host event of ``cats``
    whose name passes ``names`` and which covers that time, or None."""
    host = [e for e in events if e.get("cat") in cats and names(e["name"])]

    def at(t):
        cover = [e for e in host if e["t0"] <= t <= e["t1"]]
        return min(cover, key=lambda e: e["dur"]) if cover else None
    return at


def _launcher(events: list, names, cats=("user_annotation",)) -> Callable:
    """A function of a device op: the innermost host event of ``cats``
    whose name passes ``names`` and which covers the op's launch call
    (found through its correlation id), or None."""
    launch, at = _launch_calls(events), _innermost(events, names, cats)

    def by(op):
        call = launch.get(_corr(op))
        return at(call["t0"]) if call else None
    return by


def _not_step(name: str) -> bool:
    """Not the profiler's own step span, which covers the whole window."""
    return not name.startswith("ProfilerStep#")


def read_trace(path: str, n_batches: int, device_type: str = "cuda",
               n_gaps: int = 5) -> dict:
    """Summary of a torch.profiler chrome trace of ``n_batches`` steps:
    kernels per batch, the host's cudaGraphLaunch calls and the kernels
    each one ran (by its correlation id: a replay whose kernel records were
    lost shows fewer than the others), the device's busy
    share (the union of its operations' intervals over their span, first
    start to last end), the count of each kernel name, and the ``n_gaps``
    longest idle gaps between device operations. Each gap names the host op running at its
    midpoint (None: Python between ops), the device op that ended it, the
    host op that launched that one (through the launch's correlation id)
    and how long before the gap's end the launch call began: a launch
    that starts inside the gap means the device waited for the host. On
    the CPU the aten ops stand for the device operations."""
    events = _trace_events(path)
    dev_cats = DEVICE_CATS if device_type == "cuda" else ("cpu_op",)
    dev = sorted((e for e in events if e.get("cat") in dev_cats), key=lambda e: e["t0"])
    if not dev:
        raise ValueError(f"{path}: no device operations ({'/'.join(dev_cats)})")
    union = [[dev[0]["t0"], dev[0]["t1"], dev[0]]]  # [start, end, first op]
    for e in dev[1:]:
        if e["t0"] <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e["t1"])
        else:
            union.append([e["t0"], e["t1"], e])
    t0, t1 = union[0][0], union[-1][1]
    busy = sum(b - a for a, b, _ in union)
    # the profiler's own step span covers the whole window: it names no gap
    host = _innermost(events, _not_step, HOST_CATS)
    launch = _launch_calls(events)

    def name(t):
        e = host(t)
        return e and e["name"]

    def gap(prev, nxt):
        a, b, op = prev[1], nxt[0], nxt[2]
        call = launch.get(_corr(op))
        return {"ms": (b - a) / 1e3, "at_ms": (a - t0) / 1e3,
                "host": name((a + b) / 2), "next_op": op["name"][:80],
                "launched_by": name(call["t0"]) if call else None,
                "launch_before_end_ms": (b - call["t0"]) / 1e3 if call else None}

    gaps = sorted(zip(union, union[1:]), key=lambda p: p[0][1] - p[1][0])[:n_gaps]
    kernel_cats = ("kernel",) if device_type == "cuda" else ("cpu_op",)
    names = Counter(e["name"] for e in events if e.get("cat") in kernel_cats)
    graph_calls = sorted((e for e in events if e.get("cat") in RUNTIME_CATS
                          and "cudaGraphLaunch" in e["name"]), key=lambda e: e["t0"])
    per_call = Counter(e.get("args", {}).get("correlation") for e in events
                       if e.get("cat") in kernel_cats)
    return {
        "batches": n_batches, "span_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
        "busy_share": busy / (t1 - t0) if t1 > t0 else 1.0,
        "device_ops": len(dev), "kernels_per_batch": sum(names.values()) / n_batches,
        "graph_launches": len(graph_calls),
        "replay_kernels": [per_call[e.get("args", {}).get("correlation")]
                           for e in graph_calls],
        "kernel_counts": dict(names.most_common()),
        "gaps": [gap(p, q) for p, q in gaps], "trace": path,
    }


NO_STAGE = "(no stage)"


EAGER_STEP = "stages.eager_step"


def stage_sequence(path: str) -> list:
    """[(device op name, stage)] of a traced eager step, in start order:
    each kernel, copy and set with the innermost ``engine.<stage>`` range
    around its launch (NO_STAGE outside every range). A trace of several
    steps, each inside an EAGER_STEP range, gives the sequence most of
    them show: the first step after the profiler attaches can lose a
    record."""
    events = _trace_events(path)
    stage = _launcher(events, lambda n: n.startswith("engine."))
    step = _launcher(events, lambda n: n == EAGER_STEP)
    steps: dict = {}  # the step range's start (None: outside every one) -> ops
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["t0"]):
        st, sp = stage(e), step(e)
        steps.setdefault(sp and sp["t0"], []).append((e["name"], st["name"] if st else NO_STAGE))
    return list(Counter(tuple(v) for v in steps.values()).most_common(1)[0][0])


def replay_stages(path: str, sequence: list, n_batches: int) -> dict:
    """Device ms per stage of each replay in a trace of ``n_batches``
    replayed steps, against the eager step's ``sequence``
    (stage_sequence). A replay's device ops are those its
    cudaGraphLaunch's correlation id names, in start order; a replay with
    fewer than the sequence lost records (``lost``), one whose names
    differ is ``mismatched`` (the first difference); only the others
    (``matched``) are summed. ``stages_ms``: the mean per matched replay
    of each stage, in the sequence's order; ``stage_sum_ms`` the sum of
    the named stages (NO_STAGE left out) and ``replay_ms`` the mean of the
    replays' own op times, so that ops no range launched show as their
    difference (replay_stages_fault); ``top_ops``
    the 12 (stage, op name, ms per replay) with the most time. ``outside``:
    ms per batch of the device ops of no graph, by the innermost span
    (a user annotation) around their launch, else the innermost host op,
    else "python"."""
    events = _trace_events(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    graph_calls = sorted((e for e in events if e.get("cat") in RUNTIME_CATS
                          and "cudaGraphLaunch" in e["name"]), key=lambda e: e["t0"])
    in_graph = {_corr(g): [] for g in graph_calls}
    outside_ops = []
    for e in sorted(dev, key=lambda e: e["t0"]):
        (in_graph[_corr(e)] if _corr(e) in in_graph else outside_ops).append(e)
    names = [n for n, _ in sequence]
    order = list(dict.fromkeys(st for _, st in sequence))
    sums = dict.fromkeys(order, 0.0)
    by_op: dict = {}
    replay_us, matched, lost, mismatched = 0.0, 0, [], []
    for i, g in enumerate(graph_calls):
        ops = in_graph[_corr(g)]
        got = [e["name"] for e in ops]
        if len(got) < len(names):
            lost.append({"replay": i, "ops": len(got)})
            continue
        if got != names:
            at = next((j for j, (a, b) in enumerate(zip(got, names)) if a != b), len(names))
            mismatched.append({"replay": i, "ops": len(got), "at": at,
                               "want": names[at][:80] if at < len(names) else None,
                               "got": got[at][:80]})
            continue
        matched += 1
        for e, (name, st) in zip(ops, sequence):
            sums[st] += e["dur"]
            by_op[st, name[:80]] = by_op.get((st, name[:80]), 0.0) + e["dur"]
        replay_us += sum(e["dur"] for e in ops)
    per = 1e3 * max(matched, 1)  # us summed over matched replays -> ms per replay
    span_of, op_of = _launcher(events, _not_step), _launcher(events, _not_step, HOST_CATS)
    outside: dict = {}
    for e in outside_ops:
        name = (span_of(e) or op_of(e) or {"name": "python"})["name"]
        outside[name] = outside.get(name, 0.0) + e["dur"] / 1e3 / n_batches
    return {"replays": len(graph_calls), "matched": matched, "ops": len(sequence),
            "stages_ms": {k: v / per for k, v in sums.items()},
            "stage_sum_ms": sum(v for k, v in sums.items() if k != NO_STAGE) / per,
            "replay_ms": replay_us / per,
            "top_ops": [[st, name, us / per] for (st, name), us in
                        sorted(by_op.items(), key=lambda kv: -kv[1])[:12]],
            "lost": lost, "mismatched": mismatched,
            "outside": dict(sorted(outside.items(), key=lambda kv: -kv[1]))}


def replay_stages_fault(rs, n_batches: int, tol: float = 0.01):
    """What is wrong with a replay_stages report of ``n_batches`` traced
    replays, or None: no report, a replay that lost records or does not
    match the eager step, fewer matched replays than batches, or named
    stages that miss the replays' device time by more than ``tol`` (ops
    that no ``engine.<stage>`` range launched)."""
    if rs is None:
        return "no replay_stages"
    if rs["lost"] or rs["mismatched"] or rs["matched"] != n_batches:
        return (f"{rs['matched']} of {n_batches} replays match; lost {rs['lost']}, "
                f"mismatched {rs['mismatched']}")
    if abs(rs["stage_sum_ms"] - rs["replay_ms"]) > tol * rs["replay_ms"]:
        return (f"the named stages sum to {rs['stage_sum_ms']:.4f} ms of the replay's "
                f"{rs['replay_ms']:.4f} ms ({NO_STAGE} "
                f"{rs['stages_ms'].get(NO_STAGE, 0.0):.4f} ms)")
    return None


def named_count(summary: dict, name: str) -> int:
    """Launches of kernels whose name contains ``name`` in a read_trace
    summary."""
    return sum(c for k, c in summary["kernel_counts"].items() if name in k)


def trace_steps(step, n: int, dev: torch.device, trace_dir: str, tag: str) -> dict:
    """One torch.profiler trace (CPU, and CUDA on a card) of ``n`` steps
    in a row after a warm-up, written to ``trace_dir``; read_trace's
    summary plus the 8 ops with the most (device) self time. The warm-up
    step runs in the profiler's own warm-up phase, traced and dropped:
    the first graph replay that CUPTI sees after it attaches can lose
    kernel records."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        step()
        _sync(dev)
        prof.step()  # the record window opens here, on an idle card
        for _ in range(n):
            step()
        _sync(dev)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"stages_{tag}.pt.trace.json")
    prof.export_chrome_trace(path)
    summary = read_trace(path, n, dev.type)

    def self_us(e):
        if dev.type != "cuda":
            return e.self_cpu_time_total
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    top = sorted((e for e in prof.key_averages() if self_us(e) > 0), key=self_us,
                 reverse=True)[:8]
    summary["top_ops"] = [{"name": e.key, "ms_per_batch": self_us(e) / 1e3 / n,
                           "calls_per_batch": e.count / n} for e in top]
    return summary


# ---------------- the profile ----------------------------------------------
def profile_stages(eng, batch: dict, wire: str = "pool2", iters: int = 20,
                   trace_dir: str | None = None, trace_batches: int = 8) -> dict:
    """Every row of ``wire``'s set on one batch (batch_inputs' arrays), the
    whole step, the wire and the enqueue, and with ``trace_dir`` a trace
    of ``trace_batches`` steps. Raises if the composed stage outputs
    differ from the step's bytes, or, on the card, if a row launched its
    kernels other than ``per_call`` times per call (the step rows: once
    per shard). Returns the report (ms per batch)."""
    dev, shards = eng.device, len(eng.devices)
    cuda = dev.type == "cuda"
    rows = stage_rows(eng, batch, wire)
    step, eager = step_fn(eng, batch, wire), step_fn(eng, batch, wire, eager=True)
    step()  # a step program's first call captures it: the next one replays
    want, got = composed(rows, wire), step()
    pairs = list(zip(want if isinstance(want, tuple) else (want,),
                     got if isinstance(got, tuple) else (got,)))
    same = all(torch.equal(a, b) for a, b in pairs)
    if not same:
        where = [(a != b).nonzero().tolist()[:8] for a, b in pairs]
        raise RuntimeError(f"profile: the composed {wire} stages differ from the step's "
                           f"bytes at (window, column) {where}")
    k3 = shards if wire == "pool2" else 0  # wire v8 occ: one K3 launch per shard
    steps_per_call = ((shards, 0, k3) if eng.conv == "diag" or eng.use_pallas
                      else (0, 2 * shards, k3))
    calls = 1 + 3 * iters  # time_ms and enqueue_ms
    report_rows = {}

    def check(name, launched, per_call):
        if cuda and any(launched.get(k, 0) != n * calls for k, n in zip(KERNELS, per_call)):
            raise RuntimeError(f"profile: row {name} launched {launched} in "
                               f"{calls} calls; expected {per_call} per call")

    def add(name, ms, nbytes, flops=0.0, in_sum=False, note="", per_call=None, launched=None,
            bd=None):
        r = {"ms": ms, "bytes": nbytes, "flops": flops, "in_sum": in_sum, "note": note}
        if per_call is not None:
            r["calls"] = calls
            r["launches"] = {k: launched.get(k, 0) for k in KERNELS}
            check(name, r["launches"], per_call)
        if cuda and bd is not None:
            r.update(bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                     share=bd["bound_ms"] / ms)
        report_rows[name] = r

    def counted(timer, fn):
        before = _launches()
        ms = timer(fn, iters, dev)
        return ms, dict(_launches() - before)

    for row in rows:
        ms, launched = counted(time_ms, row.fn)
        add(row.name, ms, row.nbytes, row.tc_flops + row.fp32_flops, row.in_sum, row.note,
            row.per_call, launched, bound(row.tc_flops, row.fp32_flops, row.nbytes))
    summed = [r for r in report_rows.values() if r["in_sum"]]
    stage_sum = sum(r["ms"] for r in summed)
    replays = eng.programs.replays
    ms, launched = counted(time_ms, step)
    replayed = eng.programs.replays > replays
    # the chain's least time: the sum of its stages' bounds
    chain = {"bound_ms": sum(r["bound_ms"] for r in summed), "bound_by": "the stages' sum"} \
        if cuda else None
    add("e2e_device", ms, sum(r["bytes"] for r in summed), sum(r["flops"] for r in summed),
        note="the whole public step, inputs resident", per_call=steps_per_call,
        launched=launched, bd=chain)
    ms, launched = counted(enqueue_ms, step)
    add("enqueue", ms, 0, note="host clock to enqueue one step, no synchronise",
        per_call=steps_per_call, launched=launched)
    eager_ms = {}
    for name, timer in (("e2e_eager", time_ms), ("enqueue_eager", enqueue_ms)):
        eager_ms[name], launched = counted(timer, eager)
        check(name, launched, steps_per_call)
    ups = ([batch[k] for k in ("table", "packed2", "esc")] if wire == "pool2"
           else [batch["db"], batch["nib"]])
    add("upload", upload_ms(ups, iters, dev), sum(a.nbytes for a in ups),
        note="per-batch arrays, a distinct pinned buffer each"
        + ("; the pool goes up once per group" if wire == "pool2" else ""))
    add("download", download_ms(step, iters, dev), _nbytes(got),
        note="freshly computed outputs into pinned buffers")
    for name in ("upload", "download"):  # the wire's rate
        r = report_rows[name]
        r["GB_per_s"] = r["bytes"] / r["ms"] / 1e6
    e2e = report_rows["e2e_device"]["ms"]
    report = {
        "profile": "stages", "device": dev.type, "wire": wire, "conv": eng.conv,
        "shards": shards, "devices": [str(d) for d in eng.devices],
        "B": eng.cfg.window.batch, "W": eng.width, "iters": iters,
        "card": smi() if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "flop_model_per_window": flop_model(eng.cfg, eng.width),
        "rows": report_rows, "stage_sum_ms": stage_sum, "e2e_device_ms": e2e,
        "sum_over_e2e": stage_sum / e2e, "enqueue_ms": report_rows["enqueue"]["ms"],
        "launch_bound": report_rows["enqueue"]["ms"] >= e2e,
        "composed_equal": same, "out_bytes": _nbytes(got),
        "step_form": "replayed CUDA graph" if replayed else "eager",
        "e2e_eager_ms": eager_ms["e2e_eager"], "enqueue_eager_ms": eager_ms["enqueue_eager"],
        "captures": eng.programs.captures, "replays": eng.programs.replays,
        "graph_pool_bytes": eng.programs.pool_bytes,
    }
    if trace_dir:
        tag = f"{wire}_{eng.conv}_x{shards}"
        report["trace"] = trace_steps(step, trace_batches, dev, trace_dir, tag)
        if replayed and shards == 1:
            from torch.profiler import record_function

            def marked():
                with record_function(EAGER_STEP):
                    return eager()

            seq = stage_sequence(trace_steps(marked, 3, dev, trace_dir, tag + "_eager")["trace"])
            report["replay_stages"] = replay_stages(report["trace"]["trace"], seq,
                                                    trace_batches)
    return report


def format_report(rep: dict) -> str:
    """The rows as a table (``*``: outside the stage sum), then the sums,
    and the trace's summary."""
    B = rep["B"]
    lines = [f"# {rep['device']} {rep['card'] or ''} wire={rep['wire']} conv={rep['conv']} "
             f"shards={rep['shards']} B={B} W={rep['W']} iters={rep['iters']}",
             f"{'row':>14} {'ms/batch':>9} {'us/win':>8} {'MB':>8} {'GFLOP':>7} "
             f"{'bound_ms':>9} {'share':>6}  launches  note"]
    for name, r in rep["rows"].items():
        if "GB_per_s" in r:
            b = f"{r['GB_per_s']:9.2f} {'GB/s':>6}"
        elif "bound_ms" in r:
            b = f"{r['bound_ms']:9.4f} {r['share']:6.1%}"
        else:
            b = f"{'-':>9} {'-':>6}"
        lines.append(f"{name + ('' if r['in_sum'] else ' *'):>14} {r['ms']:9.4f} "
                     f"{r['ms'] / B * 1e3:8.2f} {r['bytes'] / 1e6:8.2f} "
                     f"{r['flops'] / 1e9:7.2f} {b}  {r.get('launches', '-')}  {r['note']}")
    lines.append(f"# stage sum {rep['stage_sum_ms']:.4f} ms/batch vs e2e_device "
                 f"{rep['e2e_device_ms']:.4f} ms/batch (ratio {rep['sum_over_e2e']:.3f}); "
                 f"enqueue {rep['enqueue_ms']:.4f} ms/batch: "
                 f"{'bound by launches' if rep['launch_bound'] else 'below e2e_device'}")
    lines.append(f"# step form: {rep['step_form']}; the eager chain e2e "
                 f"{rep['e2e_eager_ms']:.4f} ms/batch, enqueue {rep['enqueue_eager_ms']:.4f} "
                 f"ms/batch; {rep['captures']} captures, graph pools "
                 f"{rep['graph_pool_bytes'] / 1e6:.1f} MB")
    tr = rep.get("trace")
    if tr:
        lines.append(f"# trace of {tr['batches']} batches: {tr['kernels_per_batch']:.1f} "
                     f"kernels/batch, {tr['graph_launches']} cudaGraphLaunch calls, busy "
                     f"{tr['busy_share']:.1%} of {tr['span_ms']:.3f} ms")
        for op in tr["top_ops"]:
            lines.append(f"#   {op['ms_per_batch']:8.4f} ms/batch {op['calls_per_batch']:5.1f}x "
                         f"{op['name'][:90]}")
        for g in tr["gaps"]:
            lines.append(f"#   gap {g['ms']:.4f} ms at {g['at_ms']:.3f} ms: host in "
                         f"{g['host']}; ended by {g['next_op'][:40]} launched by "
                         f"{g['launched_by']} {g['launch_before_end_ms']} ms before")
    rs = rep.get("replay_stages")
    if rs:
        lines.append(f"# replay by stage: {rs['matched']} of {rs['replays']} replays match the "
                     f"eager step's {rs['ops']} device ops (lost {len(rs['lost'])}, mismatched "
                     f"{len(rs['mismatched'])}); named stages {rs['stage_sum_ms']:.4f} ms of "
                     f"{rs['replay_ms']:.4f} ms per replay")
        for name, ms in rs["stages_ms"].items():
            lines.append(f"#   {ms:8.4f} ms/replay  {name}")
        for st, name, ms in rs["top_ops"]:
            lines.append(f"#   {ms:8.4f} ms/replay  {st}: {name[:70]}")
        for name, ms in rs["outside"].items():
            lines.append(f"#   {ms:8.4f} ms/batch outside the graph, launched in {name}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--core", type=int, default=1024)
    ap.add_argument("--frags", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--wire", choices=WIRES, default="pool2")
    ap.add_argument("--conv", choices=("diag", "diag_pallas", "direct"), default="diag")
    ap.add_argument("--shards", type=int, choices=(1, 2), default=1)
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nucleoatac_torch.entry import _tiny_engine

    dev = resolve_device(args.device)
    _, eng = _tiny_engine(core=args.core, batch=args.batch, device=[dev] * args.shards,
                          conv=args.conv)
    rep = profile_stages(eng, synthetic_batch(eng, args.frags), args.wire, args.iters,
                         args.trace)
    print(format_report(rep))
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
