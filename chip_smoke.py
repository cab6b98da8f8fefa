#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (one line each; any failure raises and the script exits nonzero):
  1. device   — CUDA present; the card's name and power limit.
  2. build    — compile the CUDA kernels from nucleoatac_torch/csrc and
                print ptxas's registers, stack and spills per kernel.
  3. K1       — diag_xcorr kernel vs its plain version at production shape
                (rtol 1e-4, atol 1e-4) and float64; timed in turns with
                the plain version and cuDNN's conv1d (the same function,
                TF32 off; a yardstick the port never calls), beside its
                bound (three TF32 tensor-core products per term) and the
                card's name and power limit. A 401-tap template against
                the plain version; a 673-tap one (past the shared memory)
                must raise. Where a `git archive` of the parent commit is
                unpacked under build/parent, its K1 is built beside this
                one, must give the same bits, and is timed in turns.
  4. K2       — nuc_scores kernel vs its plain version and a float64
                evaluation at production shape: max |norm - f64| within
                NucParams.exact_tol; against the plain version norm within
                exact_tol, signal, lr and fuzz within
                parity.NONEXACT_STAT_TOL's bars, n equal. The f64 bar again
                at 10, 40 and 100 times the fragments per window, and the
                plain bars with templates zero-padded to 401 taps. Timed
                like K1; its yardstick is one grouped cuDNN conv1d over
                [F; B0], which computes the four 2-D sums only. The F
                slabs each launch took on the list and the band products
                (the slab counters), at the base batch and each coverage,
                with K2's time beside the parent's K2 (build/parent, as
                K1); then the density sweep that sets the crossover
                (kSparseMax): two variants of this K2, every slab on the
                list and every slab on the band products, and the build's
                own, timed in turns at 14 densities of F.
  4b. LL      — occupancy log-likelihood vs float64 at production shape
                (max |LL - f64| must stay within OccParams.exact_tol).
  4c. OCC     — K3 (occ_window: the f64 window sums, picks and wire-v8
                pack in one launch) against its plain version on the same
                projection and column counts at production shape: equal
                bytes; timed in turns with the plain version (CUDA events,
                2 warm-ups, mean of 20), alone and with the SGEMM before it
                (occupancy_packed2 against its torch form), beside its
                bound (the projection's core and halo read once, K3's f64
                adds on the FP64 pipes).
  4d. BIAS    — K4 (bias_mat: the bias matrix B0 in one launch) against its
                plain version at production shape: the raw terms bit-equal
                (an empty core and q = 1), B0 within 4 ulps of the plain
                arithmetic with a float64 core sum (K4's), and of the plain
                version but for what its float32 core sums move it; the same
                bytes on two launches; timed in turns with the plain version
                (CUDA events, 2 warm-ups, mean of 20), beside its bound (B0
                written once).
  5. run      — nucleoatac_torch run_pipeline on the card with the default
                RunConfig on synthetic data (1,000 peaks); K2 launches ==
                K3 launches == K4 launches == nuc batches (each replay of a fused step's
                CUDA graph counts the launches its capture recorded); the
                run's loop record reads K2's slab counters, which the
                replays add to on the card: sparse + dense == every slab
                of every batch. Every fused step of every later phase
                replays its graph.
  5b. devices — the one-process multi-device run: run_pipeline with the
                default RunConfig on phase 5's dataset, each batch of 64
                windows sharded over every visible card ("cuda"), or over
                two shards of 32 on cuda:0 where the machine has one card:
                all ten files byte-equal to phase 5's, K2 launches ==
                shards x phase 5's nuc batches; the first batch's device
                chain, inputs resident, timed whole on the first card and
                sharded (equal bytes). Then conv="diag_pallas" at
                make_example size sharded against one card: bytes equal,
                K1 launches == 2 x shards x batches. Phase 5 and every
                later phase pass one explicit card (CARD).
  5c. tracks  — the float-track step API at full width: the first two
                batches of phase 5's windows on the frags wire
                ([64, 251, 1536] rasters) through phase 5's engine
                (full_step_frags): NucTracks.norm bit-equal to the run
                path's f32 norm (the pool wire's raster, the same K2
                launch), within nuc.exact_tol of float64 on one batch;
                OccTracks occ/lower/upper equal to run_step_pool2's picks
                wherever both certify; one K2 launch per call. Then
                sharded_full_step over every visible card, or [cuda:0,
                cuda:0]: every field bit-equal to one device, K2 launches
                == shards x calls; dryrun_multichip over the same devices
                (K2 once, K1 twice per shard; norm within 1e-3 of the f64
                mirror; then the chained run_step_delta12 at core 1024
                sharded against one card, grid indices within 1, pool and
                pool2 bytes equal to it; K2 4 x shards + 1 in all).
                full_step_frags and run_step_pool2 timed per batch, inputs
                resident.
  5d. forms   — the rest of the reference's step API at full width: phase
                5's first two batches on every wire (delta, delta12,
                packed, frags, dense, pool). Every named download step
                (occ _c, _c3, _p2; nuc _m, _m16, _m24, _c2, _c) and
                run_step_delta/run_step_delta12 on the card, held on the
                first batch against a CPU engine at the CPU tests' bars;
                on the card delta12 == delta == pool == pool2 bytes, _m24
                within 2^-16 relative of _m, v1 _c picks equal to v8's
                where both certify, K2 launches == nuc calls; a
                diag_pallas engine: K1 launches == 2 x nuc calls. The
                fused delta steps timed per batch beside run_step_pool2,
                inputs resident.
  5e. profiling — the port's profilers (nucleoatac_torch/profiling) on
                phase 5's first batch through phase 5's engine: the stage
                profile of run_step_pool2 (rows finite and > 0, their
                composed bytes equal to run_step_pool2's replay, K2
                launches == the xcorr row's calls; e2e_device of the
                replay beside the eager chain's), a torch.profiler trace of
                8 replayed batches naming nuc_scores_kernel 8 times; the same on
                [cuda:0, cuda:0] (16 times); the diag_pallas route (two K1
                rows, 16 K1 events); then the finishing profile at 250
                peaks (every component group, the ten outputs, the fused
                timers none negative). Each report is printed as a table
                and a JSON line.
  5g. graphs  — the fused steps as step programs (models/graphs.py: one
                CUDA graph per input signature, replayed; the reference's
                jit executables): phase 5's run made at most 2 captures;
                its first 8 batches, dispatched as the run dispatches them,
                replay byte-equal to the eager chain (_run_pool2) on the
                same device inputs with no new capture; run_step_delta12
                and run_step_delta on 5d's encodings equal to their eager
                chains and to pool2; one batch on a diag_pallas engine (K1
                inside the graph) and on two shards of cuda:0; K2 == nuc
                steps, K1 == 2 x nuc steps. Prints captures, replays, the
                graph pools' bytes and memory_reserved, e2e_device of the
                replay and of the eager chain in turns (least of three),
                two shards against one card, each form's host enqueue and
                a trace of 8 steps of each (kernels per batch,
                cudaGraphLaunch calls, busy share).
  6. parity   — the same small run on cuda and on cpu (plain versions):
                output rows equal, signal tracks within nuc.exact_tol.
  7. stages   — `nucleoatac-torch occ`, `nuc`, `merge`, `nfr` (the
                two-pass delta12 path) on phase 5's dataset at full width:
                rows equal to phase 5's fused outputs; K2 launches == nuc
                batches.
  8. conv     — run_pipeline with conv="diag_pallas" on phase 5's dataset:
                K1 launches == 2 x nuc batches and no K2 launch; outputs
                against phase 5 by parity.compare_runs (signal within
                nuc.exact_tol + one u16 step); the K1 route's norm on a
                production batch within nuc.exact_tol of f64.
  8b. wires   — the wires beside pool and the direct route. Full width:
                `nucleoatac-torch run --upper 500` on phase 5's peaks with
                10% di-nucleosomal fragments (synth_dataset's dinuc) falls
                back to the packed wire: K2 launches == nuc batches, the
                spot-check ran, ten outputs, occ peaks in [0, 1], fragments
                past 255 bp in the fit, max |LL - f64| of a [64, 500, 1536]
                batch within occ.exact_tol; phase 5's dataset on the delta,
                delta12 and packed wires (the two passes) prints phase 5's
                rows; conv="direct" (two conv1d, no kernel) against phase 5
                (signal within exact_tol + one u16 step) and its norm on a
                production batch within exact_tol of f64. make_example size:
                delta, delta12, frags, dense, packed and packed at --upper
                300 (long-fragment example), cuda on both kernel routes
                against cpu by parity.compare_runs.
  9. resume+bias — on make_example data: `run` then `run --resume` give
                identical nucpos and nfrpos; `pyatac-torch bias` then
                `run --bias_track` give the FASTA run's dyads and a
                byte-identical occ bedgraph.
 10. pyatac   — `pyatac-torch vplot --device` on the card equals the host
                aggregate exactly (phase 5's 1,000 peaks).
 11. hosts    — two run_distributed ranks as concurrent processes on the
                card (gloo, both on cuda:0) on phase 5's dataset; rank 0
                finalizes after the barrier: all ten files row-equal to
                phase 5, nuc_dist equal, K2 launches summed over the
                ranks == their nuc batches. Then the external-launcher
                form (`run --host_id 0`, `--host_id 1`, `--finalize`) on
                make_example data equals a one-process `run`.
 12. nonexact — occ.exact = nuc.exact = False run_pipeline on phase 5's
                dataset on both xcorr routes: K2 launches == batches
                ("diag"), K1 launches == 2 x batches ("diag_pallas");
                the run's first full batch of _nuc5 output [64, 5, 1536]
                against the plain route on the same inputs (norm and
                norm_smooth within exact_tol, signal/lr/fuzz at the
                non-exact bars); cuda against cpu on make_example data meets
                parity.compare_runs_nonexact on each route.
 13. profile  — `run --profile DIR` on make_example data: the trace
                exists and names nuc_scores_kernel.
Then one JSON line of kernel records (K2's launches from phase 5, K1's
from phase 8, and each kernel's launches on every path that ran it,
phase 5b's sharded runs, phase 5c's tracks, phase 5d's forms, phase
5e's profiles, phase 5g's graphs and phase 8b's wires
included) and as
the last line {"ok": true, "device": {...}}.

Imports nothing of JAX (``jax`` is blocked in this process) and nothing of
the JAX package: the synthetic data are written by the port's own writers.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must run without JAX

from nucleoatac_torch.profiling.stages import (  # noqa: E402
    bound, k1_work, k2_work, k3_bound, k4_bound, smi)
from nucleoatac_torch.synthetic import make_example, make_long_example, synth_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_RECORDS: list = []
# the one card of every phase but 5b's sharded runs
CARD = "cuda:0"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_device() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    print(smi(), flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device0 {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")


def phase_build() -> None:
    from nucleoatac_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    phase("build", f"{build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc per source, run together)")
    # "Compiling <kernel>", its registers and stack, and the spill line
    # that follows a "Function properties" header without the prefix
    report = [ln.strip() for ln in build.BUILD_LOG.splitlines()
              if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln))
              or "bytes spill" in ln]
    for ln in report or ["library was already built: no ptxas report"]:
        print(f"[build] {ln}", flush=True)


def _template_tables(dev, dtype=None):
    import torch

    from nucleoatac_torch.config import NucParams
    from nucleoatac_torch.core.vmat import VMat
    from nucleoatac_torch.ops.xcorr import build_kernels_diag

    tabs = build_kernels_diag(VMat.default().mat, NucParams().v_floor)
    return [torch.as_tensor(t, device=dev, dtype=dtype or torch.float32)
            .contiguous() for t in tabs]


def phase_k1() -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from nucleoatac_torch.device import set_precision_flags
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops.xcorr import conv_stack_diag

    set_precision_flags()  # cuDNN's yardstick below in full float32, no TF32
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    B, S, W, C, K = 64, 146, 1536, 2, 147
    Wo = W - K + 1
    x = torch.as_tensor(rng.random((B, S, W), dtype=np.float32), device=dev)
    k2d = torch.as_tensor(rng.random((C, K, S), dtype=np.float32), device=dev)
    got = k1.diag_xcorr(x, k2d)
    plain = conv_stack_diag(x, k2d)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    ref64 = conv_stack_diag(x.double(), k2d.double())
    err_plain = float((got.double() - plain.double()).abs().max())
    err64 = float((got.double() - ref64).abs().max())
    rel64 = err64 / float(ref64.abs().max())
    # the yardstick: cuDNN's conv1d computes the same function (never
    # called by the port)
    wconv = k2d.permute(0, 2, 1).contiguous()
    lib = F.conv1d(x, wconv)
    torch.testing.assert_close(lib, plain, rtol=1e-4, atol=1e-4)
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):  # in turns: kernel, plain, library, three times
        times["ms"].append(cuda_ms(lambda: k1.diag_xcorr(x, k2d), iters=20))
        times["plain_ms"].append(cuda_ms(lambda: conv_stack_diag(x, k2d)))
        times["library_ms"].append(cuda_ms(lambda: F.conv1d(x, wconv), iters=20))
    t = {k: min(v) for k, v in times.items()}
    bd = bound(*k1_work(B, S, W, K, C))
    parent = _parent_lib()
    if parent is not None:
        pout = torch.empty_like(got)
        hold("parent K1 vs this K1", _lib_k1(parent, x, k2d, pout), got, 0.0, 0.0)
        side = _beside_parent(lambda: k1.diag_xcorr(x, k2d),
                              lambda: _lib_k1(parent, x, k2d, pout))
        phase("K1", f"beside the parent's kernel: {side}")
    wide = _k1_wide(dev)
    phase("K1", f"diag_xcorr [64,146,1536]x[2,147,146]: max|k-plain| "
          f"{err_plain:.3e}, max|k-f64| {err64:.3e} (rel {rel64:.2e}); "
          f"{t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms, cuDNN conv1d "
          f"{t['library_ms']:.4f} ms (kernel {t['library_ms'] / t['ms']:.2f}x its speed); "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {bd['bound_rate']}), "
          f"{bd['bound_ms'] / t['ms']:.1%} of it; FP32-pipe figure "
          f"{bd['fp32_pipe_bound_ms']:.4f} ms; {wide}; runs {times} on {smi()}")
    KERNEL_RECORDS.append({
        "name": "diag_xcorr", "route": "cuda",
        "source": "nucleoatac_torch/csrc/diag_xcorr.cu",
        "replaces": "nucleoatac_tpu/ops/pallas_diag.py:47",
        "launches": 0, "max_abs_err": err64, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.nn.functional.conv1d (cuDNN, TF32 off)",
        "share_of_bound": bd["bound_ms"] / t["ms"], "bound_rate": bd["bound_rate"],
        "fp32_pipe_bound_ms": bd["fp32_pipe_bound_ms"], "flops": bd["flops"],
        "bytes": bd["bytes"],
    })


def _k1_wide(dev) -> str:
    """K1 on templates wider than the tile's 256 threads stage columns for
    (K = 401: 13 bands) against its plain version; a template too wide for
    the tile's shared memory (K = 673) raises, and the next launch is
    clean."""
    import numpy as np
    import torch

    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops.xcorr import conv_stack_diag

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.random((4, 146, 1536), dtype=np.float32), device=dev)
    k = torch.as_tensor(rng.random((2, 401, 146), dtype=np.float32), device=dev)
    got = k1.diag_xcorr(x, k)
    torch.cuda.synchronize()
    err = hold("K1 at K = 401 vs plain", got, conv_stack_diag(x, k), 1e-4, 1e-4)
    huge = torch.zeros((2, 673, 146), device=dev)
    try:
        k1.diag_xcorr(x, huge)
    except RuntimeError:
        pass
    else:
        raise AssertionError("K1 at K = 673 (past the shared memory) did not raise")
    hold("K1 after the refused launch", k1.diag_xcorr(x, k), got, 0.0, 0.0)
    return f"K = 401 max|k-plain| {err:.3e}; K = 673 refused"


def hold(what: str, got, ref, rtol: float, atol: float) -> float:
    """max |got - ref|; raises where |got - ref| > atol + rtol * |ref|."""
    import torch

    g, r = got.double(), ref.double()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite values")
    d = (g - r).abs()
    excess = d - (atol + rtol * r.abs())
    if bool((excess > 0).any()):
        i = int(excess.argmax())
        raise AssertionError(
            f"{what}: |{float(g.flatten()[i])} - {float(r.flatten()[i])}| past the "
            f"bar (rtol {rtol}, atol {atol}); max|diff| {float(d.max()):.3e}")
    return float(d.max())


def same_rows(a: str, b: str) -> int:
    """Row count of two bgzipped outputs that hold the same rows (equal
    decompressed bytes); raises if they differ or are empty. Cheaper than
    parsing millions of rows into lists."""
    from nucleoatac_torch.parity import _same_text

    text = _same_text(a, b)
    if not text:
        raise AssertionError(f"{b}: rows differ from {a}, or hold none")
    return text.count(b"\n")


def score_bars(exact_tol: float) -> dict:
    """Bars of the nuc score channels against their plain version: norm
    within nuc.exact_tol; signal, lr and fuzz at parity.NONEXACT_STAT_TOL,
    the bars non-exact mode's nucpos columns 9, 7 and 10 are held to."""
    from nucleoatac_torch.parity import NONEXACT_STAT_TOL

    return {"norm": (0.0, exact_tol), "norm_smooth": (0.0, exact_tol),
            "signal": NONEXACT_STAT_TOL[9], "lr": NONEXACT_STAT_TOL[7],
            "fuzz": NONEXACT_STAT_TOL[10]}


def _synthetic_batch(dev, B, W, rng, n_frags=4000):
    """Raster [B, 251, W] of a synthetic batch (nucleosomal + short
    fragments) and a random per-bp log bias [B, W]."""
    import numpy as np
    import torch

    from nucleoatac_torch.ops.rasterize import rasterize_batch

    n_nuc = n_frags // 2
    sizes = np.concatenate([
        np.clip(rng.normal(156, 14, (B, n_nuc)), 105, 250),
        np.clip(rng.exponential(42, (B, n_frags - n_nuc)) + 24, 24, 250),
    ], axis=1).astype(np.int64)
    mids = rng.integers(0, W, size=(B, n_frags))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    mat = rasterize_batch(t(mids), t(sizes), t(np.ones((B, n_frags), bool)),
                          0, 251, W)
    logb = t(rng.normal(0, 0.3, size=(B, W)).astype(np.float32))
    return mat, logb


def phase_k2() -> None:
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch

    cfg = RunConfig()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    B = cfg.window.batch
    mat, logb = _synthetic_batch(dev, B, W, rng)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=dev)
    b0 = bias_mat_batch(logb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo)
    fmat = mat[:, cfg.vmat.lower - cfg.sizes.lower:]  # batch-strided view
    tabs = _template_tables(dev)
    K = tabs[0].shape[1]
    Wo = W - K + 1
    vf = cfg.nuc.var_floor
    got = k2.nuc_scores(fmat, b0, *tabs, vf)
    plain = k2.nuc_scores_plain(fmat, b0, *tabs, vf)
    ref64 = k2.nuc_scores_plain(
        fmat.double(), b0.double(), *_template_tables(dev, torch.float64), vf
    )
    torch.cuda.synchronize()
    err = {c: float((got[:, i].double() - ref64[:, i]).abs().max())
           for i, c in enumerate(k2.CHANNELS)}
    if err["norm"] > cfg.nuc.exact_tol:
        raise AssertionError(
            f"K2 max|norm - f64| {err['norm']:.3e} > nuc.exact_tol "
            f"{cfg.nuc.exact_tol}")
    # every channel against the plain version: non-exact mode prints
    # signal, lr and fuzz straight from K2
    bars = score_bars(cfg.nuc.exact_tol)
    err_plain = {c: hold(f"K2 {c} vs plain", got[:, i], plain[:, i], *bars[c])
                 for i, c in enumerate(k2.CHANNELS[:4])}
    if not torch.equal(got[:, 4], plain[:, 4]):
        raise AssertionError("K2 fragment counts n differ from the plain version")
    peak = {c: float(plain[:, i].abs().max()) for i, c in enumerate(k2.CHANNELS)}
    if min(peak.values()) <= 0:
        raise AssertionError(f"K2 comparison is vacuous: max|plain| {peak}")
    import torch.nn.functional as F

    # the nearest yardstick: one grouped cuDNN conv1d over a pre-concatenated
    # [F; B0] computes the four 2-D sums (over 99% of K2's FLOPs), not the
    # rank-1 sums or the epilogue (never called by the port)
    fmat_c = fmat.contiguous()
    fb = torch.cat([fmat_c, b0], dim=1)
    wconv = torch.cat([tabs[0], tabs[2]]).permute(0, 2, 1).contiguous()
    lib = F.conv1d(fb, wconv, groups=2)
    hold("cuDNN 2-D sums vs K2 signal", lib[:, 0], plain[:, 1, K // 2:K // 2 + Wo],
         *bars["signal"])
    times = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(3):  # in turns: kernel, plain, library, three times
        times["ms"].append(cuda_ms(lambda: k2.nuc_scores(fmat, b0, *tabs, vf), iters=20))
        times["plain_ms"].append(cuda_ms(lambda: k2.nuc_scores_plain(fmat_c, b0, *tabs, vf)))
        times["library_ms"].append(cuda_ms(lambda: F.conv1d(fb, wconv, groups=2), iters=20))
    t = {k: min(v) for k, v in times.items()}
    S = fmat.shape[1]
    bd = bound(*k2_work(B, S, W, K))
    parent = _parent_lib()
    buf = torch.empty_like(got)
    if parent is not None and not torch.equal(
            _lib_k2(parent, fmat, b0, tabs, vf, buf)[:, 4], got[:, 4]):
        raise AssertionError("the parent's K2 gives other fragment counts n")
    base = {"slabs": _slabs_of(dev, lambda: k2.nuc_scores(fmat, b0, *tabs, vf)),
            **_beside_parent(lambda: k2.nuc_scores(fmat, b0, *tabs, vf),
                             parent and (lambda: _lib_k2(parent, fmat, b0, tabs, vf, buf)))}
    cover = _k2_coverage(dev, cfg, q, tabs, parent)
    phase("K2", f"F slabs (sparse, dense) and ms beside the parent's kernel "
          f"({'present' if parent else 'absent'}): [K2] batch {base}; "
          f"by fragments per window {cover}")
    sweep = _k2_sweep(dev, b0, tabs, vf)
    phase("K2", f"crossover sweep (kSparseMax {sweep['kSparseMax']}; the two routes "
          f"meet at {sweep['crossover_cells']} cells per slab): {json.dumps(sweep['rows'])}")
    wide = _k2_wide(dev, fmat[:4], b0[:4], tabs, vf, bars)
    fmt = lambda e: ", ".join(f"{c} {v:.3e}" for c, v in e.items())  # noqa: E731
    phase("K2", f"nuc_scores [64,146,1536]: max|k-f64| {fmt(err)} (norm bar "
          f"exact_tol {cfg.nuc.exact_tol}); max|k-plain| {fmt(err_plain)}, n equal "
          f"(bars (rtol, atol): { {c: bars[c] for c in err_plain} }; max|plain| "
          f"{fmt(peak)}); {t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms, "
          f"cuDNN grouped conv1d of the 2-D sums only {t['library_ms']:.4f} ms; "
          f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {bd['bound_rate']}), "
          f"{bd['bound_ms'] / t['ms']:.1%} of it; FP32-pipe figure "
          f"{bd['fp32_pipe_bound_ms']:.4f} ms; max|norm-f64| by fragments per "
          f"window {cover}; {wide}; runs {times} on {smi()}")
    KERNEL_RECORDS.append({
        "name": "nuc_scores", "route": "cuda",
        "source": "nucleoatac_torch/csrc/nuc_scores.cu",
        "replaces": "nucleoatac_tpu/ops/pallas_kernels.py:44",
        "launches": 0, "max_abs_err": err["norm"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "library_ms": t["library_ms"],
        "library": "torch.nn.functional.conv1d, groups=2 over [F; B0] "
                   "(cuDNN, TF32 off): the four 2-D sums only",
        "share_of_bound": bd["bound_ms"] / t["ms"], "bound_rate": bd["bound_rate"],
        "fp32_pipe_bound_ms": bd["fp32_pipe_bound_ms"], "flops": bd["flops"],
        "bytes": bd["bytes"], "norm_err_by_coverage": cover,
        "slabs_and_parent": base, "crossover_sweep": sweep,
    })


# a `git archive` of the parent commit, unpacked here before the call: its
# K1 and K2 are timed beside this tree's in [K1] and [K2] where present
PARENT = os.path.join(ROOT, "build", "parent")


def _kernel_lib(csrc: str, tag: str, subs: tuple = ()):
    """K1 and K2 of the csrc directory ``csrc`` (diag_xcorr.cu,
    nuc_scores.cu and xcorr.cuh, with the text substitutions ``subs``
    made) built with the port's nvcc flags into one library under
    build/variants/<tag>; returns (ctypes library, whether K2 takes the
    slab counters)."""
    import ctypes
    import shutil

    from nucleoatac_torch.kernels import build

    out = os.path.join(ROOT, "build", "variants", tag)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    texts = {}
    for name in ("diag_xcorr.cu", "nuc_scores.cu", "xcorr.cuh"):
        text = open(os.path.join(csrc, name)).read()
        for old, new in subs:
            if old in text:
                text = text.replace(old, new)
        texts[name] = text
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    lib = os.path.join(out, "lib.so")
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                           os.path.join(out, "diag_xcorr.cu"),
                           os.path.join(out, "nuc_scores.cu")],
                          check=True, capture_output=True, text=True)
    spills = [ln.strip() for ln in done.stderr.splitlines()
              if "bytes spill" in ln or ("ptxas info" in ln and "Used" in ln)]
    phase("build", f"{tag}: {spills}")
    slabs = "unsigned long long* slabs" in texts["nuc_scores.cu"]
    so = ctypes.CDLL(lib)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.nucleoatac_nuc_scores.restype = i32
    so.nucleoatac_nuc_scores.argtypes = (
        [p, i64, p, i64, p, p, p, p, p] + ([p] if slabs else [])
        + [i32, i32, i32, i32, ctypes.c_float, p])
    so.nucleoatac_diag_xcorr.restype = i32
    so.nucleoatac_diag_xcorr.argtypes = [p, i64, p, p, i32, i32, i32, i32, p]
    return so, slabs


def _parent_lib():
    """The parent's kernels (``PARENT``), built once, or None where it is
    absent."""
    csrc = os.path.join(PARENT, "nucleoatac_torch", "csrc")
    if "parent" not in _LIBS:
        _LIBS["parent"] = _kernel_lib(csrc, "parent") if os.path.isdir(csrc) else None
    return _LIBS["parent"]


_LIBS: dict = {}


def _lib_k2(lib, fmat, b0, tabs, vf, out):
    """One launch of the K2 of ``lib`` (from _kernel_lib) into out."""
    import torch

    so, slabs = lib
    B, S, W = fmat.shape
    args = [fmat.data_ptr(), fmat.stride(0), b0.data_ptr(), b0.stride(0),
            *[t.data_ptr() for t in tabs], out.data_ptr()]
    rc = so.nucleoatac_nuc_scores(
        *args, *([None] if slabs else []), B, S, W, tabs[0].shape[1], float(vf),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 of a built variant: CUDA error {rc}")
    return out


def _lib_k1(lib, x, k2d, out):
    import torch

    so, _ = lib
    B, S, W = x.shape
    rc = so.nucleoatac_diag_xcorr(x.data_ptr(), x.stride(0), k2d.data_ptr(),
                                  out.data_ptr(), B, S, W, k2d.shape[1],
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 of a built variant: CUDA error {rc}")
    return out


def _beside_parent(fn, parent_fn, iters: int = 20) -> dict:
    """ms of fn and parent_fn in turns (least of three means of ``iters``);
    the parent's entry is None without a parent."""
    times = {"ms": [], "parent_ms": []}
    for _ in range(3):
        times["ms"].append(cuda_ms(fn, iters=iters))
        if parent_fn is not None:
            times["parent_ms"].append(cuda_ms(parent_fn, iters=iters))
    return {k: (min(v) if v else None) for k, v in times.items()}


def _slabs_of(dev, fn) -> tuple:
    """(sparse, dense) F slabs of K2's launches inside fn()."""
    from nucleoatac_torch.ops import nuc_scores as k2

    a = k2.slab_counts(dev)
    fn()
    b = k2.slab_counts(dev)
    return (b[0] - a[0], b[1] - a[1])


def _k2_sweep(dev, b0, tabs, vf) -> dict:
    """The density sweep that sets K2's crossover (kSparseMax): F [64, 146,
    1536] with each cell 1 with probability d (a full slab of 8 x 352
    staged cells holds about 2,816 d of them) on the [K2] batch's B0; in
    turns, two variants of this tree's K2 built with kSparseMax a whole
    slab (every slab takes the list) and 0 (every nonempty slab takes the
    band products), and the build's own kernel. The crossover is where the
    two variants' times meet, in nonzero cells per slab. The parent's
    kernel is timed beside them where present."""
    import re as _re

    import torch

    src = os.path.join(ROOT, "nucleoatac_torch", "csrc")
    cur = int(_re.search(r"constexpr int kSparseMax = (\d+);",
                         open(os.path.join(src, "nuc_scores.cu")).read())[1])
    sub = lambda n: ((f"constexpr int kSparseMax = {cur};",  # noqa: E731
                      f"constexpr int kSparseMax = {n};"),)
    # the list variant's slab list takes 8 x 200 entries; past 200 nonzero
    # cells per slab (density 0.071) it takes the band products too
    libs = {"list": _kernel_lib(src, "all_list", sub(200)),
            "bands": _kernel_lib(src, "all_bands", sub(0))}
    parent = _parent_lib()
    if parent is not None:
        libs["parent"] = parent
    from nucleoatac_torch.ops import nuc_scores as k2

    B, S, W = b0.shape
    out = torch.empty((B, 5, W), device=dev)
    rows = []
    g = torch.Generator(device=dev).manual_seed(7)
    for d in (0.0005, 0.002, 0.004, 0.008, 0.012, 0.016, 0.02, 0.025, 0.03, 0.04,
              0.05, 0.06, 0.1, 0.25):
        fmat = (torch.rand((B, S, W), device=dev, generator=g) < d).float()
        ref = k2.nuc_scores(fmat, b0, *tabs, vf)
        for name, lib in libs.items():  # both routes give the build's n bits
            if not torch.equal(_lib_k2(lib, fmat, b0, tabs, vf, out)[:, 4], ref[:, 4]):
                raise AssertionError(f"K2 variant {name} at density {d}: n differs")
        t = {k: [] for k in (*libs, "build")}
        for _ in range(3):
            for name, lib in libs.items():
                t[name].append(cuda_ms(lambda lib=lib: _lib_k2(lib, fmat, b0, tabs, vf, out),
                                       iters=10))
            t["build"].append(cuda_ms(lambda: k2.nuc_scores(fmat, b0, *tabs, vf), iters=10))
        rows.append({"density": d, "cells_per_slab": round(d * 8 * 352, 1),
                     **{f"{k}_ms": round(min(v), 5) for k, v in t.items()},
                     "slabs": _slabs_of(dev, lambda: k2.nuc_scores(fmat, b0, *tabs, vf))})
    cross = None
    for a, b in zip(rows, rows[1:]):
        da, db = a["list_ms"] - a["bands_ms"], b["list_ms"] - b["bands_ms"]
        if da <= 0 < db:
            cross = a["cells_per_slab"] + (b["cells_per_slab"] - a["cells_per_slab"]) * (
                -da / (db - da))
            break
    return {"rows": rows, "crossover_cells": cross, "kSparseMax": cur}


def _k2_coverage(dev, cfg, q, tabs, parent=None) -> dict:
    """K2's max |norm - f64| on production batches of 10, 40 and 100 times
    the fragments of the [K2] batch (up to ~22,000 fragments in one
    footprint): the tile's error grows with the counts, and each must stay
    within nuc.exact_tol; n equals float64's. Keyed by fragments per
    window, with the largest n, the launch's sparse and dense F slabs and
    its time beside the parent's kernel (``parent``, from _parent_lib)."""
    import numpy as np
    import torch

    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch

    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    tabs64 = _template_tables(dev, torch.float64)
    out = {}
    for mult in (10, 40, 100):
        n_frags = 4000 * mult
        mat, logb = _synthetic_batch(dev, cfg.window.batch, W,
                                     np.random.default_rng(20 + mult), n_frags)
        b0 = bias_mat_batch(logb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo)
        fmat = mat[:, cfg.vmat.lower - cfg.sizes.lower:]
        got = k2.nuc_scores(fmat, b0, *tabs, cfg.nuc.var_floor)
        ref = k2.nuc_scores_plain(fmat.double(), b0.double(), *tabs64, cfg.nuc.var_floor)
        err = float((got[:, 0].double() - ref[:, 0]).abs().max())
        if err > cfg.nuc.exact_tol or not torch.equal(got[:, 4].double(), ref[:, 4]):
            raise AssertionError(f"K2 at {n_frags} fragments per window: max|norm - f64| "
                                 f"{err:.3e} (bar {cfg.nuc.exact_tol}), or n differs")
        buf = torch.empty_like(got)
        vf = cfg.nuc.var_floor
        t = _beside_parent(lambda: k2.nuc_scores(fmat, b0, *tabs, vf),
                           parent and (lambda: _lib_k2(parent, fmat, b0, tabs, vf, buf)))
        out[n_frags] = {"max_n": float(ref[:, 4].max()), "norm_err": err,
                        "slabs": _slabs_of(dev, lambda: k2.nuc_scores(fmat, b0, *tabs, vf)),
                        **t}
    return out


def _k2_wide(dev, fmat, b0, tabs, vf, bars) -> str:
    """K2 with the production templates zero-padded to K = 401 (13 bands,
    608 staged columns) against its plain version on the same inputs:
    every channel within its bar, n equal."""
    import torch
    import torch.nn.functional as F

    from nucleoatac_torch.ops import nuc_scores as k2

    pad = (401 - tabs[0].shape[1]) // 2
    wide = [F.pad(tabs[0], (0, 0, pad, pad)).contiguous(), F.pad(tabs[1], (pad, pad)),
            F.pad(tabs[2], (0, 0, pad, pad)).contiguous(), F.pad(tabs[3], (pad, pad))]
    got = k2.nuc_scores(fmat, b0, *wide, vf)
    plain = k2.nuc_scores_plain(fmat.contiguous(), b0, *wide, vf)
    torch.cuda.synchronize()
    errs = {c: hold(f"K2 at K = 401 {c} vs plain", got[:, i], plain[:, i], *bars[c])
            for i, c in enumerate(k2.CHANNELS[:4])}
    if not torch.equal(got[:, 4], plain[:, 4]) or float(plain[:, 4].max()) <= 0:
        raise AssertionError("K2 at K = 401: n differs from the plain version, or is 0")
    return "K = 401 max|k-plain| " + ", ".join(f"{c} {v:.3e}" for c, v in errs.items())


def phase_ll() -> None:
    """Occupancy LL on the card against float64 on the card, production
    batch shape: the error the occ f64 certification has to absorb."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.fragmentsizes import FragmentSizes
    from nucleoatac_torch.core.mixture import FragmentMixDistribution
    from nucleoatac_torch.ops.occupancy import _ll_and_n

    cfg = RunConfig()
    dev = torch.device("cuda")
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (2e4 * np.exp(-s / 45.0)
              + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    lm = torch.as_tensor(np.asarray(mix.log_mix_table(cfg.occ), np.float32), device=dev)
    mat, _ = _synthetic_batch(
        dev, cfg.window.batch, cfg.window.width(cfg.occ, cfg.vmat),
        np.random.default_rng(3))
    ll, _ = _ll_and_n(mat, lm, cfg.occ.flank)
    ll64, _ = _ll_and_n(mat.double(), lm.double(), cfg.occ.flank)
    err = float((ll.double() - ll64).abs().max())
    scale = float(ll64.abs().max())
    if err > cfg.occ.exact_tol:
        raise AssertionError(f"max|LL - f64| {err:.3e} > occ.exact_tol {cfg.occ.exact_tol}")
    phase("LL", f"occupancy LL [64,1536,101]: max|LL-f64| {err:.3e} at max|LL| "
          f"{scale:.1f} (occ.exact_tol {cfg.occ.exact_tol})")


def phase_occ() -> None:
    """K3 against its plain version at production shape, and timed."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.fragmentsizes import FragmentSizes
    from nucleoatac_torch.core.mixture import FragmentMixDistribution
    from nucleoatac_torch.ops import occ_window as k3
    from nucleoatac_torch.ops.occupancy import (
        occupancy_packed2, occupancy_packed2_plain, packed2_from_proj, projection_and_counts)

    cfg = RunConfig()
    dev = torch.device(CARD)
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (2e4 * np.exp(-s / 45.0)
              + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    lm = torch.as_tensor(np.asarray(mix.log_mix_table(cfg.occ), np.float32), device=dev)
    B, W = cfg.window.batch, cfg.window.width(cfg.occ, cfg.vmat)
    halo, core, p = cfg.window.halo(cfg.occ, cfg.vmat), cfg.window.core, cfg.occ
    mat, _ = _synthetic_batch(dev, B, W, np.random.default_rng(4))
    # a stretch with no fragments in half the windows: empty positions
    mat[::2, :, halo + 100:halo + 300] = 0
    G = lm.shape[1]
    pc = projection_and_counts(mat, lm)
    proj, n = pc[:, :G], pc[:, G]
    if not torch.equal(n, mat.sum(dim=1)):
        raise AssertionError("the SGEMM's counts row differs from the column sums")
    args = (p.flank, halo, core, p.ci_drop, p.exact_tol)
    n0 = k3.LAUNCHES
    got = k3.occ_window(proj, n, *args)
    want = packed2_from_proj(proj, n, *args)
    whole = occupancy_packed2(mat, lm, *args)
    whole_plain = occupancy_packed2_plain(mat, lm, *args)
    torch.cuda.synchronize()
    if k3.LAUNCHES != n0 + 2:
        raise AssertionError(f"K3 launched {k3.LAUNCHES - n0} times for 2 calls")
    for what, a, b in (("K3", got, want), ("occupancy_packed2 vs K3", whole, got)):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            raise AssertionError(f"{what} bytes differ from the plain version's at "
                                 f"{bad.shape[0]} places, first {bad[:4].tolist()}")
    # the torch form's einsum is another SGEMM call: its picks agree
    # wherever both certify
    cert = (got[:, :core] >> 7).bool()
    both = cert & (whole_plain[:, :core] >> 7).bool()
    if not torch.equal(whole[:, :core][both], whole_plain[:, :core][both]) or \
            float(both.float().mean()) < 0.5:
        raise AssertionError("occupancy_packed2 and its torch form disagree where both "
                             "certify")
    same_plain = torch.equal(whole, whole_plain)
    empty = got[:, :core] == 0
    times = {"ms": [], "plain_ms": [], "whole_ms": [], "whole_plain_ms": []}
    for _ in range(3):  # in turns
        times["ms"].append(cuda_ms(lambda: k3.occ_window(proj, n, *args), iters=20))
        times["plain_ms"].append(cuda_ms(lambda: packed2_from_proj(proj, n, *args), iters=20))
        times["whole_ms"].append(cuda_ms(lambda: occupancy_packed2(mat, lm, *args), iters=20))
        times["whole_plain_ms"].append(
            cuda_ms(lambda: occupancy_packed2_plain(mat, lm, *args), iters=20))
    t = {k: min(v) for k, v in times.items()}
    bd = k3_bound(B, G, W, halo, core, p.flank)
    phase("OCC", f"occ_window [64,{G},{W}] core {core} flank {p.flank}: bytes equal to "
          f"the plain version's on the same projection and counts; occupancy_packed2's "
          f"bytes {'equal to' if same_plain else 'where both certify equal to'} its torch "
          f"form's ({float(cert.float().mean()):.1%} certified, "
          f"{float(empty.float().mean()):.1%} read 0); K3 {t['ms']:.4f} ms vs plain "
          f"{t['plain_ms']:.4f} ms; occupancy_packed2 (the SGEMM with the counts' row, K3) "
          f"{t['whole_ms']:.4f} ms vs its torch form {t['whole_plain_ms']:.4f} ms; bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}: {bd['adds'] / 1e9:.3f} G f64 adds, "
          f"{bd['direct_adds'] / 1e9:.3f} G window by window; {bd['bytes'] / 1e6:.1f} MB), "
          f"{bd['bound_ms'] / t['ms']:.1%} of it; "
          f"runs {times} on {smi()}")


def _ulps(a, b):
    """|a - b| in float32 units in the last place, per element (equal
    NaNs 0 apart), as int64."""
    import torch

    def key(x):  # the float32 bit patterns, ordered as the values
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (key(a) - key(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


def phase_bias() -> None:
    """K4 against its plain version at the main path's shape, and timed."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.ops import biasmat as k4

    cfg = RunConfig()
    dev = torch.device(CARD)
    rng = np.random.default_rng(6)
    B, W = cfg.window.batch, cfg.window.width(cfg.occ, cfg.vmat)
    halo, lower, upper = cfg.window.halo(cfg.occ, cfg.vmat), cfg.vmat.lower, cfg.vmat.upper
    S, core = upper - lower, slice(halo, W - halo)
    _, logb = _synthetic_batch(dev, B, W, rng, n_frags=16)
    q = rng.random(S)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=dev)
    args = (lower, upper, halo, W - halo)
    n0 = k4.LAUNCHES
    got = k4.bias_mat_batch(logb, q, *args)
    again = k4.bias_mat(logb, q, *args)
    want = k4.bias_mat_batch_plain(logb, q, *args)
    # with an empty core and q = 1, B0 is raw itself
    ones = torch.ones_like(q)
    raw, raw_plain = (f(logb, ones, lower, upper, 0, 0)
                      for f in (k4.bias_mat, k4.bias_mat_batch_plain))
    torch.cuda.synchronize()
    if k4.LAUNCHES != n0 + 3:
        raise AssertionError(f"K4 launched {k4.LAUNCHES - n0} times for 3 calls")
    if not torch.equal(got, again) or not torch.equal(raw, raw_plain):
        raise AssertionError("K4 differs between two launches, or its raw terms from "
                             "the plain version's")
    # K4 sums each core in float64 and rounds once: the plain arithmetic
    # with that core sum is its bar; what the plain version's float32 sum
    # moves B0 sets how far K4 may lie from the plain version
    cs64 = raw_plain[:, :, core].double().sum(dim=2).float()
    once = raw_plain * (q[None, :] / torch.where(cs64 > 0, cs64, 1.0))[..., None]
    err, err_plain, slack = int(_ulps(got, once).max()), _ulps(got, want), _ulps(once, want)
    if err > 4 or not (err_plain <= 4 + slack).all():
        raise AssertionError(f"K4's B0 is {err} ulps from the plain arithmetic with a "
                             f"float64 core sum (at most 4), {int(err_plain.max())} from "
                             f"the plain version's (its float32 core sums move it "
                             f"{int(slack.max())})")
    times = {"ms": [], "plain_ms": []}
    for _ in range(3):  # in turns
        times["ms"].append(cuda_ms(lambda: k4.bias_mat(logb, q, *args), iters=20))
        times["plain_ms"].append(
            cuda_ms(lambda: k4.bias_mat_batch_plain(logb, q, *args), iters=20))
    t = {k: min(v) for k, v in times.items()}
    bd = k4_bound(B, S, W, W - 2 * halo)
    phase("BIAS", f"bias_mat [{B},{S},{W}] core [{halo}, {W - halo}): raw bit-equal to the "
          f"plain version's, B0 within {err} ulps of it with a float64 core sum and "
          f"{int(err_plain.max())} of it ({int((err_plain > 4).sum())} elements past 4; "
          f"its float32 core sums move it up to {int(slack.max())}), the same "
          f"bytes on two launches; K4 "
          f"{t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms; bound {bd['bound_ms']:.4f} ms "
          f"(bytes: {bd['bytes'] / 1e6:.1f} MB; {bd['expf'] / 1e6:.1f} M expf), "
          f"{bd['bound_ms'] / t['ms']:.1%} of it; runs {times} on {smi()}")


def make_dataset(d: str, n_peaks: int = 1000) -> dict:
    """Phase 5's synthetic data (4 chroms x n_peaks/4 peaks x 2,000 bp x
    2,000 fragments per peak), shared by phases 7, 8 and 10."""
    t0 = time.perf_counter()
    bam, bed, fa = synth_dataset(d, 4, n_peaks, 2000, 2000)
    return {"dir": d, "bam": bam, "bed": bed, "fasta": fa, "n_peaks": n_peaks,
            "t_data": time.perf_counter() - t0}


def reset_launches() -> None:
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops import biasmat as k4
    from nucleoatac_torch.ops import occ_window as k3

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    k3.LAUNCHES = 0
    k4.LAUNCHES = 0


def read_launches() -> dict:
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2

    return {"diag_xcorr": k1.LAUNCHES, "nuc_scores": k2.LAUNCHES}


def phase_run(data: dict) -> dict:
    """The port's main path on the card: run_pipeline with the default
    RunConfig. Returns what later phases compare with: the output prefix,
    launch counts, nuc batches, windows and the largest u16 norm step."""
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import RUN_SUFFIXES, read_rows

    cfg = RunConfig()
    prefix = os.path.join(data["dir"], "run")
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                       cfg=cfg, write_plots=False, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = res.engine.steps
    if steps == 0 or launches["nuc_scores"] != steps:
        raise AssertionError(
            f"nuc_scores launched {launches['nuc_scores']} times for "
            f"{steps} batches")
    from nucleoatac_torch.ops import occ_window as k3

    if k3.LAUNCHES != steps:
        raise AssertionError(f"occ_window launched {k3.LAUNCHES} times for {steps} batches")
    from nucleoatac_torch.ops import biasmat as k4

    if k4.LAUNCHES != steps:
        raise AssertionError(f"bias_mat launched {k4.LAUNCHES} times for {steps} batches")
    for sfx in RUN_SUFFIXES:
        for path in (prefix + sfx, prefix + sfx + ".tbi"):
            if not os.path.exists(path):
                raise AssertionError(f"missing output {path}")
    if res.occ_stage.n_spot_checked == 0:
        raise AssertionError("the occ spot-check guard did not run")
    occ = [float(r[3]) for r in read_rows(prefix + ".occpeaks.bed.gz")]
    if not res.nuc.calls or not occ or not all(0.0 <= v <= 1.0 for v in occ):
        raise AssertionError("no dyad calls, or occ peaks out of [0, 1]")
    windows = len(tile_chunks(res.occ.chunks, cfg.window, cfg.occ, cfg.vmat))
    progs = res.engine.programs
    # K2's slab counters, added on the card inside the replayed graphs: the
    # fused pass's loop record reads every batch's slabs
    from nucleoatac_torch.utils.trace import newest

    slabs = {k: v for k, v in newest().counters().items() if k.startswith("k2.")}
    W = cfg.window.width(cfg.occ, cfg.vmat)
    per_batch = (cfg.window.batch * -(-(W - cfg.vmat.width + 1) // 192)
                 * -(-(cfg.vmat.upper - cfg.vmat.lower) // 8))
    if sum(slabs.values()) != steps * per_batch:
        raise AssertionError(f"K2 slab counters {slabs}: {steps} batches of "
                             f"{per_batch} slabs expected")
    phase("run", f"{data['n_peaks']} peaks, {windows} windows, {steps} batches of "
          f"{cfg.window.batch}: run_pipeline {wall:.2f} s = "
          f"{windows / wall:.1f} windows/s (data synthesis {data['t_data']:.1f} s, "
          f"not timed); {len(res.nuc.calls)} dyads, {len(res.nfrs)} NFRs; "
          f"launches {launches}, occ_window {k3.LAUNCHES}, bias_mat {k4.LAUNCHES}; "
          f"occ spot-check positions "
          f"{res.occ_stage.n_spot_checked}; step programs: {progs.captures} captures, "
          f"{progs.replays} replays, pools {progs.pool_bytes / 1e6:.1f} MB; "
          f"K2 F slabs {slabs}")
    return {"prefix": prefix, "launches": launches, "steps": steps,
            "windows": windows, "max_qstep": res.nuc_stage.max_qstep, "wall_s": wall,
            "captures": progs.captures, "replays": progs.replays,
            "engine": res.engine, "mix": res.occ.mix, "fs": res.occ.fragmentsizes}


def phase_devices(data: dict, run5: dict) -> dict:
    """The one-process multi-device run (the reference's auto_mesh): at
    full width on phase 5's dataset through run_pipeline's "cuda" where
    more than one card is visible, else over [cuda:0, cuda:0]; then the
    K1 route sharded at make_example size. Returns each kernel's
    launches."""
    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import RUN_SUFFIXES

    cards = torch.cuda.device_count()
    cfg = RunConfig()
    prefix = os.path.join(data["dir"], "devices")
    # keep the arguments of the run's first batch, to time its chain after
    real, first = TorchEngine.run_step_pool2, []

    def keep_first(eng, *args):
        if not first:
            first.extend(args)
        return real(eng, *args)

    TorchEngine.run_step_pool2 = keep_first
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                           cfg=cfg, write_plots=False,
                           device="cuda" if cards > 1 else [CARD, CARD])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, devs = read_launches(), res.engine.devices
    finally:
        TorchEngine.run_step_pool2 = real
    shards = len(devs)
    if shards < 2 or (cards > 1 and len(set(devs)) != cards):
        raise AssertionError(f"devices: the run sharded over {devs} ({cards} cards)")
    want = {"nuc_scores": shards * run5["steps"], "diag_xcorr": 0}
    if res.engine.steps != want["nuc_scores"] or launches != want:
        raise AssertionError(f"devices: launches {launches}, {res.engine.steps} shard "
                             f"batches; expected {want}")
    rows = sum(same_rows(run5["prefix"] + sfx, prefix + sfx) for sfx in RUN_SUFFIXES)

    # device chain of one batch, inputs resident on the first card: the
    # whole batch's chain on it against the sharded entry point (the
    # gather on the first card waits for every shard)
    eng, dev0 = res.engine, res.engine.device
    pool, table, packed2, esc, emax = first
    resident = [torch.as_tensor(a).to(dev0) for a in (table, packed2, esc)]
    whole = eng._run_pool2(pool[dev0], *resident, emax)
    if not torch.equal(eng.run_step_pool2(pool, *resident, emax), whole):
        raise AssertionError("devices: the sharded chain's bytes differ from one card's")
    chain_ms = {"one": cuda_ms(lambda: eng._run_pool2(pool[dev0], *resident, emax)),
                "sharded": cuda_ms(lambda: eng.run_step_pool2(pool, *resident, emax))}

    # the K1 route sharded: make_example size, batches of 4
    small = RunConfig(window=WindowParams(core=256, batch=4, conv="diag_pallas"))
    k = cards if cards > 1 and small.window.batch % cards == 0 else 2
    sharded = [f"cuda:{i % cards}" for i in range(k)]
    with tempfile.TemporaryDirectory() as d:
        ex = make_example(d)
        out = {}
        for name, dev in (("one", CARD), ("sharded", sharded)):
            reset_launches()
            r = run_pipeline(ex["bam"], ex["bed"], os.path.join(d, name),
                             fasta_path=ex["fasta"], cfg=small, write_plots=False,
                             device=dev)
            out[name] = (read_launches(), r.engine.steps)
        k1 = out["sharded"][0]["diag_xcorr"]
        if out["sharded"] != ({"nuc_scores": 0, "diag_xcorr": 2 * k * out["one"][1]},
                              k * out["one"][1]) or out["one"][1] == 0:
            raise AssertionError(f"devices: diag_pallas launches and shard batches "
                                 f"{out} for {k} shards")
        small_rows = sum(same_rows(os.path.join(d, "one") + sfx,
                                   os.path.join(d, "sharded") + sfx) for sfx in RUN_SUFFIXES)
    w = run5["windows"]
    phase("devices", f"{shards} shards of {cfg.window.batch // shards} windows on "
          f"{','.join(map(str, devs))}: run_pipeline {wall:.2f} s = {w / wall:.1f} "
          f"windows/s; {launches['nuc_scores']} K2 launches for {run5['steps']} batches; "
          f"device chain of a batch, inputs resident: {chain_ms['one']:.3f} ms on "
          f"{dev0} alone, {chain_ms['sharded']:.3f} ms sharded; "
          f"{len(RUN_SUFFIXES)} files, {rows} rows byte-equal to phase 5; diag_pallas "
          f"on {sharded} at make_example size: {k1} K1 launches, {small_rows} rows "
          f"byte-equal to {CARD} alone; {smi()}")
    return {"nuc_scores": launches["nuc_scores"], "diag_xcorr": k1, "wall_s": wall,
            "shards": shards, "chain_ms": chain_ms}


def phase_tracks(data: dict, run5: dict, n_batches: int = 2) -> dict:
    """The float-track step API at full width: the first batches of phase
    5's windows on the frags wire ([64, 251, 1536] rasters) through phase
    5's engine (full_step_frags), held to the run path on the same windows
    (the pool wire, run_step_pool2); then sharded_full_step and
    dryrun_multichip over every visible card or [cuda:0, cuda:0]. Returns
    each path's launches and the times."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.entry import dryrun_multichip
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.io.fasta import FastaFile
    from nucleoatac_torch.models import data as tdata
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.nuc import SeqCodesProvider
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch_plain
    from nucleoatac_torch.parallel import local_devices, sharded_full_step

    t_phase = time.perf_counter()
    cfg, eng = RunConfig(), run5["engine"]
    B, W, dev = cfg.window.batch, eng.width, eng.device
    frags = scan_bam(data["bam"], cfg.ingest)
    chunks = ChunkList.read(data["bed"], frags.chrom_dict).merge()
    tiles = tdata.tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)[:n_batches * B]
    seq = SeqCodesProvider(FastaFile(data["fasta"]), chunks, eng, B)
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    batches = []
    for b in tdata.make_batches(frags, tiles, W, B):
        codes = seq.rows(b.meta)
        batches.append(([t(a) for a in (b.mids, b.sizes, b.valid)],
                        eng._logbias_seq(t(codes)), b.meta, codes))
    if len(batches) != n_batches or any(len(m) != B for _, _, m, _ in batches):
        raise AssertionError("tracks: expected full batches of phase 5's windows")

    # the path: full_step_frags, one K2 launch per call
    reset_launches()
    tracks = [eng.full_step_frags(*frag, lb) for frag, lb, _, _ in batches]
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"nuc_scores": n_batches, "diag_xcorr": 0}:
        raise AssertionError(f"tracks: launches {launches} for {n_batches} calls")

    # the same windows on the run path: one pool batch each
    tol_occ, certified, err64 = cfg.occ.exact_tol, 0, None
    vlo, vup = cfg.vmat.lower - cfg.sizes.lower, cfg.vmat.upper - cfg.sizes.lower
    pool_args = []
    for (frag, lb, meta, codes), (occ, nuc) in zip(batches, tracks):
        (pb,) = tdata.make_pool_batches(frags, meta, W, B)
        packed2, esc, ok = tdata.pack_2bit_codes(codes)
        if not ok or list(pb.meta) != list(meta):
            raise AssertionError("tracks: the pool batch holds other windows")
        args = (t(pb.pool), t(pb.table), t(packed2), t(esc), pb.emax)
        pool_args.append(args)
        mat = eng._raster_pool(*args[:2], pb.emax)
        norm_run = eng._scores(mat, eng._logbias_2bit(*args[2:4]))[0]
        if not torch.equal(nuc.norm, norm_run):
            raise AssertionError("tracks: NucTracks.norm differs from the run "
                                 "path's f32 norm on the same windows")
        idx, cert, _, _ = eng.unpack_run(eng.run_step_pool2(*args).cpu().numpy())
        core = slice(eng.core_lo, eng.core_lo + eng.core)
        o = [x[:, core].cpu().numpy() for x in occ]
        both = cert & (o[4] > tol_occ) & (o[5] > tol_occ)
        if both.mean() < 0.5:
            raise AssertionError(f"tracks: {both.mean():.3f} of the core certified")
        for c in range(3):
            if not np.array_equal(eng.alpha_grid[idx[:, c]][both], o[c][both]):
                raise AssertionError(f"tracks: OccTracks.{occ._fields[c]} differs "
                                     "from the run path's certified picks")
        certified += int(both.sum())
        if err64 is None:  # the norm of one batch against float64
            q64 = torch.as_tensor(eng.size_probs64, device=dev)
            b0_64 = bias_mat_batch_plain(lb.double(), q64, cfg.vmat.lower,
                                         cfg.vmat.upper, eng.core_lo, eng.core_hi)
            ref64 = k2.nuc_scores_plain(
                mat[:, vlo:vup].double(), b0_64,
                *[x.double() for x in eng.tables["_diag_kernels"]], cfg.nuc.var_floor)
            err64 = float((nuc.norm.double() - ref64[:, 0]).abs().max())
            if err64 > cfg.nuc.exact_tol:
                raise AssertionError(f"tracks: max|norm - f64| {err64:.3e} > "
                                     f"nuc.exact_tol {cfg.nuc.exact_tol}")

    # sharded_full_step over every visible card, or two shards on cuda:0
    cards = torch.cuda.device_count()
    devs = local_devices() if cards > 1 else [CARD, CARD]
    seng = TorchEngine(cfg, run5["mix"], run5["fs"], eng.vmat, pwm=eng.pwm, device=devs)
    shards = len(seng.devices)
    reset_launches()
    sharded = [sharded_full_step(seng)(*frag, lb) for frag, lb, _, _ in batches]
    torch.cuda.synchronize()
    sharded_launches = read_launches()
    if sharded_launches != {"nuc_scores": shards * n_batches, "diag_xcorr": 0}:
        raise AssertionError(f"tracks: sharded launches {sharded_launches} for "
                             f"{shards} shards x {n_batches} calls")
    for got, want in zip(sharded, tracks):
        for a, b in zip(got, want):
            for f, x, y in zip(b._fields, a, b):
                if x.device != dev or not torch.equal(x, y):
                    raise AssertionError(f"tracks: sharded {type(b).__name__}.{f} "
                                         "differs from one device's")

    # the dry run over the same devices: the fused step once per shard on
    # K2 and twice on K1; the chained block's delta12, pool and pool2 steps
    # once per shard and delta12 once on one device, all on K2
    reset_launches()
    dry = dryrun_multichip(shards, device=devs)
    torch.cuda.synchronize()
    dry_launches = read_launches()
    if dry_launches != {"nuc_scores": 4 * shards + 1, "diag_xcorr": 2 * shards}:
        raise AssertionError(f"tracks: dry run launches {dry_launches}, {shards} shards")

    # one 64-window batch, inputs resident: the float tracks beside the
    # run path's chain, in one call
    frag, lb, _, _ = batches[0]
    ms = {"full_step_frags": cuda_ms(lambda: eng.full_step_frags(*frag, lb)),
          "run_step_pool2": cuda_ms(lambda: eng.run_step_pool2(*pool_args[0]))}
    wall = time.perf_counter() - t_phase
    phase("tracks", f"full_step_frags on {n_batches} batches of {B} windows "
          f"[{B}, {cfg.sizes.upper - cfg.sizes.lower}, {W}]: norm bit-equal to the run "
          f"path's, max|norm-f64| {err64:.3e}; occ/lower/upper equal to run_step_pool2's "
          f"picks at {certified} certified positions; launches {launches}; "
          f"sharded_full_step on {','.join(map(str, seng.devices))}: every field "
          f"bit-equal, launches {sharded_launches}; dryrun_multichip({shards}): "
          f"max|norm-f64 mirror| {dry['mirror_err']:.3e} (bar 1e-3), chained delta12 "
          f"{dry['delta12']} (pool, pool2 bytes equal), launches "
          f"{dry_launches}; per batch, inputs resident: full_step_frags "
          f"{ms['full_step_frags']:.3f} ms, run_step_pool2 {ms['run_step_pool2']:.3f} ms; "
          f"phase {wall:.1f} s; {smi()}")
    return {"nuc_scores": launches["nuc_scores"],
            "nuc_scores_sharded": sharded_launches["nuc_scores"],
            "nuc_scores_dryrun": dry_launches["nuc_scores"],
            "diag_xcorr_dryrun": dry_launches["diag_xcorr"], "ms": ms}


FORM = re.compile(r"^(occ|nuc)_step_(?:(.+)_)?(c|c2|c3|p2|m|m16|m24)$")


def _form_args(name: str, enc: dict, i: int) -> list:
    """Host arguments of a named download step or fused step on batch i of
    phase 5d's encodings: the wire's arrays, then the log-bias source
    (nibble codes on delta/delta12/pool, plain codes on packed_seq, else
    the f32 log-bias row), then emax on the pool wire."""
    if name.startswith("run_step_"):
        wire = name[len("run_step_"):]
        return enc[wire][i] + [enc["nib"][i]]
    branch, rest, _ = FORM.match(name).groups()
    rest = rest or "dense"
    wire = rest.replace("_seq", "")
    args = list(enc[wire][i]) if wire != "pool" else list(enc["pool"][i][:2])
    if branch == "nuc":
        last = {"delta_seq": "nib", "delta12_seq": "nib", "pool_seq": "nib",
                "packed_seq": "codes"}.get(rest, "log_bias")
        args.append(enc[last][i])
    return args + [enc["pool"][i][2]] if wire == "pool" else args


def _hold_form(name: str, got, want, cpu_out: dict, eng, bars: dict) -> None:
    """A named step's download on the card (got) against the same step on
    the CPU engine (want), at the CPU tests' bars (tests/test_torch_forms.py,
    tests/test_torch_transfer.py): occ grid indices equal wherever both
    certify (v1: the flag agrees on more than half); f32 norm forms within
    nuc.exact_tol; u16 forms within exact_tol + one step; u24 within
    exact_tol + 2^-16 |x| of the CPU's f32 norm x; the [B, 5, W] tracks at
    score_bars."""
    import numpy as np

    tol = eng.cfg.nuc.exact_tol
    g, w = got.cpu().numpy(), want.numpy()
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"forms: {name} {g.shape} {g.dtype}, cpu {w.shape} {w.dtype}")
    sfx = name.rsplit("_", 1)[1]
    if name.startswith("run_step_"):
        (gi, gc, gn, gq), (wi, wc, wn, wq) = eng.unpack_run(g), eng.unpack_run(w)
        idx, both = (gi, wi), gc & wc
        if not (np.abs(gn - wn) <= tol + np.maximum(gq, wq)[:, None]).all():
            raise AssertionError(f"forms: {name} norm past exact_tol + one u16 step")
    elif name.startswith("occ_"):
        if sfx == "c":
            both = (g[:, 3] == 1) & (w[:, 3] == 1)
            if (g[:, 3] == w[:, 3]).mean() <= 0.5:
                raise AssertionError(f"forms: {name} flags agree on half or less")
            idx = (g[:, :3], w[:, :3])
        elif sfx == "c3":
            both = (g[:, 0] >> 7).astype(bool) & (w[:, 0] >> 7).astype(bool)
            idx = (g & 0x7F, w & 0x7F)
        else:
            (gi, gc), (wi, wc) = eng.decode_occ2(g), eng.decode_occ2(w)
            idx, both = (gi, wi), gc & wc
    elif sfx in ("m", "c2"):
        hold(f"forms: {name}", got.cpu(), want, 0.0, tol)
        return
    elif sfx == "m16":
        (gn, gq), (wn, wq) = eng.f32_from_u16(g), eng.f32_from_u16(w)
        if not (np.abs(gn - wn) <= tol + np.maximum(gq, wq)[:, None]).all():
            raise AssertionError(f"forms: {name} past exact_tol + one u16 step")
        return
    elif sfx == "m24":
        x = cpu_out[name[:-2]].numpy()
        if not (np.abs(eng.f32_from_u24(g) - x) <= tol + 2.0 ** -16 * np.abs(x)).all():
            raise AssertionError(f"forms: {name} past exact_tol + 2^-16 |x|")
        return
    else:  # "c": norm, norm_smooth, signal, lr, fuzz
        for ch, (f, (rtol, atol)) in enumerate(bars.items()):
            hold(f"forms: {name} {f}", got[:, ch].cpu(), want[:, ch], rtol, atol)
        return
    if both.mean() < 0.5:
        raise AssertionError(f"forms: {name} certifies {both.mean():.3f} of the positions")
    for c in range(3):
        if not np.array_equal(idx[0][:, c][both], idx[1][:, c][both]):
            raise AssertionError(f"forms: {name} grid indices differ where both certify")


def phase_forms(data: dict, run5: dict, n_batches: int = 2) -> dict:
    """The rest of the reference's step API at full width: phase 5's first
    batches re-encoded on every wire (delta, delta12, packed, frags,
    dense, pool; [64, 251, 1536] rasters). Every named download step and
    both fused delta steps on the card through phase 5's engine; on the
    first batch each is held against the same step on a CPU engine at the
    CPU tests' bars (the CPU's plain path takes about half a second per nuc
    call, so one batch keeps the phase short). On the card, every batch:
    run_step_delta12, run_step_delta, run_step_pool and run_step_pool2
    print one set of bytes; _m24 decodes within 2^-16 relative of _m; the
    v1 _c indices equal the wire-v8 ones wherever both certify; one K2
    launch per nuc call. A diag_pallas engine runs every nuc step of the
    first batch: two K1 launches per call, no K2, the _m norms within
    exact_tol of the CPU's. Then the three fused steps timed per batch,
    inputs resident."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.io.fasta import FastaFile
    from nucleoatac_torch.models import data as tdata
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.nuc import SeqCodesProvider

    t_phase = time.perf_counter()
    cfg, eng = RunConfig(), run5["engine"]
    B, W = cfg.window.batch, eng.width
    cpu = TorchEngine(cfg, run5["mix"], run5["fs"], eng.vmat, pwm=eng.pwm, device="cpu")
    frags = scan_bam(data["bam"], cfg.ingest)
    chunks = ChunkList.read(data["bed"], frags.chrom_dict).merge()
    tiles = tdata.tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)[:n_batches * B]
    lo, up = cfg.sizes.lower, cfg.sizes.upper
    args = (frags, tiles, W, B)
    batches = {
        "delta": [([b.delta], b.meta) for b in tdata.make_delta_batches(*args)],
        "delta12": [([b.buf], b.meta) for b in tdata.make_delta12_batches(*args)],
        "packed": [([b.packed], b.meta) for b in tdata.make_packed_batches(*args)],
        "frags": [([b.mids, b.sizes, b.valid], b.meta) for b in tdata.make_batches(*args)],
        "dense": [([b.mats], b.meta) for b in tdata.make_dense_batches(*args, lo, up)],
    }
    metas = [m for _, m in batches["delta12"]]
    enc = {w: [a for a, _ in v] for w, v in batches.items()}
    enc["pool"] = [(pb.pool, pb.table, pb.emax) for m in metas
                   for pb in tdata.make_pool_batches(frags, m, W, B)]
    want = [list(m) for m in metas]
    if len(metas) != n_batches or any(len(m) != B for m in metas) or \
            len(enc["pool"]) != n_batches or \
            any([list(m) for _, m in v] != want for v in batches.values()):
        raise AssertionError("forms: the wires hold other windows than phase 5's "
                             "first batches")
    seq = SeqCodesProvider(FastaFile(data["fasta"]), chunks, eng, B)
    enc["codes"] = [seq.rows(m) for m in metas]
    enc["nib"] = [tdata.pack_nibble_codes(c) for c in enc["codes"]]
    enc["log_bias"] = [cpu._logbias_seq(torch.from_numpy(c)).numpy() for c in enc["codes"]]
    two_bit = [tdata.pack_2bit_codes(c) for c in enc["codes"]]
    if not all(ok for _, _, ok in two_bit):
        raise AssertionError("forms: a batch overflows the 2-bit escape list")

    forms = sorted(n for n in dir(TorchEngine) if FORM.match(n))
    names = forms + ["run_step_delta", "run_step_delta12"]
    nuc_names = [n for n in names if not n.startswith("occ_")]

    def t(a):  # an array on the card; emax stays an int
        return torch.as_tensor(a).to(eng.device) if isinstance(a, np.ndarray) else a

    # every step on the card, both batches; one K2 launch per nuc call
    reset_launches()
    steps0 = eng.steps
    card = [{n: getattr(eng, n)(*map(t, _form_args(n, enc, i))) for n in names}
            for i in range(n_batches)]
    fused = [[out[n] for n in ("run_step_delta12", "run_step_delta")]
             + [eng.run_step_pool(*map(t, enc["pool"][i][:2]), t(enc["nib"][i]),
                                  enc["pool"][i][2]),
                eng.run_step_pool2(*map(t, enc["pool"][i][:2]), t(two_bit[i][0]),
                                   t(two_bit[i][1]), enc["pool"][i][2])]
             for i, out in enumerate(card)]
    torch.cuda.synchronize()
    launches = read_launches()
    n_nuc = n_batches * (len(nuc_names) + 2)
    if launches != {"nuc_scores": n_nuc, "diag_xcorr": 0} or eng.steps - steps0 != n_nuc:
        raise AssertionError(f"forms: launches {launches}, {eng.steps - steps0} steps "
                             f"for {n_nuc} nuc calls")
    core = slice(eng.core_lo, eng.core_lo + eng.core)
    for i, out in enumerate(card):
        if not all(torch.equal(x, fused[i][0]) for x in fused[i][1:]):
            raise AssertionError("forms: run_step_delta12, run_step_delta, run_step_pool "
                                 "and run_step_pool2 differ")
        for n in [n for n in forms if n.endswith("_m24")]:
            dec = torch.from_numpy(eng.f32_from_u24(out[n].cpu().numpy()))
            hold(f"forms: {n} decoded", dec, out[n[:-2]].cpu(), 2.0 ** -16, 1e-30)
        for n in ("occ_step_c", "occ_step_delta_c", "occ_step_packed_c"):
            v1 = out[n].cpu().numpy()
            idx, cert = eng.decode_occ2(out[n[:-1] + "p2"].cpu().numpy())
            both = cert & (v1[:, 3, core] == 1)
            if both.mean() < 0.5 or any(
                    not np.array_equal(v1[:, c, core][both], idx[:, c][both])
                    for c in range(3)):
                raise AssertionError(f"forms: {n} differs from the wire-v8 picks")

    # the first batch of every step on the CPU engine, at the CPU tests' bars
    bars = score_bars(cfg.nuc.exact_tol)
    cpu_out = {n: getattr(cpu, n)(*_form_args(n, enc, 0)) for n in names}
    for n in names:
        _hold_form(n, card[0][n], cpu_out[n], cpu_out, eng, bars)

    # the K1 route: every nuc step of the first batch, two launches each
    dp = TorchEngine(cfg, run5["mix"], run5["fs"], eng.vmat, pwm=eng.pwm, device=CARD,
                     conv="diag_pallas")
    reset_launches()
    dp_out = {n: getattr(dp, n)(*map(t, _form_args(n, enc, 0))) for n in nuc_names}
    torch.cuda.synchronize()
    dp_launches = read_launches()
    if dp_launches != {"nuc_scores": 0, "diag_xcorr": 2 * len(nuc_names)}:
        raise AssertionError(f"forms: diag_pallas launches {dp_launches} for "
                             f"{len(nuc_names)} nuc calls")
    dp_err = max(hold(f"forms: diag_pallas {n}", dp_out[n].cpu(), cpu_out[n], 0.0,
                      cfg.nuc.exact_tol) for n in nuc_names if n.endswith("_m"))

    # one 64-window batch, inputs resident: the fused steps in one call
    res = {n: [t(a) for a in _form_args(n, enc, 0)]
           for n in ("run_step_delta12", "run_step_delta")}
    pool_args = [*map(t, enc["pool"][0][:2]), t(two_bit[0][0]), t(two_bit[0][1]),
                 enc["pool"][0][2]]
    ms = {n: cuda_ms(lambda n=n: getattr(eng, n)(*res[n])) for n in res}
    ms["run_step_pool2"] = cuda_ms(lambda: eng.run_step_pool2(*pool_args))
    wall = time.perf_counter() - t_phase
    phase("forms", f"{len(names)} steps ({len(nuc_names)} nuc) on {n_batches} batches of "
          f"{B} windows on every wire: held to the CPU engine on the first; delta12, "
          f"delta, pool, pool2 one set of bytes; _m24 within 2^-16 of _m; v1 picks equal "
          f"to v8's; launches {launches}; diag_pallas {dp_launches}, max|_m - cpu| "
          f"{dp_err:.3e}; per batch, inputs resident: run_step_delta12 "
          f"{ms['run_step_delta12']:.3f} ms, run_step_delta {ms['run_step_delta']:.3f} ms, "
          f"run_step_pool2 {ms['run_step_pool2']:.3f} ms; phase {wall:.1f} s; {smi()}")
    return {"nuc_scores": launches["nuc_scores"], "diag_xcorr": dp_launches["diag_xcorr"],
            "ms": ms, "wall_s": wall}


def phase_profiling(data: dict, run5: dict) -> dict:
    """The port's profilers on the card (nucleoatac_torch/profiling): the
    stage profile of phase 5's first batch through phase 5's engine
    (pool2 rows on K2, [64, 251, 1536] rasters), its trace of 8 batches
    with each replay's device time by stage (``replay_stages``: every
    replay matches the eager step's sequence, and the named stages sum to
    the replay's time within 1%, so that no op falls outside every stage;
    stages.replay_stages_fault), the same two-shard on [cuda:0, cuda:0],
    the K1 route's rows, and the finishing profile at 250 peaks. Returns
    each kernel's launches."""
    import torch

    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.parity import RUN_SUFFIXES
    from nucleoatac_torch.profiling import finish, stages

    t_phase = time.perf_counter()
    eng, n = run5["engine"], 8
    batch = stages.dataset_batch(eng, data["bam"], data["bed"], data["fasta"])
    reset_launches()
    reps, msgs = {}, []
    with tempfile.TemporaryDirectory() as d:
        engines = {
            "whole": eng,
            "two shards": TorchEngine(eng.cfg, run5["mix"], run5["fs"], eng.vmat,
                                      pwm=eng.pwm, device=[CARD, CARD]),
            "diag_pallas": TorchEngine(eng.cfg, run5["mix"], run5["fs"], eng.vmat,
                                       pwm=eng.pwm, device=CARD, conv="diag_pallas"),
        }
        for name, e in engines.items():
            rep = reps[name] = stages.profile_stages(e, batch, "pool2", iters=20,
                                                     trace_dir=d, trace_batches=n)
            bad = {k: r["ms"] for k, r in rep["rows"].items()
                   if not (math.isfinite(r["ms"]) and r["ms"] > 0)}
            if bad:
                raise AssertionError(f"profiling {name}: rows not finite and > 0: {bad}")
            if not rep["composed_equal"]:
                raise AssertionError(f"profiling {name}: composed stages' bytes differ")
            tr = rep["trace"]
            got = {k: stages.named_count(tr, f"{k}_kernel") for k in stages.KERNELS}
            want = ({"nuc_scores": 0, "diag_xcorr": 2 * n} if e.conv == "diag_pallas"
                    else {"nuc_scores": n * len(e.devices), "diag_xcorr": 0})
            want["occ_window"] = n * len(e.devices)  # K3 on either route
            want["bias_mat"] = n * len(e.devices)  # K4 on either route
            if got != want:
                raise AssertionError(f"profiling {name}: the trace of {n} batches names "
                                     f"{got}, expected {want}")
            rk = tr["replay_kernels"]
            if len(rk) != n * len(e.devices) or len(set(rk)) != 1:
                raise AssertionError(f"profiling {name}: the trace's {len(rk)} replays "
                                     f"ran {rk} kernels: records were lost")
            if len(e.devices) == 1 and rep["step_form"] != "eager":  # a replayed step
                fault = stages.replay_stages_fault(rep.get("replay_stages"), n)
                if fault:
                    raise AssertionError(f"profiling {name}: replay stages: {fault}")
            print(stages.format_report(rep), flush=True)
            print(json.dumps(rep), flush=True)
    whole = reps["whole"]
    rs = whole.get("replay_stages")
    if rs:
        msgs.append("pool2 replay by stage (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rs["stages_ms"].items())
            + "; outside the graph (ms/batch): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rs["outside"].items()))
    # the stage rows compose to the main path's own step on the same batch
    t = stages.resident(eng, batch)
    step = eng.run_step_pool2(t["pool"], t["table"], t["packed2"], t["esc"], t["emax"])
    rows = stages.stage_rows(eng, batch, "pool2")
    if not torch.equal(stages.composed(rows, "pool2"), step):
        raise AssertionError("profiling: composed stages differ from run_step_pool2's bytes")
    x = whole["rows"]["_xcorr"]
    if x["launches"]["nuc_scores"] != x["calls"]:
        raise AssertionError(f"profiling: K2 launched {x['launches']} in {x['calls']} calls")
    k1_rows = [r for r in reps["diag_pallas"]["rows"] if r.startswith("K1")]
    if len(k1_rows) != 2:
        raise AssertionError(f"profiling: K1 rows {k1_rows}")
    for name, rep in reps.items():
        tr = rep["trace"]
        gap = tr["gaps"][0] if tr["gaps"] else {"ms": 0.0, "host": None}
        msgs.append(f"{name}: stage sum {rep['stage_sum_ms']:.4f} ms vs e2e_device "
                    f"{rep['e2e_device_ms']:.4f} ms ({rep['step_form']}; eager chain "
                    f"{rep['e2e_eager_ms']:.4f} ms), enqueue {rep['enqueue_ms']:.4f} ms "
                    f"(eager {rep['enqueue_eager_ms']:.4f} ms), {tr['kernels_per_batch']:.1f} "
                    f"kernels/batch, {tr['graph_launches']} cudaGraphLaunch of "
                    f"{tr['replay_kernels'][0]} kernels each, busy "
                    f"{tr['busy_share']:.1%}, longest gap {gap['ms']:.4f} ms ({gap['host']})")
    with tempfile.TemporaryDirectory() as d:
        fin = finish.profile_finish(peaks=250, top=15, device=CARD, out_dir=d)
        missing = [sfx for sfx in RUN_SUFFIXES if not os.path.exists(fin["prefix"] + sfx)]
    if missing or set(fin["groups"]) != set(finish.GROUPS) or fin["fused_timers"] == {} \
            or min(fin["fused_timers"].values()) < 0:
        raise AssertionError(f"profiling: finish outputs missing {missing}, groups "
                             f"{fin['groups']}, timers {fin['fused_timers']}")
    print(json.dumps(fin), flush=True)
    launches = read_launches()
    phase("profiling", "; ".join(msgs) + f"; finish at 250 peaks {fin['wall_s']:.2f} s "
          f"({fin['ms_per_peak']:.2f} ms/peak), {len(RUN_SUFFIXES)} files; launches "
          f"{launches}; phase {time.perf_counter() - t_phase:.1f} s; {smi()}")
    return launches


def _same_bytes(what: str, replay, eager) -> None:
    """Raise, naming the first differing (window, column), unless a step
    program's replay printed the eager chain's bytes."""
    import torch

    if replay.shape != eager.shape or not torch.equal(replay, eager):
        diff = (replay != eager).nonzero().tolist() if replay.shape == eager.shape else []
        raise AssertionError(f"{what}: the replay's bytes differ from the eager chain's"
                             + (f" at (window, column) {tuple(diff[0])}, {len(diff)} bytes"
                                if diff else f": shapes {replay.shape} {eager.shape}"))


def _replayed(eng, name: str, args) -> object:
    """``eng``'s fused step ``name`` on ``args`` as a replay on every
    shard: a call that captured (its output is the eager warm-up's) is
    made again."""
    before = eng.programs.replays
    out = getattr(eng, name)(*args)
    if eng.programs.replays - before != len(eng.devices):
        before = eng.programs.replays
        out = getattr(eng, name)(*args)
        if eng.programs.replays - before != len(eng.devices):
            raise AssertionError(f"graphs: {name} did not replay on every shard")
    return out


def phase_graphs(data: dict, run5: dict, n_batches: int = 8) -> dict:
    """The fused steps as step programs (models/graphs.py), the
    counterpart of the reference's jit executables: phase 5's first
    batches, dispatched as the run dispatches them, through phase 5's
    engine: each replay of run_step_pool2 (run_step_pool where a batch
    overflows the escape list) byte-equal to the eager chain on the same
    device inputs, with no new capture (phase 5's run made at most 2);
    run_step_delta12 and run_step_delta on phase 5d's encodings of the
    first two batches against their eager chains and the pool2 bytes; one
    batch on a diag_pallas engine (K1 inside the graph) and on two shards
    of cuda:0. K2 == nuc steps (K1 == 2 x nuc steps on diag_pallas), the
    replays counted. Then e2e_device of the replay and of the eager chain
    in turns (CUDA events, the least of three rounds), the host's enqueue
    of each, two shards against one card, a trace of 8 steps of each form
    (kernels per batch, cudaGraphLaunch calls, busy share) and the bytes
    the graph pools reserve."""
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.io.fasta import FastaFile
    from nucleoatac_torch.models import data as tdata
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.nuc import SeqCodesProvider
    from nucleoatac_torch.profiling import stages

    t_phase = time.perf_counter()
    cfg, eng = RunConfig(), run5["engine"]
    B, W, dev = cfg.window.batch, eng.width, eng.device
    if not 0 < run5["captures"] <= 2:
        raise AssertionError(f"graphs: phase 5's run made {run5['captures']} captures")
    frags = scan_bam(data["bam"], cfg.ingest)
    chunks = ChunkList.read(data["bed"], frags.chrom_dict).merge()
    tiles = tdata.tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    seq = SeqCodesProvider(FastaFile(data["fasta"]), chunks, eng, B)
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    pools, batches = {}, []
    for pb in tdata.make_pool_batches(frags, tiles, W, B):
        if len(batches) == n_batches:
            break
        if pb.pool_id not in pools:
            pools[pb.pool_id] = t(pb.pool)
        pool = pools[pb.pool_id]
        codes = seq.rows(pb.meta)
        packed2, esc, ok = tdata.pack_2bit_codes(codes)
        batches.append(("run_step_pool2", (pool, t(pb.table), t(packed2), t(esc), pb.emax))
                       if ok else ("run_step_pool", (pool, t(pb.table),
                                                     t(tdata.pack_nibble_codes(codes)),
                                                     pb.emax)))
    eager = {"run_step_pool2": "_run_pool2", "run_step_pool": "_run_pool",
             "run_step_delta12": "_run_delta12", "run_step_delta": "_run_delta"}

    # phase 5's engine: every batch a replay, byte-equal to the eager chain
    progs = eng.programs
    reset_launches()
    steps0, cap0, rep0 = eng.steps, progs.captures, progs.replays
    outs = []
    for i, (name, args) in enumerate(batches):
        outs.append(getattr(eng, name)(*args))
        _same_bytes(f"graphs: batch {i} {name}", outs[-1], getattr(eng, eager[name])(*args))
    launches = read_launches()
    n = len(batches)
    if (launches, eng.steps - steps0, progs.captures - cap0, progs.replays - rep0) != \
            ({"nuc_scores": 2 * n, "diag_xcorr": 0}, 2 * n, 0, n):
        raise AssertionError(f"graphs: {n} batches replayed and run eagerly gave launches "
                             f"{launches}, {eng.steps - steps0} steps, "
                             f"{progs.captures - cap0} captures, {progs.replays - rep0} "
                             "replays")

    # the fused delta steps on phase 5d's encodings of the first two batches
    first = tiles[:2 * B]
    enc = {"run_step_delta12": [b.buf for b in tdata.make_delta12_batches(frags, first, W, B)],
           "run_step_delta": [b.delta for b in tdata.make_delta_batches(frags, first, W, B)]}
    nibs = [tdata.pack_nibble_codes(seq.rows(first[i * B:(i + 1) * B])) for i in range(2)]
    for name, bufs in enc.items():
        for i, (buf, nib) in enumerate(zip(bufs, nibs)):
            args = (t(buf), t(nib))
            got = _replayed(eng, name, args)
            _same_bytes(f"graphs: {name} batch {i}", got, getattr(eng, eager[name])(*args))
            _same_bytes(f"graphs: {name} batch {i} against pool2", got, outs[i])

    # K1 inside the graph; two shards on one card; their pools' bytes
    name, args0 = batches[0]
    reserved0 = torch.cuda.memory_reserved(dev)
    dp = TorchEngine(cfg, run5["mix"], run5["fs"], eng.vmat, pwm=eng.pwm, device=CARD,
                     conv="diag_pallas")
    reset_launches()
    _same_bytes(f"graphs: diag_pallas {name}", _replayed(dp, name, args0),
                getattr(dp, eager[name])(*args0))
    dp_launches = read_launches()
    if dp_launches != {"nuc_scores": 0, "diag_xcorr": 2 * dp.steps} or \
            dp.programs.captures != 1:
        raise AssertionError(f"graphs: diag_pallas launches {dp_launches} for {dp.steps} "
                             f"nuc steps, {dp.programs.captures} captures")
    sh = TorchEngine(cfg, run5["mix"], run5["fs"], eng.vmat, pwm=eng.pwm,
                     device=[CARD, CARD])
    whole = getattr(eng, eager[name])(*args0)  # one card's eager chain
    reset_launches()
    _same_bytes(f"graphs: two shards {name}", _replayed(sh, name, args0), whole)
    sh_launches = read_launches()
    if sh_launches != {"nuc_scores": sh.steps, "diag_xcorr": 0} or sh.programs.captures != 1:
        raise AssertionError(f"graphs: two shards launched {sh_launches} for {sh.steps} "
                             f"nuc steps, {sh.programs.captures} captures")
    reserved1 = torch.cuda.memory_reserved(dev)

    # e2e_device of each form in turns, the enqueue, the traces
    forms = {"replay": lambda: getattr(eng, name)(*args0),
             "eager": lambda: getattr(eng, eager[name])(*args0),
             "two shards": lambda: getattr(sh, name)(*args0)}
    rounds = {k: [] for k in forms}
    for _ in range(3):
        for k, fn in forms.items():
            rounds[k].append(cuda_ms(fn, iters=20))
    e2e = {k: min(v) for k, v in rounds.items()}
    enq = {k: stages.enqueue_ms(forms[k], 20, dev) for k in ("replay", "eager")}
    with tempfile.TemporaryDirectory() as d:
        tr = {k: stages.trace_steps(forms[k], 8, dev, d, f"graphs_{k}")
              for k in ("replay", "eager")}
    k2_named = {k: stages.named_count(v, "nuc_scores_kernel") for k, v in tr.items()}
    rk = tr["replay"]["replay_kernels"]
    if k2_named != {"replay": 8, "eager": 8} or len(rk) != 8 or len(set(rk)) != 1:
        raise AssertionError(f"graphs: the traces of 8 steps name K2 {k2_named} times, "
                             f"{len(rk)} cudaGraphLaunch calls of {rk} kernels")
    pool_mb = {k: e.programs.pool_bytes / 1e6 for k, e in
               (("phase 5", eng), ("diag_pallas", dp), ("two shards", sh))}
    wall = time.perf_counter() - t_phase
    phase("graphs", f"phase 5's run {run5['captures']} captures, {run5['replays']} replays; "
          f"{n} batches of {B} windows: replay == eager bytes ({dict(launches)}, no new "
          f"capture); run_step_delta12 and run_step_delta replays == eager == pool2 on 2 "
          f"batches; diag_pallas {dp_launches} and two shards on {CARD} {sh_launches} "
          f"replays == eager; graph pools {', '.join(f'{k} {v:.1f} MB' for k, v in pool_mb.items())}"
          f", memory_reserved {reserved0 / 1e6:.1f} -> {reserved1 / 1e6:.1f} MB over the "
          f"diag_pallas and two-shard captures; e2e_device (least of 3 rounds of 20) replay "
          f"{e2e['replay']:.4f} ms, eager {e2e['eager']:.4f} ms, two shards replayed "
          f"{e2e['two shards']:.4f} ms ({e2e['two shards'] / e2e['replay']:.2f}x one card); "
          f"enqueue replay {enq['replay']:.4f} ms, eager {enq['eager']:.4f} ms; trace of 8: "
          f"replay {tr['replay']['kernels_per_batch']:.1f} kernels/batch, "
          f"{tr['replay']['graph_launches']} cudaGraphLaunch of {rk[0]} kernels each, busy "
          f"{tr['replay']['busy_share']:.1%}; eager {tr['eager']['kernels_per_batch']:.1f} "
          f"kernels/batch, busy {tr['eager']['busy_share']:.1%}; phase {wall:.1f} s; {smi()}")
    return {"nuc_scores": launches["nuc_scores"] + sh_launches["nuc_scores"],
            "diag_xcorr": dp_launches["diag_xcorr"], "e2e_ms": e2e, "enqueue_ms": enq,
            "busy": {k: v["busy_share"] for k, v in tr.items()}, "wall_s": wall}


def phase_parity() -> None:
    """The same small run on cuda and on cpu (plain versions): equal rows,
    signal tracks within nuc.exact_tol (parity.compare_runs)."""

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import compare_runs

    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    with tempfile.TemporaryDirectory() as d:
        ex = make_example(d)
        for dev in ("cuda", "cpu"):
            run_pipeline(ex["bam"], ex["bed"], os.path.join(d, dev),
                         fasta_path=ex["fasta"], cfg=cfg, write_plots=False,
                         device=dev)
        stats = compare_runs(os.path.join(d, "cuda"), os.path.join(d, "cpu"),
                             cfg.nuc.exact_tol)
    sig = {k.split(" ")[0]: v for k, v in stats.items()
           if k.endswith("max_abs_diff")}
    phase("parity", f"cuda vs cpu on make_example data: "
          f"{sum(1 for k in stats if 'max_abs_diff' not in k)} files row-equal, "
          f"signal max|cuda-cpu| {sig} (nuc.exact_tol {cfg.nuc.exact_tol})")


def phase_stages(data: dict, run5: dict) -> int:
    """The standalone stages through the command line, on the card, at
    full width: the two-pass delta12 path must print phase 5's rows.
    Returns the nuc stage's K2 launches."""
    import torch

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.parity import RUN_SUFFIXES

    prefix = os.path.join(data["dir"], "stages")
    # delta12 batches fill up across chunks; the fused pass's pool batches
    # end with each group of chunks, so it can have more
    batches = -(-run5["windows"] // RunConfig().window.batch)
    base = ["--bed", data["bed"], "--bam", data["bam"], "--fasta", data["fasta"],
            "--out", prefix, "--device", CARD, "--no_plots"]
    walls = {}
    for cmd in ("occ", "nuc"):
        reset_launches()
        t0 = time.perf_counter()
        if nucleoatac([cmd, *base]) != 0:
            raise AssertionError(f"nucleoatac-torch {cmd} failed")
        torch.cuda.synchronize()
        walls[cmd] = time.perf_counter() - t0
        launches = read_launches()
        want = {"diag_xcorr": 0, "nuc_scores": batches if cmd == "nuc" else 0}
        if launches != want:
            raise AssertionError(f"{cmd}: launches {launches}, expected {want}")
    if nucleoatac(["merge", "--occpeaks", prefix + ".occpeaks.bed.gz",
                   "--nucpos", prefix + ".nucpos.bed.gz", "--out", prefix]) != 0:
        raise AssertionError("nucleoatac-torch merge failed")
    if nucleoatac(["nfr", *base]) != 0:
        raise AssertionError("nucleoatac-torch nfr failed")
    rows = sum(same_rows(run5["prefix"] + sfx, prefix + sfx) for sfx in RUN_SUFFIXES)
    w = run5["windows"]
    phase("stages", f"occ {walls['occ']:.2f} s = {w / walls['occ']:.1f} windows/s, "
          f"nuc {walls['nuc']:.2f} s = {w / walls['nuc']:.1f} windows/s "
          f"({batches} K2 launches for {batches} batches); {len(RUN_SUFFIXES)} "
          f"files, {rows} rows "
          "equal to the fused run")
    return batches


def phase_conv(data: dict, run5: dict) -> int:
    """The K1 route: run_pipeline with conv="diag_pallas". Returns K1's
    launch count."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch
    from nucleoatac_torch.ops.xcorr import finish_scores, pad_valid
    from nucleoatac_torch.parity import compare_runs

    cfg = RunConfig(window=WindowParams(conv="diag_pallas"))
    prefix = os.path.join(data["dir"], "conv")
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                       cfg=cfg, write_plots=False, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = res.engine.steps
    if steps != run5["steps"] or launches != {"diag_xcorr": 2 * steps, "nuc_scores": 0}:
        raise AssertionError(f"conv: launches {launches} for {steps} batches "
                             f"(phase 5: {run5['steps']})")
    # each route rounds its own f32 norm to its own u16 level
    step = max(run5["max_qstep"], res.nuc_stage.max_qstep)
    tol = cfg.nuc.exact_tol + step
    stats = compare_runs(run5["prefix"], prefix, tol)
    sig = {k.split(" ")[0]: v for k, v in stats.items() if k.endswith("max_abs_diff")}

    # the K1 route's norm on one production batch against float64
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    mat, logb = _synthetic_batch(dev, cfg.window.batch, W, rng)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=dev)
    b0 = bias_mat_batch(logb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo)
    fmat = mat[:, cfg.vmat.lower - cfg.sizes.lower:]
    tabs = _template_tables(dev)
    K = tabs[0].shape[1]
    fo, bo = k1.nuc_conv_outputs(fmat, b0, *tabs)
    norm = finish_scores(pad_valid(fo, W, K), pad_valid(bo, W, K),
                         cfg.nuc.var_floor).norm
    ref64 = k2.nuc_scores_plain(fmat.double(), b0.double(),
                                *_template_tables(dev, torch.float64),
                                cfg.nuc.var_floor)[:, 0]
    err = float((norm.double() - ref64).abs().max())
    if err > cfg.nuc.exact_tol:
        raise AssertionError(f"K1 route max|norm - f64| {err:.3e} > "
                             f"nuc.exact_tol {cfg.nuc.exact_tol}")
    w = run5["windows"]
    phase("conv", f"diag_pallas run_pipeline {wall:.2f} s = {w / wall:.1f} "
          f"windows/s; launches {launches} for {steps} batches; against phase 5: "
          f"{sum(1 for k in stats if 'max_abs_diff' not in k)} files row-equal, "
          f"signal max|K1 route - K2 route| {sig} (bar exact_tol + step = "
          f"{tol:.3e}); K1 route max|norm-f64| {err:.3e} on a production batch")
    return launches["diag_xcorr"]


def _spy_pipeline():
    """Wrap run_pipeline and run_fused of models/pipeline.py so that a run
    made through the command line hands back its RunResult and config, and
    each run records whether it took the fused pass. Returns (seen, undo)."""
    from nucleoatac_torch.models import pipeline

    seen = {"fused": 0}
    real_run, real_fused = pipeline.run_pipeline, pipeline.run_fused

    def run(*a, **k):
        seen["res"], seen["cfg"] = real_run(*a, **k), k["cfg"]
        return seen["res"]

    def fused(*a, **k):
        seen["fused"] += 1
        return real_fused(*a, **k)

    pipeline.run_pipeline, pipeline.run_fused = run, fused

    def undo():
        pipeline.run_pipeline, pipeline.run_fused = real_run, real_fused

    return seen, undo


def _wires_upper500(data: dict) -> tuple:
    """`nucleoatac-torch run --upper 500` at full width on phase 5's peaks
    with 10% di-nucleosomal fragments: the packed fallback on the card."""
    import numpy as np
    import torch

    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.device import to_device
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.models.data import make_packed_batches, tile_chunks
    from nucleoatac_torch.ops.occupancy import _ll_and_n
    from nucleoatac_torch.parity import RUN_SUFFIXES, read_rows

    wd = os.path.join(data["dir"], "wires")
    os.makedirs(wd)
    t0 = time.perf_counter()
    bam, bed, fa = synth_dataset(wd, 4, data["n_peaks"], 2000, 2000, dinuc=0.1)
    t_data = time.perf_counter() - t0
    prefix = os.path.join(wd, "upper500")
    seen, undo = _spy_pipeline()
    try:
        reset_launches()
        t0 = time.perf_counter()
        rc = nucleoatac(["run", "--bed", bed, "--bam", bam, "--fasta", fa, "--out", prefix,
                         "--upper", "500", "--device", CARD, "--no_plots"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        undo()
    res, cfg = seen["res"], seen["cfg"]
    steps = res.engine.steps
    if rc != 0 or (cfg.window.transfer, cfg.sizes.upper) != ("packed", 500) or seen["fused"]:
        raise AssertionError(f"upper 500: rc {rc}, {cfg.window}, fused {seen['fused']}")
    if steps == 0 or launches != {"diag_xcorr": 0, "nuc_scores": steps}:
        raise AssertionError(f"upper 500: launches {launches} for {steps} batches")
    for sfx in RUN_SUFFIXES:
        for path in (prefix + sfx, prefix + sfx + ".tbi"):
            if not os.path.exists(path):
                raise AssertionError(f"upper 500: missing output {path}")
    if res.occ_stage.n_spot_checked == 0:
        raise AssertionError("upper 500: the occ spot-check guard did not run")
    occ = [float(r[3]) for r in read_rows(prefix + ".occpeaks.bed.gz")]
    if not res.nuc.calls or not occ or not all(0.0 <= v <= 1.0 for v in occ):
        raise AssertionError("upper 500: no dyad calls, or occ peaks out of [0, 1]")
    size, count = np.loadtxt(prefix + ".fragmentsizes.txt").T
    past = int(count[size > 255].sum())
    if len(size) != 500 or past == 0:
        raise AssertionError(f"upper 500: {len(size)} sizes, {past} fragments past 255")
    # the occupancy LL of the run's first batch at S = 500 against float64
    eng = res.engine
    tiles = tile_chunks(res.occ.chunks, cfg.window, cfg.occ, cfg.vmat)
    b = next(make_packed_batches(scan_bam(bam, cfg.ingest), tiles[:cfg.window.batch],
                                 eng.width, cfg.window.batch))
    mat = eng._raster_packed(to_device(b.packed, eng.device))
    lm = eng.tables["log_mix"]
    ll, _ = _ll_and_n(mat, lm, cfg.occ.flank)
    ll64, _ = _ll_and_n(mat.double(), lm.double(), cfg.occ.flank)
    ll_err = float((ll.double() - ll64).abs().max())
    if ll_err > cfg.occ.exact_tol:
        raise AssertionError(f"upper 500: max|LL - f64| {ll_err:.3e} > occ.exact_tol")
    windows = len(tiles)
    nbytes = 4 * mat.numel()
    msg = (f"--upper 500 (packed fallback) at full width: {windows} windows, {steps} "
           f"batches, run {wall:.2f} s = {windows / wall:.1f} windows/s (data synthesis "
           f"{t_data:.1f} s, not timed); {past} fragments past 255 bp in the fit; "
           f"raster {list(mat.shape)} f32 = {nbytes / 1e6:.1f} MB per batch; "
           f"max|LL-f64| {ll_err:.3e} at max|LL| {float(ll64.abs().max()):.1f} "
           f"(occ.exact_tol {cfg.occ.exact_tol}); {len(res.nuc.calls)} dyads; "
           f"launches {launches}")
    return msg, {"nuc_scores": launches["nuc_scores"]}


def _wires_full(data: dict, run5: dict) -> tuple:
    """Phase 5's dataset on the delta, delta12 and packed wires, which run
    the two passes: every file equal to phase 5's rows."""
    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models import pipeline
    from nucleoatac_torch.parity import RUN_SUFFIXES

    msgs, paths = [], {}
    for wire in ("delta", "delta12", "packed"):
        cfg = RunConfig(window=WindowParams(transfer=wire))
        prefix = os.path.join(data["dir"], f"wire_{wire}")
        seen, undo = _spy_pipeline()
        try:
            reset_launches()
            t0 = time.perf_counter()
            res = pipeline.run_pipeline(data["bam"], data["bed"], prefix,
                                        fasta_path=data["fasta"], cfg=cfg,
                                        write_plots=False, device=CARD)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        finally:
            undo()
        steps = res.engine.steps
        if seen["fused"] or steps == 0 or launches != {"diag_xcorr": 0, "nuc_scores": steps}:
            raise AssertionError(f"{wire}: fused {seen['fused']}, launches {launches} "
                                 f"for {steps} batches")
        for sfx in RUN_SUFFIXES:
            same_rows(run5["prefix"] + sfx, prefix + sfx)
        paths[f"wires_{wire}"] = launches["nuc_scores"]
        msgs.append(f"{wire} two passes {wall:.2f} s = "
                    f"{run5['windows'] / wall:.1f} windows/s, {steps} K2 launches, ten "
                    "files equal to phase 5")
    return "; ".join(msgs), paths


def _wires_direct(data: dict, run5: dict) -> str:
    """conv="direct" at full width on phase 5's dataset against phase 5,
    and the route's norm on a production batch against float64."""
    import numpy as np
    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.core.vmat import VMat
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.biasmat import bias_mat_batch
    from nucleoatac_torch.ops.xcorr import (
        build_kernels,
        finish_scores,
        nuc_conv_outputs_direct,
        pad_valid,
    )
    from nucleoatac_torch.parity import compare_runs

    cfg = RunConfig(window=WindowParams(conv="direct"))
    prefix = os.path.join(data["dir"], "direct")
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                       cfg=cfg, write_plots=False, device=CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine.steps != run5["steps"] or launches != {"diag_xcorr": 0, "nuc_scores": 0}:
        raise AssertionError(f"direct: launches {launches} for {res.engine.steps} batches")
    tol = cfg.nuc.exact_tol + max(run5["max_qstep"], res.nuc_stage.max_qstep)
    stats = compare_runs(run5["prefix"], prefix, tol)
    sig = {k.split(" ")[0]: v for k, v in stats.items() if k.endswith("max_abs_diff")}
    # the route's norm on one production batch against float64
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    W = cfg.window.width(cfg.occ, cfg.vmat)
    halo = cfg.window.halo(cfg.occ, cfg.vmat)
    mat, logb = _synthetic_batch(dev, cfg.window.batch, W, rng)
    q = rng.random(cfg.vmat.upper - cfg.vmat.lower)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=dev)
    b0 = bias_mat_batch(logb, q, cfg.vmat.lower, cfg.vmat.upper, halo, W - halo)
    fmat = mat[:, cfg.vmat.lower - cfg.sizes.lower:]
    fk, bk = (torch.as_tensor(t, device=dev)
              for t in build_kernels(VMat.default().mat, cfg.nuc.v_floor))
    K = fk.shape[2]

    def direct_norm():
        fo, bo = nuc_conv_outputs_direct(fmat, b0, fk, bk)
        return finish_scores(pad_valid(fo, W, K), pad_valid(bo, W, K),
                             cfg.nuc.var_floor).norm

    ref64 = k2.nuc_scores_plain(fmat.double(), b0.double(),
                                *_template_tables(dev, torch.float64),
                                cfg.nuc.var_floor)[:, 0]
    err = float((direct_norm().double() - ref64).abs().max())
    if err > cfg.nuc.exact_tol:
        raise AssertionError(f"direct route max|norm - f64| {err:.3e} > nuc.exact_tol")
    tabs = _template_tables(dev)
    ms = cuda_ms(direct_norm)
    k2_ms = cuda_ms(lambda: k2.nuc_scores(fmat, b0, *tabs, cfg.nuc.var_floor))
    return (f"direct (two conv1d, cuDNN, TF32 off): run {wall:.2f} s = "
            f"{run5['windows'] / wall:.1f} windows/s, no kernel launch, "
            f"{res.engine.steps} batches; against phase 5: "
            f"{sum(1 for k in stats if 'max_abs_diff' not in k)} files row-equal, signal "
            f"max|direct - K2 route| {sig} (bar exact_tol + step = {tol:.3e}); max|norm-f64| "
            f"{err:.3e} on a production batch; {ms:.4f} ms per batch (convolutions + "
            f"epilogue) against K2's {k2_ms:.4f} ms")


def _wires_small() -> tuple:
    """Every wire at make_example size on the card, each xcorr kernel route,
    against the CPU run on the same wire; the packed wire again at
    --upper 300 on the long-fragment example."""
    import dataclasses

    from nucleoatac_torch.config import RunConfig, SizesParams, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import compare_runs

    base = RunConfig(window=WindowParams(core=256, batch=4))
    cases = [(w, 251) for w in ("delta", "delta12", "frags", "dense", "packed")]
    cases.append(("packed", 300))
    paths = {"nuc_scores": {}, "diag_xcorr": {}}
    worst = {}
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "long"))
        exs = {251: make_example(d), 300: make_long_example(os.path.join(d, "long"))}
        for wire, upper in cases:
            ex, name = exs[upper], f"{wire}_upper{upper}" if upper != 251 else wire
            out = {}
            for dev, conv in (("cpu", "diag"), ("cuda", "diag"), ("cuda", "diag_pallas")):
                c = dataclasses.replace(base, sizes=SizesParams(upper=upper),
                                        window=dataclasses.replace(
                                            base.window, transfer=wire, conv=conv))
                prefix = os.path.join(d, f"{name}_{dev}_{conv}")
                reset_launches()
                res = run_pipeline(ex["bam"], ex["bed"], prefix, fasta_path=ex["fasta"],
                                   cfg=c, write_plots=False, device=dev)
                got, steps = read_launches(), res.engine.steps
                if dev == "cuda":
                    kernel, per = (("nuc_scores", 1) if conv == "diag" else ("diag_xcorr", 2))
                    want = {"nuc_scores": 0, "diag_xcorr": 0, kernel: per * steps}
                    if steps == 0 or got != want:
                        raise AssertionError(f"{name} {conv}: launches {got} for {steps}")
                    paths[kernel][f"wires_small_{name}"] = got[kernel]
                out[(dev, conv)] = (prefix, res.nuc_stage.max_qstep)
            # each device rounds its own f32 norm to its own u16 level
            cpu, q_cpu = out[("cpu", "diag")]
            for conv in ("diag", "diag_pallas"):
                prefix, q = out[("cuda", conv)]
                stats = compare_runs(prefix, cpu, base.nuc.exact_tol + max(q, q_cpu))
                worst[f"{name} {conv}"] = max(
                    v for k, v in stats.items() if k.endswith("max_abs_diff"))
    msg = ("make_example size, cuda (K2 and K1 routes) against cpu, signal "
           "max|cuda-cpu| " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return msg, paths


def phase_wires(data: dict, run5: dict) -> dict:
    """The wires beside pool and the direct route, on the card. Returns
    each kernel's launches on each path."""
    msgs, paths = [], {"nuc_scores": {}, "diag_xcorr": {}}
    msg, p = _wires_upper500(data)
    msgs.append(msg)
    paths["nuc_scores"]["wires_upper500_packed"] = p["nuc_scores"]
    msg, p = _wires_full(data, run5)
    msgs.append(msg)
    paths["nuc_scores"].update(p)
    msgs.append(_wires_direct(data, run5))
    msg, p = _wires_small()
    msgs.append(msg)
    for k in paths:
        paths[k].update(p[k])
    phase("wires", "; ".join(msgs) + f" on {smi()}")
    return paths


def phase_resume_bias() -> None:
    """--resume and --bias_track through the command lines, on the card,
    on make_example data."""
    import gzip

    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.cli.pyatac import main as pyatac
    from nucleoatac_torch.parity import read_rows

    def text(path):
        with gzip.open(path, "rb") as fh:
            return fh.read()

    with tempfile.TemporaryDirectory() as d:
        ex = make_example(d)
        common = ["--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                  "--batch", "4", "--device", CARD, "--no_plots"]
        run, via, bias = (os.path.join(d, n) for n in ("run", "via", "b"))
        if nucleoatac(["run", *common, "--out", run]) != 0:
            raise AssertionError("run failed")
        first = {s: text(run + s) for s in (".nucpos.bed.gz", ".nfrpos.bed.gz")}
        if nucleoatac(["run", *common, "--out", run, "--resume"]) != 0:
            raise AssertionError("run --resume failed")
        for sfx, want in first.items():
            if text(run + sfx) != want:
                raise AssertionError(f"--resume changed {sfx}")
        if pyatac(["bias", "--fasta", ex["fasta"], "--bed", ex["bed"], "--out", bias]) != 0:
            raise AssertionError("pyatac-torch bias failed")
        if nucleoatac(["run", *common, "--out", via,
                       "--bias_track", bias + ".Scores.bedgraph.gz"]) != 0:
            raise AssertionError("run --bias_track failed")
        a = [r[1] for r in read_rows(run + ".nucpos.bed.gz")]
        b = [r[1] for r in read_rows(via + ".nucpos.bed.gz")]
        if not a or a != b:
            raise AssertionError(f"--bias_track dyads {b} != FASTA run {a}")
        if text(run + ".occ.bedgraph.gz") != text(via + ".occ.bedgraph.gz"):
            raise AssertionError("--bias_track changed the occ bedgraph")
    phase("resume+bias", f"run --resume: nucpos and nfrpos identical; "
          f"run --bias_track: {len(a)} dyads identical, occ bedgraph identical")


def phase_pyatac(data: dict) -> None:
    """`pyatac-torch vplot --device` on the card against the host loop."""
    from nucleoatac_torch.core.vmat import VMat
    from nucleoatac_torch.cli.pyatac import main as pyatac

    mats = {}
    for name, extra in (("host", []), ("card", ["--device"])):
        out = os.path.join(data["dir"], f"vplot_{name}")
        t0 = time.perf_counter()
        if pyatac(["vplot", "--bam", data["bam"], "--bed", data["bed"], "--out", out,
                   "--no_plots", *extra]) != 0:
            raise AssertionError(f"pyatac-torch vplot ({name}) failed")
        mats[name] = (VMat.open(out + ".VMat").mat, time.perf_counter() - t0)
    (host, t_host), (card, t_card) = mats["host"], mats["card"]
    if host.sum() == 0 or not (card == host).all():
        raise AssertionError("vplot --device differs from the host aggregate")
    phase("pyatac", f"vplot --device equals the host aggregate over "
          f"{data['n_peaks']} sites ({int(host.sum())} fragments); "
          f"{t_card:.2f} s vs host {t_host:.2f} s (ingest included)")


HOST_RANK = """
import json, sys, time
sys.modules["jax"] = None
from nucleoatac_torch.models import distributed_pipeline as dp
from nucleoatac_torch.ops import diag_xcorr as k1
from nucleoatac_torch.ops import nuc_scores as k2
bam, bed, fasta, prefix, report = sys.argv[1:6]
finalize = dp.finalize_shards
t_fin = []

def timed_finalize(*a, **k):
    t = time.perf_counter()
    finalize(*a, **k)
    t_fin.append(time.perf_counter() - t)

dp.finalize_shards = timed_finalize
k1.LAUNCHES = k2.LAUNCHES = 0
t0 = time.perf_counter()
dp.run_distributed(bam, bed, prefix, fasta_path=fasta, device="cuda")
wall = time.perf_counter() - t0
with open(report, "w") as fh:
    json.dump({"nuc_scores": k2.LAUNCHES, "diag_xcorr": k1.LAUNCHES,
               "wall": wall, "finalize": t_fin}, fh)
"""


def _wait_ranks(procs, timeout: float) -> None:
    """Wait for every rank; the first to fail (or the deadline) kills the
    rest and fails the phase."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            out = p.stdout.read().decode(errors="replace") if p.stdout else ""
            raise AssertionError(f"rank {rank} exited {p.returncode}:\n{out[-4000:]}")


def phase_hosts(data: dict, run5: dict) -> dict:
    """The multi-host run on the card: two gloo ranks sharing cuda:0 on
    phase 5's dataset, then the external-launcher form on synthetic data.
    Returns each kernel's launches summed over the ranks."""
    import gzip
    import socket

    import numpy as np

    from nucleoatac_torch.config import RunConfig
    from nucleoatac_torch.core.chunk import ChunkList
    from nucleoatac_torch.io.bam import scan_bam
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.parallel.distributed import host_tile_slice
    from nucleoatac_torch.parity import RUN_SUFFIXES

    cfg = RunConfig()
    prefix = os.path.join(data["dir"], "hosts")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs, reports = [], []
    t0 = time.perf_counter()
    for rank in (0, 1):
        reports.append(os.path.join(data["dir"], f"hosts_rank{rank}.json"))
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(rank), PYTHONPATH=ROOT)
        env.pop("LOCAL_RANK", None)  # both ranks share the one card
        procs.append(subprocess.Popen(
            [sys.executable, "-c", HOST_RANK, data["bam"], data["bed"],
             data["fasta"], prefix, reports[-1]],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    _wait_ranks(procs, timeout=400)
    wall = time.perf_counter() - t0
    reps = [json.load(open(r)) for r in reports]
    # each rank's nuc batches: its chunk slice's windows in delta12
    # batches, which fill up across chunks
    frags = scan_bam(data["bam"], cfg.ingest)
    chunks = ChunkList.read(data["bed"], frags.chrom_dict).merge()
    batches = [
        -(-len(tile_chunks(ChunkList(host_tile_slice(chunks.chunks, r, 2)),
                           cfg.window, cfg.occ, cfg.vmat)) // cfg.window.batch)
        for r in (0, 1)
    ]
    launches = {k: sum(r[k] for r in reps) for k in ("nuc_scores", "diag_xcorr")}
    if launches != {"nuc_scores": sum(batches), "diag_xcorr": 0}:
        raise AssertionError(f"hosts: launches {launches} for batches {batches}")
    if len(reps[0]["finalize"]) != 1 or reps[1]["finalize"]:
        raise AssertionError("hosts: rank 0 alone must finalize")
    rows = sum(same_rows(run5["prefix"] + sfx, prefix + sfx) for sfx in RUN_SUFFIXES)
    if not (np.loadtxt(prefix + ".nuc_dist.txt") == np.loadtxt(run5["prefix"] + ".nuc_dist.txt")).all():
        raise AssertionError("hosts: nuc_dist differs from phase 5")
    if any(".part" in f for f in os.listdir(data["dir"])):
        raise AssertionError("hosts: shard files left after finalize")

    # the external-launcher form: hosts in turn, then --finalize
    with tempfile.TemporaryDirectory() as d:
        ex = make_example(d)
        with open(ex["bed"], "a") as fh:
            fh.write("chr1\t3600\t5600\tpeak2\n")
        base = ["run", "--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                "--batch", "4", "--device", CARD, "--no_plots"]
        one, ext = os.path.join(d, "one"), os.path.join(d, "ext")
        calls = [[*base, "--out", one]]
        calls += [[*base, "--out", ext, "--num_hosts", "2", "--host_id", k] for k in "01"]
        calls += [[*base, "--out", ext, "--num_hosts", "2", "--finalize"]]
        for argv in calls:
            if nucleoatac(argv) != 0:
                raise AssertionError(f"nucleoatac-torch {' '.join(argv[-3:])} failed")
        for sfx in RUN_SUFFIXES:
            with gzip.open(one + sfx) as x, gzip.open(ext + sfx) as y:
                if x.read() != y.read():
                    raise AssertionError(f"external launcher {sfx} differs from one process")
    w = run5["windows"]
    slowest = max(r["wall"] for r in reps)
    phase("hosts", f"2 gloo ranks on cuda:0, {batches} delta12 batches: "
          f"{launches['nuc_scores']} K2 launches; slowest rank {slowest:.2f} s "
          f"(finalize {reps[0]['finalize'][0]:.2f} s of it) = {w / slowest:.1f} "
          f"windows/s; phase wall with process start {wall:.2f} s = "
          f"{w / wall:.1f} windows/s; {len(RUN_SUFFIXES)} files, {rows} rows and "
          "nuc_dist equal to phase 5; external launcher + --finalize on "
          "make_example data byte-equal to one process")
    return launches


def _nuc5_plain(eng, mat, log_bias):
    """The plain route of TorchEngine._nuc5 on the same inputs: K2's plain
    version, its channels reordered, norm smoothed."""
    import torch

    from nucleoatac_torch.ops.nuc_scores import nuc_scores_plain
    from nucleoatac_torch.ops.smooth import gauss_smooth_batch

    c = eng.cfg
    fmat = mat[:, c.vmat.lower - c.sizes.lower:c.vmat.upper - c.sizes.lower].contiguous()
    p = nuc_scores_plain(fmat, eng._bias(log_bias), *eng.tables["_diag_kernels"],
                         c.nuc.var_floor)
    smooth = gauss_smooth_batch(p[:, 0], eng.tables["smooth_kernel"])
    return torch.stack([p[:, 0], smooth, p[:, 1], p[:, 2], p[:, 3]], dim=1)


def phase_nonexact(data: dict) -> dict:
    """Non-exact mode on the card, both xcorr routes. Returns each
    kernel's launches on its route's run."""
    import dataclasses

    import torch

    from nucleoatac_torch.config import RunConfig, WindowParams
    from nucleoatac_torch.models.data import tile_chunks
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import compare_runs_nonexact, read_rows

    def nonexact(cfg, conv):
        return dataclasses.replace(
            cfg, window=dataclasses.replace(cfg.window, conv=conv),
            occ=dataclasses.replace(cfg.occ, exact=False),
            nuc=dataclasses.replace(cfg.nuc, exact=False))

    # keep the first (full, [64, 251, 1536]) batch each run sends through
    # _nuc5, with what _nuc5 returned for it
    real_nuc5, first = TorchEngine._nuc5, {}

    def keep_first(eng, mat, log_bias):
        out = real_nuc5(eng, mat, log_bias)
        if not first:
            first.update(eng=eng, mat=mat.clone(), logb=log_bias.clone(), out=out.clone())
        return out

    launches, msgs = {}, []
    for conv, kernel, per_batch in (("diag", "nuc_scores", 1),
                                    ("diag_pallas", "diag_xcorr", 2)):
        cfg = nonexact(RunConfig(), conv)
        prefix = os.path.join(data["dir"], f"nonexact_{conv}")
        first.clear()
        TorchEngine._nuc5 = keep_first
        try:
            reset_launches()
            t0 = time.perf_counter()
            res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                               cfg=cfg, write_plots=False, device=CARD)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_launches()
        finally:
            TorchEngine._nuc5 = real_nuc5
        # the run's own _nuc5 output on its first batch against the plain
        # route on the same inputs, every channel at its bar
        if not first or first["mat"].shape[0] != cfg.window.batch:
            raise AssertionError(f"nonexact {conv}: no full batch went through _nuc5")
        plain5 = _nuc5_plain(first["eng"], first["mat"], first["logb"])
        bars = score_bars(cfg.nuc.exact_tol)
        batch_err = {c: hold(f"nonexact {conv} _nuc5 {c} vs plain", first["out"][:, i],
                             plain5[:, i], *bars[c])
                     for i, c in enumerate(("norm", "norm_smooth", "signal", "lr", "fuzz"))}
        if float(plain5.abs().amax(dim=(0, 2)).min()) <= 0:
            raise AssertionError(f"nonexact {conv}: a _nuc5 channel is all zero")
        first.clear()
        steps = res.engine.steps
        want = {"nuc_scores": 0, "diag_xcorr": 0}
        want[kernel] = per_batch * steps
        if steps == 0 or got != want:
            raise AssertionError(f"nonexact {conv}: launches {got} for {steps} batches")
        if res.nuc_stage.refinisher is not None or not res.nuc.calls:
            raise AssertionError(f"nonexact {conv}: refinisher present or no dyads")
        occ = [float(r[3]) for r in read_rows(prefix + ".occ.bedgraph.gz")]
        if not occ or not all(0.0 <= v <= 1.0 for v in occ):
            raise AssertionError(f"nonexact {conv}: occ out of [0, 1]")
        launches[kernel] = got[kernel]
        windows = len(tile_chunks(res.occ.chunks, cfg.window, cfg.occ, cfg.vmat))

        small = nonexact(RunConfig(window=WindowParams(core=256, batch=4)), conv)
        with tempfile.TemporaryDirectory() as d:
            ex = make_example(d)
            for dev in ("cuda", "cpu"):
                run_pipeline(ex["bam"], ex["bed"], os.path.join(d, dev),
                             fasta_path=ex["fasta"], cfg=small, write_plots=False,
                             device=dev)
            stats = compare_runs_nonexact(os.path.join(d, "cuda"), os.path.join(d, "cpu"),
                                          small.nuc.exact_tol)
        worst = {k.split(" ", 1)[1].replace(" max_abs_diff", ""): v
                 for k, v in stats.items() if k.startswith(".nucpos.bed.gz ")}
        msgs.append(f"{conv}: {wall:.2f} s = {windows / wall:.1f} windows/s, "
                    f"{got[kernel]} {kernel} launches for {steps} batches, "
                    f"{len(res.nuc.calls)} dyads; first batch [64, 5, 1536] max|_nuc5 - "
                    f"plain route| {', '.join(f'{c} {v:.3e}' for c, v in batch_err.items())}; "
                    f"cuda vs cpu max|diff| nucpos {worst}")
    phase("nonexact", "; ".join(msgs))
    return launches


def phase_profile() -> None:
    """`run --profile DIR` on the card: the trace names K2."""

    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac

    with tempfile.TemporaryDirectory() as d:
        ex = make_example(d)
        trace_dir = os.path.join(d, "trace")
        reset_launches()
        if nucleoatac(["run", "--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                       "--out", os.path.join(d, "prof"), "--batch", "4", "--device",
                       CARD, "--no_plots", "--profile", trace_dir]) != 0:
            raise AssertionError("run --profile failed")
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"profile: traces {traces}")
        path = os.path.join(trace_dir, traces[0])
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        k2 = [e for e in events if "nuc_scores_kernel" in str(e.get("name", ""))]
        if not k2:
            raise AssertionError("profile: the trace does not name nuc_scores_kernel")
        size = os.path.getsize(path)
    phase("profile", f"run --profile: one *.pt.trace.json, {size} bytes, "
          f"{len(events)} events, {len(k2)} nuc_scores_kernel events for "
          f"{read_launches()['nuc_scores']} K2 launches")


def main() -> int:
    import torch

    phase_device()
    phase_build()
    phase_k1()
    phase_k2()
    phase_ll()
    phase_occ()
    phase_bias()
    with tempfile.TemporaryDirectory() as d:
        data = make_dataset(d)
        run5 = phase_run(data)
        devices = phase_devices(data, run5)
        tracks = phase_tracks(data, run5)
        forms = phase_forms(data, run5)
        profiling = phase_profiling(data, run5)
        graphs = phase_graphs(data, run5)
        phase_parity()
        stages_k2 = phase_stages(data, run5)
        k1_launches = phase_conv(data, run5)
        wires = phase_wires(data, run5)
        phase_resume_bias()
        phase_pyatac(data)
        hosts = phase_hosts(data, run5)
        nonexact = phase_nonexact(data)
        phase_profile()
    if sys.modules.get("jax") is not None:
        raise AssertionError("jax was imported")
    # K2 is the main path's kernel (phase 5); K1 runs on the
    # conv="diag_pallas" path (phase 8)
    launches = {"nuc_scores": run5["launches"]["nuc_scores"],
                "diag_xcorr": k1_launches}
    by_path = {
        "nuc_scores": {"run": launches["nuc_scores"], "devices": devices["nuc_scores"],
                       "tracks": tracks["nuc_scores"],
                       "tracks_sharded": tracks["nuc_scores_sharded"],
                       "tracks_dryrun": tracks["nuc_scores_dryrun"],
                       "forms": forms["nuc_scores"], "stages": stages_k2,
                       "hosts": hosts["nuc_scores"], "nonexact": nonexact["nuc_scores"],
                       "profile": profiling["nuc_scores"],
                       "graphs": graphs["nuc_scores"],
                       **wires["nuc_scores"]},
        "diag_xcorr": {"conv": k1_launches, "devices_diag_pallas": devices["diag_xcorr"],
                       "tracks_dryrun": tracks["diag_xcorr_dryrun"],
                       "forms_diag_pallas": forms["diag_xcorr"],
                       "nonexact_diag_pallas": nonexact["diag_xcorr"],
                       "profile": profiling["diag_xcorr"],
                       "graphs_diag_pallas": graphs["diag_xcorr"], **wires["diag_xcorr"]},
    }
    for rec in KERNEL_RECORDS:
        rec["launches"] = launches[rec["name"]]
        rec["path_launches"] = by_path[rec["name"]]
        if min(rec["path_launches"].values()) <= 0:
            raise AssertionError(f"{rec['name']} was never launched on a path: "
                                 f"{rec['path_launches']}")
    print(json.dumps({"kernels": KERNEL_RECORDS}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
