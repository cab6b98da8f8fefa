#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (one line each; any failure raises and the script exits nonzero):
  1. device   — CUDA present; the card's name and power limit.
  2. build    — compile the CUDA kernels from nucleoatac_torch/csrc.
  3. K1       — diag_xcorr kernel vs its plain version at production shape.
  4. K2       — nuc_scores kernel vs its plain version and a float64
                evaluation at production shape: max |norm - f64| within
                NucParams.exact_tol; against the plain version norm within
                exact_tol, signal, lr and fuzz within
                parity.NONEXACT_STAT_TOL's bars, n equal.
  4b. LL      — occupancy log-likelihood vs float64 at production shape
                (max |LL - f64| must stay within OccParams.exact_tol).
  5. run      — nucleoatac_torch run_pipeline on the card with the default
                RunConfig on synthetic data (1,000 peaks); K2 launches ==
                nuc batches.
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
  9. resume+bias — on tests/synth.py data: `run` then `run --resume` give
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
                tests/synth.py data equals a one-process `run`.
 12. nonexact — occ.exact = nuc.exact = False run_pipeline on phase 5's
                dataset on both xcorr routes: K2 launches == batches
                ("diag"), K1 launches == 2 x batches ("diag_pallas");
                the run's first full batch of _nuc5 output [64, 5, 1536]
                against the plain route on the same inputs (norm and
                norm_smooth within exact_tol, signal/lr/fuzz at the
                non-exact bars); cuda against cpu on tests/synth.py data meets
                parity.compare_runs_nonexact on each route.
 13. profile  — `run --profile DIR` on tests/synth.py data: the trace
                exists and names nuc_scores_kernel.
Then one JSON line of kernel records (K2's launches from phase 5, K1's
from phase 8, and each kernel's launches on every path that ran it) and as
the last line {"ok": true, "device": {...}}.

Imports nothing of JAX (``jax`` is blocked in this process).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must run without JAX

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_RECORDS: list = []


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device0 {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")


def phase_build() -> None:
    from nucleoatac_torch.kernels.build import library_path, load_library

    t0 = time.perf_counter()
    load_library()
    phase("build", f"{library_path().name} in {time.perf_counter() - t0:.2f} s")


def _template_tables(dev, dtype=None):
    import torch

    from nucleoatac_tpu.config import NucParams
    from nucleoatac_tpu.core.vmat import VMat
    from nucleoatac_torch.ops.xcorr import build_kernels_diag

    tabs = build_kernels_diag(VMat.default().mat, NucParams().v_floor)
    return [torch.as_tensor(t, device=dev, dtype=dtype or torch.float32)
            .contiguous() for t in tabs]


def phase_k1() -> None:
    import numpy as np
    import torch

    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops.xcorr import conv_stack_diag

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    B, S, W, C, K = 64, 146, 1536, 2, 147
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
    ms = cuda_ms(lambda: k1.diag_xcorr(x, k2d))
    plain_ms = cuda_ms(lambda: conv_stack_diag(x, k2d))
    phase("K1", f"diag_xcorr [64,146,1536]x[2,147,146]: max|k-plain| "
          f"{err_plain:.3e}, max|k-f64| {err64:.3e} (rel {rel64:.2e}); "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    KERNEL_RECORDS.append({
        "name": "diag_xcorr", "route": "cuda",
        "source": "nucleoatac_torch/csrc/diag_xcorr.cu",
        "replaces": "nucleoatac_tpu/ops/pallas_diag.py:47",
        "launches": 0, "max_abs_err": err64, "ms": ms, "plain_ms": plain_ms,
    })


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

    from nucleoatac_tpu.config import RunConfig
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
    fmat_c = fmat.contiguous()
    ms = cuda_ms(lambda: k2.nuc_scores(fmat, b0, *tabs, vf))
    plain_ms = cuda_ms(lambda: k2.nuc_scores_plain(fmat_c, b0, *tabs, vf))
    fmt = lambda e: ", ".join(f"{c} {v:.3e}" for c, v in e.items())  # noqa: E731
    phase("K2", f"nuc_scores [64,146,1536]: max|k-f64| {fmt(err)} (norm bar "
          f"exact_tol {cfg.nuc.exact_tol}); max|k-plain| {fmt(err_plain)}, n equal "
          f"(bars (rtol, atol): { {c: bars[c] for c in err_plain} }; max|plain| "
          f"{fmt(peak)}); "
          f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    KERNEL_RECORDS.append({
        "name": "nuc_scores", "route": "cuda",
        "source": "nucleoatac_torch/csrc/nuc_scores.cu",
        "replaces": "nucleoatac_tpu/ops/pallas_kernels.py:44",
        "launches": 0, "max_abs_err": err["norm"], "ms": ms,
        "plain_ms": plain_ms,
    })


def phase_ll() -> None:
    """Occupancy LL on the card against float64 on the card, production
    batch shape: the error the occ f64 certification has to absorb."""
    import numpy as np
    import torch

    from nucleoatac_tpu.config import RunConfig
    from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
    from nucleoatac_tpu.core.mixture import FragmentMixDistribution
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


def _load_bench_e2e():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_e2e", os.path.join(ROOT, "scripts", "bench_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_dataset(d: str, n_peaks: int = 1000) -> dict:
    """Phase 5's synthetic data (4 chroms x n_peaks/4 peaks x 2,000 bp x
    2,000 fragments per peak), shared by phases 7, 8 and 10."""
    bench = _load_bench_e2e()
    t0 = time.perf_counter()
    bam, bed, fa = bench.synth_dataset(d, 4, n_peaks, 2000, 2000)
    return {"dir": d, "bam": bam, "bed": bed, "fasta": fa, "n_peaks": n_peaks,
            "t_data": time.perf_counter() - t0}


def reset_launches() -> None:
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0


def read_launches() -> dict:
    from nucleoatac_torch.ops import diag_xcorr as k1
    from nucleoatac_torch.ops import nuc_scores as k2

    return {"diag_xcorr": k1.LAUNCHES, "nuc_scores": k2.LAUNCHES}


def phase_run(data: dict) -> dict:
    """The port's main path on the card: run_pipeline with the default
    RunConfig. Returns what later phases compare with: the output prefix,
    launch counts, nuc batches, windows and the largest u16 norm step."""
    import torch

    from nucleoatac_tpu.config import RunConfig
    from nucleoatac_tpu.models.data import tile_chunks
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import RUN_SUFFIXES, read_rows

    cfg = RunConfig()
    prefix = os.path.join(data["dir"], "run")
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(data["bam"], data["bed"], prefix, fasta_path=data["fasta"],
                       cfg=cfg, write_plots=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    steps = res.engine.steps
    if steps == 0 or launches["nuc_scores"] != steps:
        raise AssertionError(
            f"nuc_scores launched {launches['nuc_scores']} times for "
            f"{steps} batches")
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
    phase("run", f"{data['n_peaks']} peaks, {windows} windows, {steps} batches of "
          f"{cfg.window.batch}: run_pipeline {wall:.2f} s = "
          f"{windows / wall:.1f} windows/s (data synthesis {data['t_data']:.1f} s, "
          f"not timed); {len(res.nuc.calls)} dyads, {len(res.nfrs)} NFRs; "
          f"launches {launches}; occ spot-check positions "
          f"{res.occ_stage.n_spot_checked}")
    return {"prefix": prefix, "launches": launches, "steps": steps,
            "windows": windows, "max_qstep": res.nuc_stage.max_qstep}


def phase_parity() -> None:
    """The same small run on cuda and on cpu (plain versions): equal rows,
    signal tracks within nuc.exact_tol (parity.compare_runs)."""
    import pathlib

    from nucleoatac_tpu.config import RunConfig, WindowParams
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import compare_runs

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_example

    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    with tempfile.TemporaryDirectory() as d:
        ex = make_example(pathlib.Path(d))
        for dev in ("cuda", "cpu"):
            run_pipeline(ex["bam"], ex["bed"], os.path.join(d, dev),
                         fasta_path=ex["fasta"], cfg=cfg, write_plots=False,
                         device=dev)
        stats = compare_runs(os.path.join(d, "cuda"), os.path.join(d, "cpu"),
                             cfg.nuc.exact_tol)
    sig = {k.split(" ")[0]: v for k, v in stats.items()
           if k.endswith("max_abs_diff")}
    phase("parity", f"cuda vs cpu on tests/synth.py data: "
          f"{sum(1 for k in stats if 'max_abs_diff' not in k)} files row-equal, "
          f"signal max|cuda-cpu| {sig} (nuc.exact_tol {cfg.nuc.exact_tol})")


def phase_stages(data: dict, run5: dict) -> int:
    """The standalone stages through the command line, on the card, at
    full width: the two-pass delta12 path must print phase 5's rows.
    Returns the nuc stage's K2 launches."""
    import torch

    from nucleoatac_tpu.config import RunConfig
    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.parity import RUN_SUFFIXES, read_rows

    prefix = os.path.join(data["dir"], "stages")
    # delta12 batches fill up across chunks; the fused pass's pool batches
    # end with each group of chunks, so it can have more
    batches = -(-run5["windows"] // RunConfig().window.batch)
    base = ["--bed", data["bed"], "--bam", data["bam"], "--fasta", data["fasta"],
            "--out", prefix, "--device", "cuda", "--no_plots"]
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
    rows = 0
    for sfx in RUN_SUFFIXES:
        a, b = read_rows(run5["prefix"] + sfx), read_rows(prefix + sfx)
        if a != b or not a:
            raise AssertionError(f"stages {sfx}: rows differ from the fused run "
                                 f"({len(a)} vs {len(b)} rows)")
        rows += len(a)
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

    from nucleoatac_tpu.config import RunConfig, WindowParams
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
                       cfg=cfg, write_plots=False, device="cuda")
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


def phase_resume_bias() -> None:
    """--resume and --bias_track through the command lines, on the card,
    on tests/synth.py data."""
    import gzip
    import pathlib

    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.cli.pyatac import main as pyatac
    from nucleoatac_torch.parity import read_rows

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_example

    def text(path):
        with gzip.open(path, "rb") as fh:
            return fh.read()

    with tempfile.TemporaryDirectory() as d:
        ex = make_example(pathlib.Path(d))
        common = ["--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                  "--batch", "4", "--device", "cuda", "--no_plots"]
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
    from nucleoatac_tpu.core.vmat import VMat
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
    import pathlib
    import socket

    import numpy as np

    from nucleoatac_tpu.config import RunConfig
    from nucleoatac_tpu.core.chunk import ChunkList
    from nucleoatac_tpu.io.bam import scan_bam
    from nucleoatac_tpu.models.data import tile_chunks
    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
    from nucleoatac_torch.parallel.distributed import host_tile_slice
    from nucleoatac_torch.parity import RUN_SUFFIXES, read_rows

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
    rows = 0
    for sfx in RUN_SUFFIXES:
        a, b = read_rows(run5["prefix"] + sfx), read_rows(prefix + sfx)
        if a != b or not a:
            raise AssertionError(f"hosts {sfx}: rows differ from phase 5 "
                                 f"({len(a)} vs {len(b)} rows)")
        rows += len(a)
    if not (np.loadtxt(prefix + ".nuc_dist.txt") == np.loadtxt(run5["prefix"] + ".nuc_dist.txt")).all():
        raise AssertionError("hosts: nuc_dist differs from phase 5")
    if any(".part" in f for f in os.listdir(data["dir"])):
        raise AssertionError("hosts: shard files left after finalize")

    # the external-launcher form: hosts in turn, then --finalize
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_example

    with tempfile.TemporaryDirectory() as d:
        ex = make_example(pathlib.Path(d))
        with open(ex["bed"], "a") as fh:
            fh.write("chr1\t3600\t5600\tpeak2\n")
        base = ["run", "--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                "--batch", "4", "--device", "cuda", "--no_plots"]
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
          "tests/synth.py data byte-equal to one process")
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
    import pathlib

    import torch

    from nucleoatac_tpu.config import RunConfig, WindowParams
    from nucleoatac_tpu.models.data import tile_chunks
    from nucleoatac_torch.models.engine import TorchEngine
    from nucleoatac_torch.models.pipeline import run_pipeline
    from nucleoatac_torch.parity import compare_runs_nonexact, read_rows

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_example

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
                               cfg=cfg, write_plots=False, device="cuda")
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
            ex = make_example(pathlib.Path(d))
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
    import pathlib

    from nucleoatac_torch.cli.nucleoatac import main as nucleoatac

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_example

    with tempfile.TemporaryDirectory() as d:
        ex = make_example(pathlib.Path(d))
        trace_dir = os.path.join(d, "trace")
        reset_launches()
        if nucleoatac(["run", "--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
                       "--out", os.path.join(d, "prof"), "--batch", "4", "--device",
                       "cuda", "--no_plots", "--profile", trace_dir]) != 0:
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
    with tempfile.TemporaryDirectory() as d:
        data = make_dataset(d)
        run5 = phase_run(data)
        phase_parity()
        stages_k2 = phase_stages(data, run5)
        k1_launches = phase_conv(data, run5)
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
        "nuc_scores": {"run": launches["nuc_scores"], "stages": stages_k2,
                       "hosts": hosts["nuc_scores"], "nonexact": nonexact["nuc_scores"]},
        "diag_xcorr": {"conv": k1_launches, "nonexact_diag_pallas": nonexact["diag_xcorr"]},
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
