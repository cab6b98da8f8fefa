"""The port's profilers (nucleoatac_torch/profiling) on the CPU, at
entry._tiny_engine(core=256, batch=2) sizes, against the JAX package's
DeviceEngine (CPU backend) on the same numpy-seeded batch:

  * each stage row's output against the reference engine's same stage on
    the same input (the pool2 and delta row sets): rasters equal; occ
    grid indices equal wherever both engines certify; the PWM log bias
    within 1e-5 and the bias matrix within rtol 1e-5 (test_torch_ops);
    norm within nuc.exact_tol and signal, lr and fuzz at the JAX
    package's bars (test_torch_transfer); u16 and pack bytes equal on
    equal inputs (test_torch_engine);
  * the composed rows are the whole step's bytes, in both packages;
  * on the CPU the report names both step forms eager and counts no
    capture; the eager form of the step prints its bytes, one device or
    two shards; the trace reader counts cudaGraphLaunch calls and each
    replay's kernels; a trace holds its steps and not its warm-up;
  * the FLOP model is the reference's, and bound() gives the kernel
    records' bounds;
  * both profilers refuse "cuda" without a card;
  * a CPU trace reads back, and the reader measures a handmade trace
    (a gap under the profiler's own step span names no host op);
  * the finishing profile prints every component group and changes no
    output byte;
  * the fused pass's timers are never negative (the final drain is its
    own term).
"""
import io
import json
import logging
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_torch.config import RunConfig, WindowParams
from nucleoatac_torch.entry import _tiny_engine
from nucleoatac_torch.models.nuc import NucStage
from nucleoatac_torch.models.pipeline import run_pipeline
from nucleoatac_torch.parity import RUN_SUFFIXES
from nucleoatac_torch.profiling import finish, stages
from nucleoatac_torch.synthetic import make_example
from test_torch_engine import _tiny_config
from test_torch_transfer import STAT_TOL, TOL

J = jnp.asarray


@pytest.fixture(scope="module")
def engines():
    """(JAX DeviceEngine, {conv: TorchEngine}, the seeded batch)."""
    cfg, fs, mix = _tiny_config()
    jeng = {conv: DeviceEngine(cfg, mix, fs, pwm=PWM.default(), conv_mode=conv)
            for conv in ("diag", "direct")}
    teng = {conv: _tiny_engine(core=256, batch=2, device="cpu", conv=conv)[1]
            for conv in ("diag", "diag_pallas", "direct")}
    return jeng, teng, stages.synthetic_batch(teng["diag"], frags=512)


def _rows(eng, batch, wire):
    return {r.name: r for r in stages.stage_rows(eng, batch, wire)}


def _scores_close(got, want):
    """(norm, signal, lr, fuzz, n) against the reference's NucTracks."""
    norm, signal, lr, fuzz, n = (x.numpy() for x in got)
    assert np.abs(norm - np.asarray(want.norm)).max() <= TOL
    for ch, x, w in ((2, signal, want.signal), (3, lr, want.lr), (4, fuzz, want.fuzz)):
        np.testing.assert_allclose(x, np.asarray(w), *STAT_TOL[ch])
    np.testing.assert_array_equal(n, np.asarray(want.n))
    assert np.abs(norm).max() > 0


def _occ_equal_where_certified(teng, got, want, wire):
    if wire == "pool2":
        (gi, gc), (wi, wc) = teng.decode_occ2(got), teng.decode_occ2(want)
    else:  # wire v1: [B, 4, W], the flag in channel 3
        gi, gc, wi, wc = got[:, :3], got[:, 3] == 1, want[:, :3], want[:, 3] == 1
    both = gc & wc
    assert both.mean() > 0.5
    for c in range(3):
        np.testing.assert_array_equal(gi[:, c][both], wi[:, c][both])


@pytest.mark.parametrize("conv", ["diag", "direct"])
@pytest.mark.parametrize("wire", ["pool2", "delta"])
def test_stage_rows_match_device_engine(engines, wire, conv):
    jeng, teng, batch = engines
    j, t = jeng[conv], teng[conv]
    rows = _rows(t, batch, wire)
    raster = "_raster_pool" if wire == "pool2" else "_raster_delta"
    mat = rows[raster].out
    want = (j._raster_pool(J(batch["pool"]), J(batch["table"]), batch["emax"])
            if wire == "pool2" else j._raster_delta(J(batch["db"])))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(want))
    occ = "_occ_packed2" if wire == "pool2" else "_occ_packed"
    _occ_equal_where_certified(t, rows[occ].out.numpy(),
                               np.asarray(getattr(j, occ)(J(mat.numpy()))), wire)
    lb_name = "_logbias_2bit" if wire == "pool2" else "_logbias_nib"
    lb_args = ((batch["packed2"], batch["esc"]) if wire == "pool2" else (batch["nib"],))
    logb = rows[lb_name].out
    np.testing.assert_allclose(logb.numpy(), np.asarray(getattr(j, lb_name)(*map(J, lb_args))),
                               rtol=0, atol=1e-5)
    b0 = rows["_bias"].out
    np.testing.assert_allclose(b0.numpy(), np.asarray(j._bias(J(logb.numpy()))),
                               rtol=1e-5, atol=0)
    want_sc = j._finish(*j._convs(J(mat.numpy()), J(b0.numpy())))
    if conv == "diag":
        scores = rows["_xcorr"].out
    else:  # the valid sums, then the padded epilogue
        fo, bo = rows["_convs"].out
        K = t.tables["_diag_kernels"][0].shape[1]
        jfo, jbo = j._convs(J(mat.numpy()), J(b0.numpy()))
        half = K // 2
        for got, ref in ((fo, jfo), (bo, jbo)):
            ref = np.asarray(ref)[:, :, half:half + got.shape[2]]
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max())
        scores = rows["_finish"].out
    _scores_close(scores, want_sc)
    norm = scores[0].numpy()
    if wire == "pool2":
        m = t.smooth_margin()
        margin = norm[:, t.core_lo - m:t.core_lo + t.core + m]
        np.testing.assert_array_equal(rows["_u16"].out.numpy(), np.asarray(j._u16(J(margin))))
        occ2, u16 = rows["_occ_packed2"].out.numpy(), rows["_u16"].out.numpy()
        np.testing.assert_array_equal(rows["_pack_run"].out.numpy(),
                                      np.asarray(j._pack_run(J(occ2), J(u16))))
    else:
        f5 = rows["_finish5"].out.numpy()
        want5 = np.asarray(j._finish5(*j._convs(J(mat.numpy()), J(b0.numpy()))))
        assert f5.shape == want5.shape and f5.dtype == np.float32
        assert np.abs(f5[:, :2] - want5[:, :2]).max() <= TOL
        for ch, (rtol, atol) in STAT_TOL.items():
            np.testing.assert_allclose(f5[:, ch], want5[:, ch], rtol=rtol, atol=atol)


def test_composed_rows_are_the_steps_bytes(engines):
    """The pool2 rows composed are run_step_pool2's bytes on the port, and
    the same composition of the reference's stages is its run_step_pool2;
    the two steps meet test_torch_engine's bars."""
    jeng, teng, batch = engines
    j, t = jeng["diag"], teng["diag"]
    rows = stages.stage_rows(t, batch, "pool2")
    step = stages.step_fn(t, batch, "pool2")()
    assert torch.equal(stages.composed(rows, "pool2"), step)
    args = (J(batch["pool"]), J(batch["table"]), J(batch["packed2"]), J(batch["esc"]),
            batch["emax"])
    jstep = np.asarray(j.run_step_pool2(*args))
    mat = j._raster_pool(*args[:2], batch["emax"])
    jnorm = j._nuc1m(*j._convs(mat, j._bias(j._logbias_2bit(*args[2:4]))))
    np.testing.assert_array_equal(
        np.asarray(j._pack_run(j._occ_packed2(mat), j._u16(jnorm))), jstep)
    tidx, tcert, tnorm, tq = t.unpack_run(step.numpy())
    jidx, jcert, jn, jq = j.unpack_run(jstep)
    both = tcert & jcert
    assert both.mean() > 0.5
    for c in range(3):
        np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])
    assert (np.abs(tnorm - jn) <= TOL + np.maximum(tq, jq)[:, None]).all()


@pytest.mark.parametrize("conv", ["diag", "diag_pallas", "direct"])
@pytest.mark.parametrize("wire", ["pool2", "delta"])
def test_profile_rows_on_every_route(engines, wire, conv):
    """The whole profile on the CPU: rows in chain order, the stage sum
    beside e2e_device, the composed bytes equal to the step's, the report
    one JSON object labelled cpu with no bound or share."""
    _, teng, batch = engines
    rep = stages.profile_stages(teng[conv], batch, wire, iters=1)
    names = list(rep["rows"])
    assert names[-4:] == ["e2e_device", "enqueue", "upload", "download"]
    xcorr = ["_xcorr"] if conv == "diag" else (
        ["_convs", "K1 F", "K1 B0", "_finish"] if conv == "diag_pallas" else ["_convs", "_finish"])
    assert all(x in names for x in xcorr)
    assert rep["device"] == "cpu" and rep["card"] is None and rep["composed_equal"]
    assert rep["stage_sum_ms"] == pytest.approx(
        sum(r["ms"] for r in rep["rows"].values() if r["in_sum"]))
    for name, r in rep["rows"].items():
        assert r["ms"] > 0 and "bound_ms" not in r and "share" not in r, name
    assert [n for n in names if not rep["rows"][n]["in_sum"]][:2] == (
        ["K1 F", "K1 B0"] if conv == "diag_pallas" else ["e2e_device", "enqueue"])
    json.loads(json.dumps(rep))
    assert "stage sum" in stages.format_report(rep)


@pytest.mark.parametrize("wire", ["pool2", "delta"])
def test_cpu_report_says_both_forms_are_eager(engines, wire):
    """On the CPU no step program exists: the report names the step form
    eager, times the eager chain beside e2e_device as what it is, and
    counts no capture, replay or graph pool."""
    _, teng, batch = engines
    eng = teng["diag"]
    rep = stages.profile_stages(eng, batch, wire, iters=1)
    assert rep["step_form"] == "eager"
    assert (rep["captures"], rep["replays"], rep["graph_pool_bytes"]) == (0, 0, 0)
    assert rep["e2e_eager_ms"] > 0 and rep["enqueue_eager_ms"] > 0
    assert "step form: eager" in stages.format_report(rep)
    assert eng.programs.entries == {}


@pytest.mark.parametrize("shards", [1, 2])
def test_eager_step_prints_the_steps_bytes(engines, shards):
    """step_fn's eager form (the chain before its step program, sharded as
    the step shards it) gives the public step's bytes."""
    jeng, teng, batch = engines
    eng = teng["diag"] if shards == 1 else _tiny_engine(
        core=256, batch=2, device=["cpu"] * shards)[1]
    got = stages.step_fn(eng, batch, "pool2", eager=True)()
    assert torch.equal(got, stages.step_fn(eng, batch, "pool2")())
    assert torch.equal(got, stages.step_fn(teng["diag"], batch, "pool2")())


def test_read_trace_counts_graph_launches(tmp_path):
    """Two replays of a captured step: two cudaGraphLaunch calls on the
    host, the graph's kernels counted as kernels."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10 * i,
           "dur": 2, "args": {"correlation": i}} for i in (1, 2)]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{j}", "ts": 10 * i + 3 + j, "dur": 1,
            "args": {"correlation": i}} for i in (1, 2) for j in (0, 1, 2)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = stages.read_trace(str(path), n_batches=2)
    assert tr["graph_launches"] == 2 and tr["kernels_per_batch"] == 3
    assert tr["replay_kernels"] == [3, 3]


def test_read_trace_shows_a_replay_that_lost_records(tmp_path):
    """The first replay's first kernel record is missing: that replay
    shows 2 kernels against the second's 3; an eager kernel (its own
    correlation id) counts for no replay."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10 * i,
           "dur": 2, "args": {"correlation": i}} for i in (1, 2)]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{j}", "ts": 10 * i + 3 + j, "dur": 1,
            "args": {"correlation": i}} for i in (1, 2) for j in (0, 1, 2) if (i, j) != (1, 0)]
    ev += [{"ph": "X", "cat": "kernel", "name": "copy", "ts": 30, "dur": 1,
            "args": {"correlation": 7}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert stages.read_trace(str(path), n_batches=2)["replay_kernels"] == [2, 3]


def test_flop_model_is_the_references():
    """profile_stages.py:163-170, from the reference's own RunConfig."""
    from nucleoatac_tpu.config import RunConfig as JRunConfig
    from nucleoatac_tpu.config import WindowParams as JWindowParams

    for core in (256, 1024):
        jcfg = JRunConfig(window=JWindowParams(core=core))
        W = jcfg.window.width(jcfg.occ, jcfg.vmat)
        S = jcfg.sizes.upper - jcfg.sizes.lower
        Sv = jcfg.vmat.upper - jcfg.vmat.lower
        K, G = jcfg.vmat.width, jcfg.occ.grid_size
        Wo = W - K + 1
        want = {
            "occ_matmul": 2 * S * G * W,
            "occ_slide": (2 * jcfg.occ.flank + 1) * (G + 1) * W,
            "convs_f": 2 * 5 * Sv * K * Wo,
            "convs_b": 2 * 3 * Sv * K * Wo,
            "bias_mat": 4 * Sv * W,
        }
        cfg = RunConfig(window=WindowParams(core=core))
        assert stages.flop_model(cfg, cfg.window.width(cfg.occ, cfg.vmat)) == want


@pytest.mark.parametrize("kernel, work, want_ms", [
    ("K1", stages.k1_work(64, 146, 1536, 147), 0.0463),
    ("K2", stages.k2_work(64, 146, 1536, 147), 0.0926),
])
def test_bound_gives_the_kernel_records(kernel, work, want_ms):
    """The bounds of the kernel records in PERF.md (chip_smoke [K1]/[K2])."""
    bd = stages.bound(*work)
    assert round(bd["bound_ms"], 4) == want_ms
    assert bd["bound_by"] == "operations"


@pytest.mark.parametrize("which", ["stages", "finish"])
def test_profilers_refuse_cuda_without_a_card(which, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if which == "stages":
            stages.main(["--core", "256", "--batch", "2"])
        else:
            finish.profile_finish(peaks=8, chroms=1, out_dir=str(tmp_path))


def test_cpu_trace_reads_back(engines, tmp_path):
    _, teng, batch = engines
    rep = stages.profile_stages(teng["diag"], batch, "pool2", iters=1,
                                trace_dir=str(tmp_path), trace_batches=2)
    tr = rep["trace"]
    assert os.path.exists(tr["trace"]) and tr["batches"] == 2
    assert 0 < tr["busy_share"] <= 1 and tr["span_ms"] > 0 and tr["kernels_per_batch"] > 0
    assert tr["busy_ms"] <= tr["span_ms"] + 1e-9
    assert tr["gaps"] and all(g["ms"] > 0 for g in tr["gaps"])
    assert [g["ms"] for g in tr["gaps"]] == sorted((g["ms"] for g in tr["gaps"]), reverse=True)
    assert tr["top_ops"] and all(op["ms_per_batch"] > 0 for op in tr["top_ops"])


@pytest.mark.parametrize("n", [1, 3])
def test_trace_holds_the_steps_and_not_the_warm_up(tmp_path, n):
    """The warm-up step runs inside the session, in the profiler's
    warm-up phase, and is dropped: the trace names n steps' ops."""
    x = torch.ones(16, 16)
    tr = stages.trace_steps(lambda: torch.mm(x, x), n, torch.device("cpu"), str(tmp_path),
                            f"n{n}")
    assert tr["kernel_counts"]["aten::mm"] == n and tr["batches"] == n


def test_read_trace_measures_a_handmade_trace(tmp_path):
    """Three kernels over 0-100 µs, one memcpy overlapping the first: busy
    40 + 10 + 20 of 100 µs; the 40 µs gap before k3, whose launch began
    5 µs before it inside aten::mul."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "nuc_scores_kernel(x)", "ts": 50, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 100, "dur": 20, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60, "dur": 25},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 90, "dur": 8},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 95, "dur": 2,
         "args": {"correlation": 3}},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 70},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = stages.read_trace(str(path), n_batches=1, n_gaps=5)
    assert tr["span_ms"] == pytest.approx(0.120)
    assert tr["busy_ms"] == pytest.approx(0.070)
    assert tr["kernels_per_batch"] == 3 and stages.named_count(tr, "nuc_scores_kernel") == 1
    g0, g1 = tr["gaps"]
    assert (g0["ms"], g0["host"], g0["next_op"], g0["launched_by"]) == \
        (pytest.approx(0.040), "aten::add", "k3", "aten::mul")
    assert g0["launch_before_end_ms"] == pytest.approx(0.005)
    assert (g1["ms"], g1["next_op"], g1["launched_by"]) == (pytest.approx(0.010),
                                                          "nuc_scores_kernel(x)", None)


def test_read_trace_names_no_gap_after_the_profiler_step(tmp_path):
    """The profiler's ProfilerStep#1 span covers the traced window: a gap
    with only Python on the host still names no host op."""
    ev = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": 50 * i, "dur": 10,
           "args": {"correlation": i}} for i in (0, 1)]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 0, "dur": 70},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12, "dur": 5}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    (gap,) = stages.read_trace(str(path), n_batches=2)["gaps"]
    assert gap["ms"] == pytest.approx(0.040) and gap["host"] is None


def test_finish_profile_groups_and_bytes(tmp_path):
    """The finishing profile at 8 peaks prints every component group and
    the fused timers, and its ten outputs (and indexes) are byte for byte
    those of a plain run_pipeline on the same data and config."""
    out = io.StringIO()
    rep = finish.profile_finish(peaks=8, chroms=1, top=5, device="cpu",
                                out_dir=str(tmp_path / "prof"), stream=out)
    text = out.getvalue()
    for label in finish.GROUPS:
        assert label in text and label in rep["groups"]
    assert rep["device"] == "cpu" and rep["wall_s"] > 0 and rep["batches"] > 0
    assert rep["fused_timers"] and min(rep["fused_timers"].values()) >= 0
    cfg = RunConfig(window=WindowParams(finish_threads=0))
    d = str(tmp_path / "prof")
    run_pipeline(*(os.path.join(d, n) for n in ("synth.bam", "peaks.bed")),
                 str(tmp_path / "plain"), fasta_path=os.path.join(d, "synth.fa"),
                 cfg=cfg, write_plots=False, device="cpu")
    for sfx in RUN_SUFFIXES:
        for ext in ("", ".tbi"):
            with open(rep["prefix"] + sfx + ext, "rb") as a, \
                    open(str(tmp_path / "plain") + sfx + ext, "rb") as b:
                assert a.read() == b.read(), sfx + ext


def test_fused_timers_never_negative(tmp_path, monkeypatch, caplog):
    """One finish thread whose tasks sleep, so that the run ends waiting
    in the final drain: that wait is its own term, and no term (assemble
    above all) goes negative, in the log line or in fused_timers."""
    real = NucStage.compute_chunk

    def slow(self, *a, **k):
        time.sleep(0.3)
        return real(self, *a, **k)

    monkeypatch.setattr(NucStage, "compute_chunk", slow)
    monkeypatch.setenv("NUCLEOATAC_FUSED_TIMERS", "1")
    ex = make_example(str(tmp_path))
    cfg = RunConfig(window=WindowParams(core=256, batch=4, finish_threads=1))
    with caplog.at_level(logging.INFO, logger="nucleoatac"):
        res = run_pipeline(ex["bam"], ex["bed"], str(tmp_path / "run"), fasta_path=ex["fasta"],
                           cfg=cfg, write_plots=False, device="cpu")
    line = next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("fused timers"))
    logged = {k: float(v) for k, v in re.findall(r"(\w+)=(-?[\d.]+)", line)}
    assert "final_drain" in logged and logged["final_drain"] >= 0.2
    assert not [k for k, v in logged.items() if v < 0 or line.count(f"{k}=-")], line
    timers = res.nuc.fused_timers
    assert timers["final_drain"] >= 0.25
    assert min(timers.values()) >= 0, timers


@pytest.mark.cuda
def test_profile_on_the_card_has_bounds_and_launches():
    """On a card: every stage row carries its bound and share, K2 launches
    once per call of the xcorr row and once per step call."""
    if not torch.cuda.is_available():
        pytest.skip("no GPU: chip_smoke.py phase 5e runs this on the card")
    _, eng = _tiny_engine(core=256, batch=2, device="cuda")
    rep = stages.profile_stages(eng, stages.synthetic_batch(eng, frags=256), "pool2",
                                iters=2)
    assert rep["device"] == "cuda" and rep["composed_equal"]
    assert rep["step_form"] == "replayed CUDA graph" and rep["captures"] == 1
    for name, r in rep["rows"].items():
        if r["in_sum"]:
            assert r["bound_ms"] > 0 and 0 < r["share"], name
    for name in ("_xcorr", "e2e_device"):
        assert rep["rows"][name]["launches"]["nuc_scores"] == rep["rows"][name]["calls"]
