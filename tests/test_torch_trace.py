"""The port's tracer (nucleoatac_torch/utils/trace.py) and what reads it,
on the CPU:

  * spans nest, each with its inclusive time and its calls; counters sum;
  * threads of a pool sum into their own accumulators, merged when read,
    with no update lost;
  * device counters (a kernel's fixed buffers) read since their record
    opened;
  * each _pipelined call opens a fresh loop record, the only one the
    tracer keeps; the loop's spans count its batches;
  * under a CPU torch.profiler session a span is a user annotation of its
    name in the exported trace and adds nothing to the record; so are the
    engine's stage ranges, which off the profiler run as plain calls;
  * a step program's replay counts the bytes it copies in;
  * the fused pass's log line gives its batches and nibble fallbacks;
  * stage_timer keeps its two log lines around a span;
  * the replay-to-stage splitter (profiling/stages.py) on handmade chrome
    traces: a matching replay summed by stage, a mismatched one and one
    with lost records reported, device ops outside the graphs named by
    the span that launched them; and the check chip_smoke makes of its
    report.
"""
import json
import logging
import os
import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import nucleoatac_torch.models.fused as fused
from nucleoatac_torch.config import RunConfig, WindowParams
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.fused import fused_timers
from nucleoatac_torch.models.graphs import StepPrograms
from nucleoatac_torch.models.occ import _pipelined
from nucleoatac_torch.models.pipeline import run_pipeline
from nucleoatac_torch.parity import RUN_SUFFIXES
from nucleoatac_torch.profiling import stages
from nucleoatac_torch.synthetic import make_example
from nucleoatac_torch.utils import trace
from nucleoatac_torch.utils.logging import stage_timer


def test_spans_nest_with_inclusive_totals_and_counters_sum():
    t = trace.Tracer()
    with t.span("outer"):
        time.sleep(0.02)
        for _ in range(3):
            with t.span("inner"):
                time.sleep(0.01)
    t.count("items", 4)
    t.count("items")
    rec = t.newest()
    assert rec.label == "process"
    assert rec.calls("outer") == 1 and rec.calls("inner") == 3
    assert rec.seconds("inner") >= 0.03
    assert rec.seconds("outer") >= rec.seconds("inner") + 0.02  # inclusive
    assert rec.mean_ms("inner") == pytest.approx(rec.seconds("inner") / 3 * 1e3)
    assert rec.mean_ms("never") is None
    assert rec.counter("items") == 5 and rec.counters() == {"items": 5}


def test_threads_of_a_pool_lose_no_update():
    """More threads than cores, a short switch interval: every span and
    count of every thread is in the merged totals, and each thread kept
    its own accumulator."""
    t = trace.Tracer()
    n_tasks, per_task = 64, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def task(_):
            for _ in range(per_task):
                with t.span("work"):
                    t.count("done")
            return threading.get_ident()

        with ThreadPoolExecutor(16) as pool:
            idents = set(pool.map(task, range(n_tasks), timeout=60))
    finally:
        sys.setswitchinterval(old)
    rec = t.newest()
    assert rec.calls("work") == rec.counter("done") == n_tasks * per_task
    assert len(rec._threads) == len(idents) > 1


def test_device_counters_are_read_since_the_record_opened():
    """A device counter (a kernel's fixed buffer, here a CPU tensor) reads
    what was added since its record opened, summed over its buffers; a
    buffer made after the record opened counts whole; the K2 slab
    counters are registered with the process's tracer."""
    t = trace.Tracer()
    bufs = [torch.tensor([3, 4], dtype=torch.int64)]
    t.device_counters(("a.sparse", "a.dense"), lambda: list(bufs))
    rec = t.open_loop("loop")
    bufs[0] += torch.tensor([5, 1])
    assert rec.counters() == {"a.sparse": 5, "a.dense": 1}
    bufs.append(torch.tensor([2, 0], dtype=torch.int64))
    t.count("a.sparse", 10)
    assert rec.counter("a.sparse") == 17 and rec.counter("a.dense") == 1
    assert t.open_loop("next").counters() == {"a.sparse": 0, "a.dense": 0}
    from nucleoatac_torch.ops import nuc_scores as k2

    assert any(n == k2.SLAB_COUNTERS for n, _ in trace.TRACER.sources)
    assert trace.TRACER.open_loop("cpu").counter("k2.sparse_slabs") == 0


def _cpu_loop(n: int, depth: int = 3):
    return _pipelined(range(n), lambda b: torch.full((2,), float(b)), depth)


def test_each_pipelined_call_opens_a_record_and_counts_its_batches():
    got = [b for b, _ in _cpu_loop(7)]
    first = trace.newest()
    assert got == list(range(7)) and first.label == "pipelined"
    assert first.calls("loop.wait") == 7
    assert first.calls("loop.dispatch") == 7
    assert first.calls("loop.download") == 0  # CPU results are yielded as they are
    loop = _cpu_loop(9)
    for i, _ in zip(range(4), loop):  # the consumer stops after 4 batches
        pass
    loop.close()
    second = trace.newest()
    assert second is not first
    assert second.calls("loop.wait") == 4
    assert second.calls("loop.dispatch") == 4 + 3  # depth batches in flight
    assert first.calls("loop.wait") == 7  # the older record is left as it was


def test_spans_under_a_profiler_annotate_and_add_nothing(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    t = trace.Tracer()
    with t.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("loop.wait"):
            with t.span("graphs.replay"):
                torch.ones(4).sum()
        t.count("graphs.copy_in_bytes", 8)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"loop.wait", "graphs.replay"} <= names
    rec = t.newest()
    assert rec.spans().keys() == {"before"} and rec.counters() == {}


def test_engine_stage_ranges_only_under_a_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    off = TorchEngine._u16(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = TorchEngine._u16(x)
    assert torch.equal(on, off)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    assert "engine._u16" in {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert "engine._u16" not in trace.newest().spans()


def test_replays_count_the_bytes_they_copy_in():
    def stand_in(run, device):
        return (lambda: None), run(), 4096

    progs = StepPrograms(capture=stand_in)
    pool = torch.zeros(12, dtype=torch.uint8)
    table = torch.zeros((4, 3), dtype=torch.int32)

    def chain(p, tb, emax):
        return tb[:, :2].float() + p[:emax].float().sum()

    rec = trace.open_loop("test")
    progs("run_step_pool", chain, pool, table, 6)  # the capture copies nothing in
    assert rec.counters() == {} and rec.calls("graphs.capture") == 1
    for _ in range(3):
        progs("run_step_pool", chain, pool, table, 6)
    assert rec.counter("graphs.copy_in_bytes") == 3 * (12 + 4 * 3 * 4)
    for name in ("graphs.copy_in", "graphs.replay", "graphs.clone"):
        assert rec.calls(name) == 3, name


def test_stage_timer_logs_around_a_span(caplog):
    rec = trace.open_loop("test")
    with caplog.at_level(logging.INFO, logger="nucleoatac"):
        with stage_timer("fit"):
            time.sleep(0.01)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == "fit: start" and msgs[1].startswith("fit: done in ")
    assert rec.calls("run.fit") == 1 and rec.seconds("run.fit") >= 0.01


def test_fused_timers_take_the_drains_out_of_assemble():
    in_loop = {"fused.wire_wait": (1.0, 4), "fused.assemble": (5.0, 4),
               "fused.drain_wait": (1.5, 2), "fused.emit": (2.0, 2)}
    after = dict(in_loop, **{"fused.drain_wait": (3.0, 3), "fused.final_drain": (2.5, 1),
                             "finish.occ_compute": (7.0, 3)})
    t = fused_timers(in_loop, after)
    assert len(t) == 10 and min(t.values()) >= 0
    assert t["assemble"] == pytest.approx(1.5)
    assert (t["drain_wait"], t["final_drain"], t["w_occ_compute"]) == (1.5, 2.5, 7.0)
    assert t["decode"] == t["w_nuc_compute"] == 0.0


def test_fused_log_gives_its_batches_and_nibble_fallbacks(tmp_path, monkeypatch, caplog):
    """Every batch after the first forced onto the nibble program: the
    log line counts those batches as nibble fallbacks, among all the
    loop's batches, and the outputs are the 2-bit run's."""
    ex = make_example(str(tmp_path))
    cfg = RunConfig(window=WindowParams(core=256, batch=4, finish_threads=0))

    def run(out):
        with caplog.at_level(logging.INFO, logger="nucleoatac"):
            run_pipeline(ex["bam"], ex["bed"], str(tmp_path / out), fasta_path=ex["fasta"],
                         cfg=cfg, write_plots=False, device="cpu")
        line = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("fused timers")][-1]
        return {k: int(v) for k, v in re.findall(r"(batches|nibble_batches)=(\d+)", line)}

    plain = run("plain")
    real, packs = fused.pack_2bit_codes, []

    def first_only(rows):
        packed2, esc, ok = real(rows)
        packs.append(ok)
        return packed2, esc, ok and len(packs) == 1

    monkeypatch.setattr(fused, "pack_2bit_codes", first_only)
    forced = run("forced")
    assert plain["nibble_batches"] == 0 and plain["batches"] == forced["batches"] > 1
    assert forced["nibble_batches"] == len(packs) - 1 == forced["batches"] - 1
    for sfx in RUN_SUFFIXES:
        with open(str(tmp_path / "plain") + sfx, "rb") as a, \
                open(str(tmp_path / "forced") + sfx, "rb") as b:
            assert a.read() == b.read(), sfx


# ---------------- the replay-to-stage splitter ------------------------------
def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _write(tmp_path, name, ev):
    p = tmp_path / name
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def _eager(tmp_path):
    """An eager step: k_a in engine._raster_pool, k_b and k_c in
    engine._xcorr nested in engine._nucm16, k_d launched outside every
    range."""
    ev = [_x("engine._raster_pool", "user_annotation", 0, 10),
          _x("engine._nucm16", "user_annotation", 20, 40),
          _x("engine._xcorr", "user_annotation", 22, 10)]
    for i, (name, launch) in enumerate((("k_a", 2), ("k_b", 24), ("k_c", 30),
                                        ("k_d", 70))):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, 1, correlation=i),
               _x(name, "kernel", 100 + 10 * i, 5, correlation=i, device=0)]
    return _write(tmp_path, "eager.json", ev)


def test_stage_sequence_takes_the_innermost_range(tmp_path):
    assert stages.stage_sequence(_eager(tmp_path)) == [
        ("k_a", "engine._raster_pool"), ("k_b", "engine._xcorr"),
        ("k_c", "engine._xcorr"), ("k_d", stages.NO_STAGE)]


def test_replay_stages_sum_matching_replays_and_report_the_others(tmp_path):
    seq = stages.stage_sequence(_eager(tmp_path))
    ev = [_x("graphs.copy_in", "user_annotation", 0, 8),
          _x("cudaMemcpyAsync", "cuda_runtime", 2, 1, correlation=900),
          _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 10, 4, correlation=900,
             device=0)]
    replays = [("k_a", "k_b", "k_c", "k_d"),  # matches
               ("k_a", "k_c", "k_b", "k_d"),  # another order: mismatched at 1
               ("k_a", "k_b"),  # records lost
               ("k_a", "k_b", "k_c", "k_d")]  # matches
    for r, names in enumerate(replays):
        corr = 1000 + r
        ev.append(_x("cudaGraphLaunch", "cuda_runtime", 20 + 100 * r, 2, correlation=corr))
        # given out of start order: the splitter sorts them
        for j, name in reversed(list(enumerate(names))):
            ev.append(_x(name, "kernel", 30 + 100 * r + 10 * j, 1 + j, correlation=corr,
                         device=0))
    rs = stages.replay_stages(_write(tmp_path, "replays.json", ev), seq, n_batches=4)
    assert (rs["replays"], rs["matched"], rs["ops"]) == (4, 2, 4)
    assert rs["lost"] == [{"replay": 2, "ops": 2}]
    (mis,) = rs["mismatched"]
    assert (mis["replay"], mis["at"], mis["want"], mis["got"]) == (1, 1, "k_b", "k_c")
    # us per matched replay -> ms: k_a 1, k_b 2, k_c 3, k_d 4
    assert rs["stages_ms"] == pytest.approx(
        {"engine._raster_pool": 0.001, "engine._xcorr": 0.005, stages.NO_STAGE: 0.004})
    assert list(rs["stages_ms"]) == ["engine._raster_pool", "engine._xcorr",
                                     stages.NO_STAGE]
    # the named stages leave out k_d, which no range launched
    assert rs["stage_sum_ms"] == pytest.approx(0.006)
    assert rs["replay_ms"] == pytest.approx(0.010)
    assert rs["top_ops"][:2] == [[stages.NO_STAGE, "k_d", pytest.approx(0.004)],
                                 ["engine._xcorr", "k_c", pytest.approx(0.003)]]
    assert rs["outside"] == pytest.approx({"graphs.copy_in": 0.004 / 4})


def test_stage_sequence_takes_the_steps_majority(tmp_path):
    """Three eager steps, each inside an EAGER_STEP range; the first lost
    its first record: the sequence is the one the other two show."""
    ev = []
    for s, t in enumerate((0, 1000, 2000)):
        ev += [_x(stages.EAGER_STEP, "user_annotation", t, 500),
               _x("engine._raster_pool", "user_annotation", t + 10, 100),
               _x("engine._u16", "user_annotation", t + 200, 100)]
        for j, (name, at) in enumerate((("k_a", 20), ("k_b", 30), ("k_c", 210))):
            if s == 0 and j == 0:
                continue
            corr = 10 * s + j
            ev += [_x("cudaLaunchKernel", "cuda_runtime", t + at, 1, correlation=corr),
                   _x(name, "kernel", t + 300 + 10 * j, 5, correlation=corr, device=0)]
    assert stages.stage_sequence(_write(tmp_path, "eager3.json", ev)) == [
        ("k_a", "engine._raster_pool"), ("k_b", "engine._raster_pool"),
        ("k_c", "engine._u16")]


def _report(**kw):
    rs = {"replays": 8, "matched": 8, "ops": 4, "lost": [], "mismatched": [],
          "stages_ms": {"engine._xcorr": 1.0}, "stage_sum_ms": 1.0, "replay_ms": 1.0}
    rs.update(kw)
    return rs


@pytest.mark.parametrize("rs, fault", [
    (_report(), None),
    (_report(stage_sum_ms=0.995), None),  # within 1%
    (None, "no replay_stages"),
    (_report(matched=7, lost=[{"replay": 0, "ops": 2}]), "7 of 8 replays match"),
    (_report(matched=7, mismatched=[{"replay": 3, "at": 1}]), "7 of 8 replays match"),
    (_report(matched=6), "6 of 8 replays match"),
    (_report(stages_ms={"engine._xcorr": 0.9, stages.NO_STAGE: 0.1}, stage_sum_ms=0.9),
     "the named stages sum to 0.9000 ms"),
])
def test_replay_stages_fault(rs, fault):
    got = stages.replay_stages_fault(rs, 8)
    assert got == fault if fault is None else fault in got


def test_replay_stages_fault_finds_an_op_outside_every_stage(tmp_path):
    """The handmade eager step launches k_d outside every range: its
    replays match name for name, and the check still fails on the 4 of
    10 us that no stage holds; with k_d in a range it passes."""
    seq = stages.stage_sequence(_eager(tmp_path))
    ev = []
    for r in range(2):
        ev.append(_x("cudaGraphLaunch", "cuda_runtime", 100 * r, 2, correlation=50 + r))
        for j, (name, _) in enumerate(seq):
            ev.append(_x(name, "kernel", 10 + 100 * r + 10 * j, 1 + j, correlation=50 + r,
                         device=0))
    path = _write(tmp_path, "two.json", ev)
    rs = stages.replay_stages(path, seq, n_batches=2)
    assert rs["matched"] == 2 and not rs["lost"] and not rs["mismatched"]
    assert "(no stage) 0.0040 ms" in stages.replay_stages_fault(rs, 2)
    staged = [(n, st if st != stages.NO_STAGE else "engine._u16") for n, st in seq]
    assert stages.replay_stages_fault(stages.replay_stages(path, staged, 2), 2) is None
