"""The trace reader's interval arithmetic and K2's count from shapes."""
import json

import pytest

from gpubench import roofline, trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_read_busy_window_kernels_and_gaps(tmp_path):
    ev = [
        _x("ProfilerStep#4", "user_annotation", 100.0, 400.0),
        _x("ProfilerStep#5", "user_annotation", 500.0, 500.0),
        _x("pack", "cpu_op", 150.0, 200.0),
        _x("nuc_scores_kernel", "kernel", 120.0, 60.0, device=0),
        _x("copy", "gpu_memcpy", 170.0, 20.0, device=0),  # overlaps the kernel
        _x("nuc_scores_kernel", "kernel", 400.0, 100.0, device=0),
        _x("reduce", "kernel", 900.0, 300.0, device=0),  # runs past the window
        _x("reduce", "kernel", 50.0, 30.0, device=0),  # before the window
        _x("nuc_scores_kernel", "kernel", 600.0, 50.0, device=1),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = trace.read(str(p), n_batches=2, n_gaps=3)
    assert s["window_s"] == pytest.approx(900e-6)
    # device 0: [120, 190) + [400, 500) + [900, 1000) inside [100, 1000)
    assert s["busy_s"][0] == pytest.approx(270e-6)
    assert s["busy_s"][1] == pytest.approx(50e-6)
    assert s["kernel_n"] == {"nuc_scores_kernel": 3, "reduce": 1}
    assert s["kernel_s"]["nuc_scores_kernel"] == pytest.approx(210e-6)
    assert s["kernel_s"]["reduce"] == pytest.approx(300e-6)  # whole, started inside
    # the longest idle gaps of device 0: [500, 900), [190, 400), [100, 120)
    assert [g[1] for g in s["gaps"]] == pytest.approx([400e-6, 210e-6, 20e-6])
    assert s["gaps"][1][0] == "pack"  # the host op at the gap's midpoint (295)
    assert s["gaps"][0][0] is None  # Python between ops


def test_k2_count_at_the_smoke_shapes():
    """At chip_smoke's K2 shapes ([64, 146, 1536] against a 147-tap
    template) the count from shapes gives PERF.md's 15.41 GFLOP and
    117.1 MB, and the least time is the bytes' (35.0 us)."""
    flops, nbytes = roofline.k2_work(64, 146, 1536, 147)
    assert round(flops / 1e9, 2) == 15.41
    assert round(nbytes / 1e6, 1) == 117.1
    t, by = roofline.least_time(flops, nbytes, roofline.peaks("NVIDIA H100 80GB HBM3"))
    assert by == "bytes" and t == pytest.approx(117.130896e6 / 3.35e12)
