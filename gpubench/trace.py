"""The traced span of a ``--trace 1`` run and its reading.

Once the measured window has closed, the same loop runs on, steady and
warm, under one torch.profiler session (CPU and CUDA activities) that
records a bounded span: ``warmup`` steps traced and dropped (attaching
the profiler takes seconds, and the first graph replay CUPTI sees after it
attaches can lose kernel records), then ``active`` steps, one step per
batch the program finishes. The window's spans stay free of the
profiler's cost. The chrome trace goes to a temporary directory under
TMPDIR, is read, and is deleted.

``read`` is the interval arithmetic of the program's trace reader
(profiling/stages.py::read_trace), copied: the union of each device's
operation intervals (kernels, copies, sets) inside the traced window, the
longest idle gaps between them, each named by the innermost host op at
its midpoint, and kernel time by name. The window is the span of the
profiler's step markers.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Tracer:
    """One profiler session over ``warmup`` + ``active`` batches of the
    loop, once the measured window has closed: ``step()`` after each
    batch the program finishes; True once the session has ended."""

    WARMUP, ACTIVE = 4, 32

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.warmup, self.active = warmup, active = self.WARMUP, self.ACTIVE
        self.steps = 0
        self.dir = tempfile.TemporaryDirectory(prefix="gpubench-trace-")
        self.path = os.path.join(self.dir.name, "window.pt.trace.json")
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=warmup, active=active, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self.prof.start()

    def step(self) -> bool:
        self.prof.step()
        self.steps += 1
        if self.steps == self.warmup + self.active:
            self.prof.stop()
            return True
        return False

    def read(self):
        """The summary of the recorded span, or None if none was recorded."""
        try:
            if not os.path.exists(self.path):
                return None
            return read(self.path, self.active)
        finally:
            self.dir.cleanup()


def _union(ops, lo, hi):
    spans = []
    for e in ops:
        a, b = max(e["t0"], lo), min(e["t1"], hi)
        if b <= a:
            continue
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans


def read(path: str, n_batches: int, n_gaps: int = 10) -> dict:
    """Busy seconds per device over the traced window, the window's
    length, kernel seconds and launches by name (all devices, kernels that
    start in the window), and the ``n_gaps``
    longest idle gaps of the first device with the host op running at
    each midpoint (None: Python between ops)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    for e in events:
        e["t0"], e["t1"] = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    steps = [e for e in events if e["name"].startswith("ProfilerStep#")]
    if steps:
        lo, hi = min(e["t0"] for e in steps), max(e["t1"] for e in steps)
    else:
        lo, hi = min(e["t0"] for e in events), max(e["t1"] for e in events)
    by_dev = defaultdict(list)
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["t0"]):
        by_dev[int(e.get("args", {}).get("device", 0))].append(e)
    busy = {d: sum(b - a for a, b in _union(ops, lo, hi)) / 1e6 for d, ops in by_dev.items()}
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    for e in events:  # kernels that start inside the window, whole
        if e.get("cat") == "kernel" and lo <= e["t0"] < hi:
            kernel_s[e["name"]] += e["dur"] / 1e6
            kernel_n[e["name"]] += 1
    host = [e for e in events if e.get("cat") in HOST_CATS
            and not e["name"].startswith("ProfilerStep#")]

    def innermost(t):
        cover = [e for e in host if e["t0"] <= t <= e["t1"]]
        return min(cover, key=lambda e: e["dur"])["name"] if cover else None

    gaps = []
    if by_dev:
        first = _union(by_dev[min(by_dev)], lo, hi)
        edges = [[lo, lo]] + first + [[hi, hi]]
        pairs = sorted(zip(edges, edges[1:]), key=lambda p: p[0][1] - p[1][0])[:n_gaps]
        gaps = [[innermost((p[1] + q[0]) / 2), (q[0] - p[1]) / 1e6]
                for p, q in pairs if q[0] > p[1]]
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy, "kernel_s": dict(kernel_s),
            "kernel_n": dict(kernel_n), "batches": n_batches, "gaps": gaps}
