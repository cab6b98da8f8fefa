"""One run of one cell: set-up, the measured window, the check, the line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name BENCHMARK.json gives it:

- a configuration: the ``file`` of its entry under ``configs`` (the
  stated run configuration, the devices, the dataset's numbers);
- a traffic mix: gpubench/traffic/<traffic>.json (the route that drives
  the program, the pipeline depth, overrides of the run configuration or
  of the dataset's numbers);
- a metric: gpubench/metrics/<name>.py, whose ``read(run)`` returns the
  number or None when the run has nothing to read for it (the line then
  leaves it out);
- the limits of the correctness check: gpubench/limits/<config>.<traffic>.json,
  else gpubench/limits/default.json.

A run: the dataset from the seed, the program's objects, one warm pass of
the route over the whole dataset (every step signature built), then the
window of ``seconds`` on a synchronised card, a sample of the outputs kept
from the seed. After the window: the device and host peaks are read, the
program's state is freed, the reference works out the sampled windows and
the comparison decides ``correct``.
"""
from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import resource
import sys
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "nucleoatac_tpu")


class Cell:
    """A workload of the manifest, with its configuration, traffic and
    metric entries resolved by name."""

    def __init__(self, root: str, workload: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.manifest = json.load(fh)
        w = {x["name"]: x for x in self.manifest["workloads"]}.get(workload)
        if w is None:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = w
        entry = {c["name"]: c for c in self.manifest["configs"]}[w["config"]]
        with open(os.path.join(root, entry["file"])) as fh:
            self.config = json.load(fh)
        with open(os.path.join(root, "gpubench", "traffic", f"{w['traffic']}.json")) as fh:
            self.traffic = json.load(fh)
        self.chips = int(w["chips"])
        self.stated = copy.deepcopy(self.config["run_config"])
        for group, fields in self.traffic.get("run_config", {}).items():
            self.stated.setdefault(group, {}).update(fields)
        self.data_spec = dict(self.config["data"], **self.traffic.get("data", {}))

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that apply here."""
        name = self.workload["name"]
        return [m for m in self.manifest[kind] if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        path = os.path.join(self.root, "gpubench", "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What the metric readers read: the window's counts and clocks, the
    spans, the program's step programs, the trace summary and the
    shapes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _peak_reserved(devs) -> int:
    import torch

    return max((torch.cuda.max_memory_reserved(d) for d in devs if d.type == "cuda"),
               default=0)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device_type: str = "cuda", t_process: float | None = None,
             hooks=None, control: bool = False) -> dict:
    """The result line of one run (a dict). ``device_type`` "cpu" runs the
    plain path for tests; ``hooks`` (tests) may wrap the port after
    set-up; ``control`` (gpubench/control.py) adds the control's numbers
    on the same sampled windows under "control"."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    from gpubench.check import Reference, compare, control_outputs, judge, limits
    from gpubench.data import make_dataset, rng_for
    from gpubench.inputs import tn5_pwm, vplot_template
    from gpubench.port import Port
    from gpubench.routes import ROUTES
    from gpubench.spans import Sampler, Spans
    from gpubench.trace import Tracer

    cell = Cell(root, workload)
    cuda = device_type == "cuda"
    data = make_dataset(cell.data_spec, seed)
    port = Port(cell.stated, data, cell.chips, device_type)
    if hooks is not None:
        hooks(port)
    spans = Spans(trace)
    route = ROUTES[cell.traffic["route"]](port, spans, int(cell.traffic["depth"]))
    for _ in route.stream(wrap=False):  # the warm pass
        pass
    port.synchronize()
    pass_tiles = [copy.copy(t) for t in route.pass_tiles()]
    sampler = Sampler(rng_for(seed + 1), int(cell.traffic["sample_batches"]),
                      int(cell.traffic["sample_rows"]))
    spans.total.clear()
    spans.count.clear()
    gc.collect()
    gc.freeze()

    done, batches = 0.0, 0
    stream = route.stream(wrap=True)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    t_end = t0 + seconds
    for kind, metas, share, out in stream:
        if time.perf_counter() > t_end:
            break
        n_real = len(metas)
        done += share * n_real
        batches += 1
        sampler.offer(kind, n_real, lambda rows: (
            kind, [copy.copy(metas[r]) for r in rows], np.array(out), rows))
    tracer = None
    if trace and cuda:  # the traced span: the same loop, after the window
        spans.on = False
        for _ in stream:
            if route.traceable(Tracer.WARMUP, Tracer.ACTIVE):
                break
        spans.annotate = True
        tracer = Tracer()
        for _ in stream:
            if tracer.step():
                break
        spans.annotate = False
    port.synchronize()
    stream.close()

    samples = []
    spans.on = trace
    for k in route.kinds:  # the program's host decode of the kept batches, timed
        for kind, metas, out, rows in sampler.items(k):
            with spans("unpack"):
                got = route.decode(kind, out)
            samples += [(kind, t, {f: np.array(v[r]) for f, v in got.items()})
                        for t, r in zip(metas, rows)]
    devs = list(dict.fromkeys(port.engine.devices))
    device_peak = _peak_reserved(devs) if cuda else 0
    rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    trace_summary = tracer.read() if tracer is not None else None
    eng = port.engine
    run = Run(windows=done, window_s=seconds, batches=batches, setup_s=setup_s,
              device_peak_bytes=device_peak, rss_peak_bytes=rss_peak, spans=spans,
              programs=eng.programs, trace=trace_summary, device_type=device_type,
              n_devices=len(eng.devices),
              shapes={"S": port.cfg.vmat.upper - port.cfg.vmat.lower, "W": eng.width,
                      "K": port.cfg.vmat.width, "B": port.cfg.window.batch // len(eng.devices)},
              kind=torch.cuda.get_device_name(0) if cuda else "cpu")
    metrics = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    del stream, route, port, eng
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    probs, up = tn5_pwm()
    v = cell.stated["vmat"]
    template = vplot_template(v["lower"], v["upper"], v["width"], v["smooth_sd_size"],
                              v["smooth_sd_pos"])
    ref = Reference(cell.stated, data, template, probs, up)
    result = compare(ref, samples, pass_tiles)
    correct, failed, rows = judge(result, limits(root, cell.workload["config"],
                                                 cell.workload["traffic"]))
    device = {"platform": "gpu" if cuda else "cpu", "kind": run.kind,
              "count": len(devs), "memory_peak_bytes": int(device_peak)}
    line = {"correct": bool(correct), "attempted": int(done), "failed": int(failed),
            "metrics": metrics, "device": device}
    if trace_summary is not None:
        busy = trace_summary["busy_s"]
        device["busy_s"] = sum(busy.values()) / len(devs)
        device["window_s"] = trace_summary["window_s"]
        top = sorted(trace_summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:100], s] for k, s in top],
                             "idle_gaps": [[(h or "python")[:100], s]
                                           for h, s in trace_summary["gaps"]]}
    line["sampled"] = {"windows": len(samples), "cert_share": result["cert_share"]}
    if control:
        ctl = compare(ref, [(k, t, control_outputs(ref, k, t)) for k, t, _ in samples],
                      pass_tiles)
        line["control"] = {"numbers": ctl["numbers"], "cert_share": ctl["cert_share"],
                           "windows": ctl["windows"]}
    line["checks"] = {name: {"value": val, "limit": lim} for name, val, lim in rows}
    return line


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
