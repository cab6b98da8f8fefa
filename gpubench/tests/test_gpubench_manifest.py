"""A cell, a configuration, a traffic mix and a metric are added as new
files and a new manifest entry: the harness finds each by name and runs
it, and no file that was there is edited."""
import hashlib
import json
import os

from conftest import tiny_config
from gpubench.harness import run_cell


def _hashes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(os.path.join(root, "gpubench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tiny_root):
    before = _hashes(tiny_root)
    g = os.path.join(tiny_root, "gpubench")
    cfg = tiny_config("tiny-core512", 1, 2)
    cfg["run_config"]["window"]["core"] = 512
    with open(os.path.join(g, "configs", "tiny-core512.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(g, "traffic", "fused-depth2.json"), "w") as fh:
        json.dump({"route": "fused", "depth": 2, "sample_batches": 2, "sample_rows": 2,
                   "data": {"frags_per_peak": 300}}, fh)
    with open(os.path.join(g, "metrics", "loop.batches_per_s.py"), "w") as fh:
        fh.write("def read(run):\n    return run.batches / run.window_s\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        m = json.load(fh)
    m["configs"].append({"name": "tiny-core512", "source": "https://example.org",
                         "file": "gpubench/configs/tiny-core512.json", "reduced": [],
                         "why": "new"})
    m["workloads"].append({"name": "tiny-core512.fused-depth2", "config": "tiny-core512",
                           "traffic": "fused-depth2", "chips": 1, "why": "new"})
    m["end_to_end"].append({"name": "loop.batches_per_s", "unit": "batches/s",
                            "better": "higher", "bound": 0.1, "source": "host_clock",
                            "workloads": ["tiny-core512.fused-depth2"]})
    with open(path, "w") as fh:
        json.dump(m, fh)

    line = run_cell(tiny_root, "tiny-core512.fused-depth2", 2**31 + 31, 3.0, False,
                    device_type="cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"]["loop.batches_per_s"]["value"] > 0
    assert "windows_per_s" in line["metrics"]
    # the old cells do not report the new metric
    old = run_cell(tiny_root, "tiny.fused", 2**31 + 32, 3.0, False, device_type="cpu")
    assert "loop.batches_per_s" not in old["metrics"]
    after = _hashes(tiny_root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "gpubench/configs/tiny-core512.json", "gpubench/traffic/fused-depth2.json",
        "gpubench/metrics/loop.batches_per_s.py"}
