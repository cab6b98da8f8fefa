"""Fixtures of the benchmark's CPU tests: a checkout-like tree in a
temporary folder holding a copy of gpubench/ and a BENCHMARK.json of tiny
cells, which the harness runs on the CPU (the plain path of the program).

Run: python3 -m pytest gpubench/tests -q
"""
import copy
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_DATA = {"chroms": 2, "peaks_per_chrom": 3, "peak_bp": 600, "gap_bp": 400,
             "frags_per_peak": 400}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test without one")


def tiny_config(name: str, cards: int, batch: int) -> dict:
    with open(os.path.join(REPO, "gpubench", "configs", "chrom-1card.json")) as fh:
        c = json.load(fh)
    c = copy.deepcopy(c)
    c["name"], c["cards"] = name, cards
    c["run_config"]["window"].update(core=256, batch=batch)
    c["data"].update(TINY_DATA)
    return c


def make_tree(root: str, cells=(("tiny", 1, 4, "fused"), ("tiny", 1, 4, "twopass"),
                                ("tiny2", 2, 4, "fused"))) -> str:
    """A checkout-like tree under ``root``: gpubench/ copied, tiny
    configurations and a manifest of their cells (the real manifest's
    metrics)."""
    shutil.copytree(os.path.join(REPO, "gpubench"), os.path.join(root, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        m = json.load(fh)
    m["configs"], m["workloads"] = [], []
    for name, cards, batch, traffic in cells:
        f = f"gpubench/configs/{name}.json"
        if not any(c["name"] == name for c in m["configs"]):
            with open(os.path.join(root, f), "w") as fh:
                json.dump(tiny_config(name, cards, batch), fh)
            m["configs"].append({"name": name, "source": "https://example.org", "file": f,
                                 "reduced": [], "why": "tiny"})
        m["workloads"].append({"name": f"{name}.{traffic}", "config": name,
                               "traffic": traffic, "chips": cards, "why": "tiny"})
    for metric in m["per_layer"]:
        metric.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(m, fh)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tree(str(tmp_path))
