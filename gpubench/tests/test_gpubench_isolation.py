"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level module names are
compared whole (the program's name begins with the JAX package's)."""
import ast
import os
import subprocess
import sys

from conftest import REPO

JAX = {"jax", "jaxlib", "flax", "nucleoatac_tpu"}
GPUBENCH = os.path.join(REPO, "gpubench")


def _imports(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_import_in_the_benchmark():
    for p in _sources(GPUBENCH):
        assert not _imports(p) & JAX, p


def test_reference_is_plain_numpy():
    for p in _sources(os.path.join(GPUBENCH, "reference")):
        names = _imports(p)
        assert names <= {"numpy", "__future__", "typing"}, (p, names)


def test_a_run_loads_no_jax(tiny_root):
    """A whole run in a fresh process, JAX importable, leaves none of it
    in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench.harness import run_cell, forbidden_modules\n"
        "line = run_cell(%r, 'tiny.fused', 5, 2.0, False, device_type='cpu')\n"
        "assert line['correct'], line\n"
        "print(forbidden_modules())\n" % (REPO, tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    from gpubench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "nucleoatac_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax"]


def test_entry_refuses_without_cards_and_without_the_program(tmp_path):
    """No card: exit 2 and no result on standard output. A directory with
    only BENCHMARK.json and gpubench/: a non-zero exit and no result."""
    r = subprocess.run([sys.executable, os.path.join(GPUBENCH, "run.py"), "--workload",
                        "chrom-1card.fused", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    import shutil

    shutil.copytree(GPUBENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "chrom-1card.fused",
                        "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
