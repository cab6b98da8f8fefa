"""nucleoatac_torch stands alone: in a process where `import jax` and
`import nucleoatac_tpu` both fail, every module imports,
run_pipeline(device='cpu') completes on the synthetic example in exact and
non-exact mode, and so do the two command lines, a one-host
`run --num_hosts 1 --host_id 0`, the entry points of entry.py and the
engine bench (with matplotlib blocked too, as on a machine without it,
under --no_plots). The example data is written by this
test process before the blocked one starts. No module of the port (nor
chip_smoke.py) names the JAX package in an import; the port's copied
config keeps the reference's defaults; its native code is its own .so
files."""
import ast
import dataclasses
import glob
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from synth import make_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "nucleoatac_torch")

PORT_MODULES = [
    "nucleoatac_torch",
    "nucleoatac_torch.config",
    "nucleoatac_torch.core",
    "nucleoatac_torch.core.chunk",
    "nucleoatac_torch.core.fragmentsizes",
    "nucleoatac_torch.core.mixture",
    "nucleoatac_torch.core.pwm",
    "nucleoatac_torch.core.vmat",
    "nucleoatac_torch.io",
    "nucleoatac_torch.io.bam",
    "nucleoatac_torch.io.bam_py",
    "nucleoatac_torch.io.bam_writer",
    "nucleoatac_torch.io.bedgraph",
    "nucleoatac_torch.io.bgzf",
    "nucleoatac_torch.io.fasta",
    "nucleoatac_torch.io.native",
    "nucleoatac_torch.io.native.binding",
    "nucleoatac_torch.io.tabix",
    "nucleoatac_torch.mirror",
    "nucleoatac_torch.mirror.windows",
    "nucleoatac_torch.utils.numerics",
    "nucleoatac_torch.models.data",
    "nucleoatac_torch.device",
    "nucleoatac_torch.parity",
    "nucleoatac_torch.kernels",
    "nucleoatac_torch.kernels.build",
    "nucleoatac_torch.ops",
    "nucleoatac_torch.ops.rasterize",
    "nucleoatac_torch.ops.pwmseq",
    "nucleoatac_torch.ops.biasmat",
    "nucleoatac_torch.ops.occupancy",
    "nucleoatac_torch.ops.smooth",
    "nucleoatac_torch.ops.xcorr",
    "nucleoatac_torch.ops.diag_xcorr",
    "nucleoatac_torch.ops.nuc_scores",
    "nucleoatac_torch.models",
    "nucleoatac_torch.models.params",
    "nucleoatac_torch.models.graphs",
    "nucleoatac_torch.models.engine",
    "nucleoatac_torch.models.occ",
    "nucleoatac_torch.models.nuc",
    "nucleoatac_torch.models.nuc_exact",
    "nucleoatac_torch.models.fused",
    "nucleoatac_torch.models.merge",
    "nucleoatac_torch.models.nfr",
    "nucleoatac_torch.models.standalone",
    "nucleoatac_torch.models.pipeline",
    "nucleoatac_torch.models.distributed_pipeline",
    "nucleoatac_torch.parallel",
    "nucleoatac_torch.parallel.distributed",
    "nucleoatac_torch.parallel.mesh",
    "nucleoatac_torch.utils",
    "nucleoatac_torch.utils.logging",
    "nucleoatac_torch.pyatac",
    "nucleoatac_torch.cli",
    "nucleoatac_torch.cli.nucleoatac",
    "nucleoatac_torch.cli.pyatac",
    "nucleoatac_torch.entry",
    "nucleoatac_torch.bench",
    "nucleoatac_torch.bench.common",
    "nucleoatac_torch.bench.engine",
    "nucleoatac_torch.bench.e2e",
    "nucleoatac_torch.bench.scaling",
    "nucleoatac_torch.bench.config5",
]


def _example(d: pathlib.Path) -> dict:
    """tests/synth.py's example written into ``d``, as a dict of str paths
    that a blocked subprocess can read from its source."""
    return {k: str(v) for k, v in make_example(d).items()}


def _run_without_jax(code: str, cwd) -> str:
    """Run ``code`` with jax and the JAX package blocked; the example data
    (make_example, which writes with the JAX package's writers) must be
    made before, in this process."""
    script = ("import sys\nsys.modules['jax'] = None\n"
              "sys.modules['nucleoatac_tpu'] = None\n" + textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_imports_without_jax(tmp_path):
    out = _run_without_jax(
        f"""
        import importlib
        for m in {PORT_MODULES!r}:
            importlib.import_module(m)
        assert sys.modules['jax'] is None and sys.modules['nucleoatac_tpu'] is None
        assert not [m for m in sys.modules if m.startswith('nucleoatac_tpu.')]
        print('imported', len({PORT_MODULES!r}))
        """,
        tmp_path,
    )
    assert f"imported {len(PORT_MODULES)}" in out


@pytest.mark.parametrize("exact", [True, False])
def test_run_pipeline_cpu_without_jax(tmp_path, exact):
    ex = _example(tmp_path)
    out = _run_without_jax(
        f"""
        import dataclasses
        from nucleoatac_torch.config import RunConfig, WindowParams
        from nucleoatac_torch.models.pipeline import run_pipeline
        ex = {ex!r}
        cfg = RunConfig(window=WindowParams(core=256, batch=4))
        cfg = dataclasses.replace(
            cfg, occ=dataclasses.replace(cfg.occ, exact={exact}),
            nuc=dataclasses.replace(cfg.nuc, exact={exact}))
        res = run_pipeline(
            ex['bam'], ex['bed'], 'out', fasta_path=ex['fasta'], cfg=cfg,
            write_plots=False, device='cpu',
        )
        assert sys.modules['jax'] is None and sys.modules['nucleoatac_tpu'] is None
        print('calls', len(res.nuc.calls), 'nfrs', len(res.nfrs))
        """,
        tmp_path,
    )
    assert "calls 4" in out
    assert (tmp_path / "out.nfrpos.bed.gz").exists()


def test_command_lines_cpu_without_jax_or_matplotlib(tmp_path):
    ex = _example(tmp_path)
    out = _run_without_jax(
        f"""
        sys.modules['matplotlib'] = None
        from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
        from nucleoatac_torch.cli.pyatac import main as pyatac
        ex = {ex!r}
        rc = nucleoatac(['occ', '--bed', ex['bed'], '--bam', ex['bam'],
                         '--out', 'st', '--batch', '4', '--device', 'cpu',
                         '--no_plots'])
        rc2 = pyatac(['sizes', '--bam', ex['bam'], '--out', 'sz', '--no_plots'])
        assert sys.modules['jax'] is None and sys.modules['matplotlib'] is None
        assert sys.modules['nucleoatac_tpu'] is None
        print('rc', rc, rc2)
        """,
        tmp_path,
    )
    assert "rc 0 0" in out
    assert (tmp_path / "st.occ.bedgraph.gz").exists()
    assert (tmp_path / "sz.fragmentsizes.txt").exists()


def test_one_host_run_without_jax(tmp_path):
    """`run --num_hosts 1 --host_id 0` writes its shard, then finalizes it
    itself (one host needs no barrier)."""
    ex = _example(tmp_path)
    out = _run_without_jax(
        f"""
        import os
        sys.modules['matplotlib'] = None
        from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
        ex = {ex!r}
        rc = nucleoatac(['run', '--bed', ex['bed'], '--bam', ex['bam'],
                         '--fasta', ex['fasta'], '--out', 'h', '--batch', '4',
                         '--device', 'cpu', '--no_plots', '--num_hosts', '1',
                         '--host_id', '0'])
        assert sys.modules['jax'] is None and sys.modules['nucleoatac_tpu'] is None
        print('rc', rc, 'parts', sum('.part' in f for f in os.listdir('.')))
        """,
        tmp_path,
    )
    assert "rc 0 parts 0" in out
    assert (tmp_path / "h.nfrpos.bed.gz").exists()
    assert (tmp_path / "h.nucpos.bed.gz.tbi").exists()


# ---------------- the port names nothing of the JAX package ----------------
def _python_sources():
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _jax_package_imports(path: str) -> list:
    """Every import or from-import in ``path`` that names nucleoatac_tpu."""
    bad = []
    for node in ast.walk(ast.parse(pathlib.Path(path).read_text(), path)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        bad += [f"{path}:{node.lineno} {n}" for n in names
                if n == "nucleoatac_tpu" or n.startswith("nucleoatac_tpu.")]
    return bad


def test_entry_points_without_jax(tmp_path):
    """entry() and dryrun_multichip over two CPU shards, which hold the
    sharded float-track step against the port's own float64 mirror and
    run the chained delta12 block (pool wires bitwise equal to it)."""
    out = _run_without_jax(
        """
        import torch
        from nucleoatac_torch.entry import dryrun_multichip, entry
        fn, args = entry(device="cpu")
        occ, nuc = fn(*args)
        assert all(bool(torch.isfinite(t).all()) for t in (*occ, *nuc))
        dry = dryrun_multichip(2, device="cpu")
        print("mirror", dry["mirror_err"] <= 1e-3)
        print("delta12", dry["delta12"]["bytes_equal"], dry["delta12"]["batch"])
        assert not [m for m in sys.modules if m.startswith(("jax", "nucleoatac_tpu"))
                    and sys.modules[m] is not None]
        """,
        tmp_path,
    )
    assert "mirror True" in out and "delta12 True 64" in out


def test_engine_bench_without_jax(tmp_path):
    """`python3 -m nucleoatac_torch.bench.engine --device cpu` at the tiny
    size, its e2e run included, prints its line; its files go under the
    test's directory."""
    out = _run_without_jax(
        f"""
        import json, runpy, tempfile
        sys.modules['matplotlib'] = None
        tempfile.tempdir = {str(tmp_path)!r}
        sys.argv = ['engine', '--device', 'cpu', '--core', '256', '--batch', '2',
                    '--frag-cap', '64', '--batches', '2', '--repeats', '1',
                    '--cpu-windows', '1', '--e2e-peaks', '2',
                    '--record', {str(tmp_path / "rec.json")!r}]
        try:
            runpy.run_module('nucleoatac_torch.bench.engine', run_name='__main__')
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not [m for m in sys.modules if m.startswith(("jax", "nucleoatac_tpu"))
                    and sys.modules[m] is not None]
        """,
        tmp_path,
    )
    line = json.loads(out.splitlines()[-1])
    assert line["value"] > 0 and line["e2e_peaks"] == 2 and line["device"] == "cpu"


def test_no_port_module_imports_the_jax_package():
    files = _python_sources()
    assert len(files) > 50 and files[-1].endswith("chip_smoke.py")
    bad = [b for f in files for b in _jax_package_imports(f)]
    assert not bad, bad


def test_the_static_check_sees_an_import_of_the_jax_package(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from nucleoatac_tpu.config import RunConfig\n"
                   "import nucleoatac_tpu\nimport nucleoatac_torch\n")
    assert len(_jax_package_imports(str(src))) == 2


def test_port_run_config_defaults_equal_the_reference():
    """The port's copied config cannot drift from the reference's: the
    default RunConfig() is equal field by field."""
    from nucleoatac_torch.config import RunConfig as TRunConfig
    from nucleoatac_tpu.config import RunConfig as JRunConfig

    mine, ref = dataclasses.asdict(TRunConfig()), dataclasses.asdict(JRunConfig())
    assert list(mine) == list(ref)
    for section in ref:
        assert mine[section] == ref[section], section


@pytest.mark.parametrize("lib", ["libnucio.so", "libnucrefine.so"])
def test_port_native_libraries_are_its_own_copies(lib):
    """nuc_exact and io.native.binding load the port's own .so files (a
    path inside nucleoatac_torch), not the numpy or pure-Python fallback;
    each is the reference's library byte for byte."""
    import filecmp

    from nucleoatac_torch.io.native import binding
    from nucleoatac_torch.models import nuc_exact

    native = os.path.join(PORT, "io", "native")
    assert nuc_exact._LIB is not None
    loaded = {"libnucrefine.so": nuc_exact._LIB._name, "libnucio.so": binding._lib._name}
    assert os.path.realpath(loaded[lib]) == os.path.realpath(os.path.join(native, lib))
    assert os.path.realpath(nuc_exact._LIB_PATH) == os.path.realpath(
        os.path.join(native, "libnucrefine.so"))
    ref = os.path.join(ROOT, "nucleoatac_tpu", "io", "native", lib)
    assert filecmp.cmp(os.path.join(native, lib), ref, shallow=False)
