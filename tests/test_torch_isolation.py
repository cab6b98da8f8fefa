"""nucleoatac_torch runs in a process where `import jax` fails: every
module imports, run_pipeline(device='cpu') completes on the synthetic
example in exact and non-exact mode, and so do the two command lines and
a one-host `run --num_hosts 1 --host_id 0` (with matplotlib blocked too,
as on a machine without it, under --no_plots)."""
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "nucleoatac_torch",
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
]


def _run_without_jax(code: str, cwd) -> str:
    script = "import sys\nsys.modules['jax'] = None\n" + textwrap.dedent(code)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
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
        assert sys.modules['jax'] is None
        print('imported', len({PORT_MODULES!r}))
        """,
        tmp_path,
    )
    assert f"imported {len(PORT_MODULES)}" in out


@pytest.mark.parametrize("exact", [True, False])
def test_run_pipeline_cpu_without_jax(tmp_path, exact):
    out = _run_without_jax(
        f"""
        import dataclasses, pathlib
        from synth import make_example
        from nucleoatac_tpu.config import RunConfig, WindowParams
        from nucleoatac_torch.models.pipeline import run_pipeline
        d = pathlib.Path('.')
        ex = make_example(d)
        cfg = RunConfig(window=WindowParams(core=256, batch=4))
        cfg = dataclasses.replace(
            cfg, occ=dataclasses.replace(cfg.occ, exact={exact}),
            nuc=dataclasses.replace(cfg.nuc, exact={exact}))
        res = run_pipeline(
            ex['bam'], ex['bed'], 'out', fasta_path=ex['fasta'], cfg=cfg,
            write_plots=False, device='cpu',
        )
        assert sys.modules['jax'] is None
        print('calls', len(res.nuc.calls), 'nfrs', len(res.nfrs))
        """,
        tmp_path,
    )
    assert "calls 4" in out
    assert (tmp_path / "out.nfrpos.bed.gz").exists()


def test_command_lines_cpu_without_jax_or_matplotlib(tmp_path):
    out = _run_without_jax(
        """
        import pathlib
        sys.modules['matplotlib'] = None
        from synth import make_example
        from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
        from nucleoatac_torch.cli.pyatac import main as pyatac
        ex = make_example(pathlib.Path('.'))
        rc = nucleoatac(['occ', '--bed', ex['bed'], '--bam', ex['bam'],
                         '--out', 'st', '--batch', '4', '--device', 'cpu',
                         '--no_plots'])
        rc2 = pyatac(['sizes', '--bam', ex['bam'], '--out', 'sz', '--no_plots'])
        assert sys.modules['jax'] is None and sys.modules['matplotlib'] is None
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
    out = _run_without_jax(
        """
        import os, pathlib
        sys.modules['matplotlib'] = None
        from synth import make_example
        from nucleoatac_torch.cli.nucleoatac import main as nucleoatac
        ex = make_example(pathlib.Path('.'))
        rc = nucleoatac(['run', '--bed', ex['bed'], '--bam', ex['bam'],
                         '--fasta', ex['fasta'], '--out', 'h', '--batch', '4',
                         '--device', 'cpu', '--no_plots', '--num_hosts', '1',
                         '--host_id', '0'])
        assert sys.modules['jax'] is None
        print('rc', rc, 'parts', sum('.part' in f for f in os.listdir('.')))
        """,
        tmp_path,
    )
    assert "rc 0 parts 0" in out
    assert (tmp_path / "h.nfrpos.bed.gz").exists()
    assert (tmp_path / "h.nucpos.bed.gz.tbi").exists()
