"""The port's bench drivers (nucleoatac_torch/bench) on the CPU at a small
size, against the reference's drivers and the JAX package (CPU backend):

  * engine.make_inputs draws bench.py's numbers for the same seed;
  * each batch of the timed loop, on wire v6 and on delta pairs, unpacks
    to the JAX DeviceEngine's grid indices and certified flags on the
    same bytes, its u16 norm within nuc.exact_tol + one quantization step
    (test_torch_forms' bar);
  * the CPU baseline's float64 arrays equal nucleoatac_tpu.mirror's;
  * run_e2e counts the reference's tile_chunks windows and the JAX
    run_pipeline's dyads and NFRs;
  * scaling --virtual 2 prints two lines with the reference's keys;
  * config5 over two hosts prints the one-host bytes;
  * every driver refuses "cuda" without a card and the relay's flags;
  * no driver touches ATSCALE.json, and the engine line's at-scale rows
    come from the port's own record.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu import mirror as jmirror
from nucleoatac_tpu.config import RunConfig as JRunConfig
from nucleoatac_tpu.config import WindowParams as JWindowParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.models import data as jdata
from nucleoatac_tpu.models.data import tile_chunks
from nucleoatac_tpu.models.pipeline import run_pipeline as jax_run_pipeline
from nucleoatac_torch.bench import common, config5, e2e, engine, scaling
from nucleoatac_torch.config import RunConfig, WindowParams
from nucleoatac_torch.entry import _tiny_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATSCALE = os.path.join(ROOT, "ATSCALE.json")
DRIVERS = {"engine": engine.main, "e2e": e2e.main, "scaling": scaling.main,
           "config5": config5.main}
# the engine bench at the tests' size: core 256, 2 windows x 64 fragments
TINY = ["--core", "256", "--batch", "2", "--frag-cap", "64", "--batches", "2"]


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(autouse=True)
def atscale_untouched(tmp_path, monkeypatch):
    """Every test here leaves ATSCALE.json (the reference's TPU runs) as it
    was; the drivers' temporary files go under the test's directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = _sha(ATSCALE)
    yield
    assert _sha(ATSCALE) == before


@pytest.fixture(scope="module")
def engines():
    """(the JAX DeviceEngine, the port's CPU TorchEngine), both
    _tiny_engine(core=256, batch=2)."""
    from __graft_entry__ import _tiny_engine as jax_tiny_engine

    return jax_tiny_engine(core=256, batch=2)[1], _tiny_engine(core=256, batch=2,
                                                               device="cpu")[1]


def test_make_inputs_draws_the_reference_numbers(engines):
    from bench import make_inputs as ref_make_inputs

    _, teng = engines
    shape = (3, 2, 64, teng.width, teng.seq_codes_width())
    got = engine.make_inputs(np.random.default_rng(1), *shape)
    want = ref_make_inputs(np.random.default_rng(1), *shape)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[2]) == len(want[2]) == 3
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wire", engine.WIRES)
def test_timed_loop_unpacks_to_the_jax_engine(engines, wire):
    """The port's timed loop at core 256, batch 2, 64 fragments and 2
    batches: each batch's unpack_run against DeviceEngine's on the same
    bytes (encoded by the JAX package's own encoders)."""
    jeng, teng = engines
    B, F, W = 2, 64, teng.width
    mids, szs, nibs = engine.make_inputs(np.random.default_rng(5), 2, B, F, W,
                                         teng.seq_codes_width())
    got = []
    wall = engine.run_loop(teng, wire, mids, szs, nibs, collect=got)
    assert wall > 0 and len(got) == 2 and teng.steps >= 2
    tol = RunConfig().nuc.exact_tol
    for i, (ti, tc, tn, tq) in enumerate(got):
        if wire == "delta12":
            E = jdata.delta12_entry_capacity(F, W)
            buf = np.zeros((B, E // 2 + E), np.uint8)
            jdata.encode_delta12_batch(mids[i], szs[i], buf)
            out = jeng.run_step_delta12(jnp.asarray(buf), jnp.asarray(nibs[i]))
        else:
            buf = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
            jdata.encode_delta_batch(mids[i], szs[i], buf)
            out = jeng.run_step_delta(jnp.asarray(buf), jnp.asarray(nibs[i]))
        np.testing.assert_array_equal(buf, engine.encode(wire, mids[i], szs[i], W))
        ji, jc, jn, jq = jeng.unpack_run(np.asarray(out))
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ti, ji)
        assert jc.mean() > 0.25  # certified positions at 64 fragments per window
        assert (np.abs(tn - jn) <= tol + np.maximum(jq, tq)[:, None]).all()
        assert np.abs(tn).max() > 0


def test_cpu_baseline_equals_the_reference_mirror(engines):
    """baseline_window's float64 arrays against the same steps of
    nucleoatac_tpu.mirror on the JAX engine's tables, for the baseline's
    own draws (bench.py's order: sequences, mids, sizes, log-bias rows)."""
    jeng, teng = engines
    cfg = JRunConfig(window=JWindowParams(core=256, batch=2))
    inputs = engine.baseline_inputs(np.random.default_rng(3), teng, 2, 64)
    pwm = jeng.pwm
    W = jeng.width
    for b in range(2):
        seq, mids, szs, logb = (x[b] for x in inputs)
        got = engine.baseline_window(teng, mids, szs, seq, logb)
        mat = jmirror.rasterize(mids, szs, 0, cfg.sizes.upper, W)
        occ = jmirror.occupancy_window(mat, np.asarray(jeng.log_mix, np.float64),
                                       np.asarray(jeng.alpha_grid, np.float64),
                                       cfg.occ.flank)
        lb = pwm.bias_track(seq)[pwm.up: pwm.up + W]
        b0 = jmirror.bias_mat(lb, np.asarray(jeng.size_probs, np.float64), cfg.vmat.lower,
                              cfg.vmat.upper, jeng.core_lo, jeng.core_hi)
        sc = jmirror.nuc_scores(mat[cfg.vmat.lower: cfg.vmat.upper], b0, jeng.vmat.mat)
        want = {"mat": mat, "log_bias": lb, "b0": b0,
                "smooth": jmirror.gauss_smooth(sc.norm, cfg.nuc.smooth_sd)}
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        for a, w in zip(got["occ"], occ):
            np.testing.assert_array_equal(a, w)
        for a, w in zip(got["scores"], sc):
            np.testing.assert_array_equal(a, w)
        assert np.abs(got["scores"].norm).max() > 0
    assert engine.baseline_s(teng, inputs) > 0


def test_run_e2e_counts_the_reference_windows_dyads_and_nfrs(tmp_path):
    """run_e2e on 1 chrom x 6 peaks x 200 fragments (batch 8) against the
    reference's tile_chunks and the JAX run_pipeline on the same files."""
    bam, bed, fa = common.dataset(str(tmp_path), 1, 6, 2000, 200)
    cfg = RunConfig(window=WindowParams(batch=8))
    line = e2e.run_e2e(bam, bed, fa, str(tmp_path / "port"), cfg, "cpu")
    jcfg = JRunConfig(window=JWindowParams(batch=8))
    chunks = ChunkList.read(bed, scan_bam(bam).chrom_dict).merge()
    assert line["windows"] == len(tile_chunks(chunks, jcfg.window, jcfg.occ, jcfg.vmat)) > 6
    ref = jax_run_pipeline(bam, bed, str(tmp_path / "jax"), fasta_path=fa, cfg=jcfg,
                           write_plots=False)
    assert line["dyads_called"] == len(ref.nuc.calls) > 0
    assert line["nfrs"] == len(ref.nfrs) > 0
    assert line["peaks"] == 6 and line["fragments"] == 1200
    assert line["steps"] == -(-line["windows"] // 8)
    assert line["device"] == "cpu" and line["wall_s"] > 0 and line["peak_rss_MB"] > 0


def test_scaling_virtual_prints_a_line_per_device_count(capsys):
    assert scaling.main(["--device", "cpu", "--virtual", "2", "--per-device-batch", "1",
                         "--frag-cap", "64", "--iters", "1", "--core", "256"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["devices"] for x in lines] == [1, 2]
    for x in lines:
        assert {"devices", "batch", "windows_per_s", "weak_scaling_efficiency",
                "virtual"} <= set(x)
        assert x["virtual"] is True and x["windows_per_s"] > 0
    assert [x["batch"] for x in lines] == [1, 2]
    assert lines[1]["steps"] == 2 * 4  # a warm-up and 3 timed calls, 2 shards each


def test_config5_two_hosts_print_the_one_host_bytes(tmp_path):
    """config5 on the CPU, 2 hosts x 1 sample x 8 peaks, in a process of its
    own under a time limit: the ten outputs byte-identical, the run in the
    record."""
    rec = tmp_path / "rec.json"
    proc = subprocess.run(
        [sys.executable, "-m", "nucleoatac_torch.bench.config5", "--device", "cpu",
         "--peaks", "8", "--chroms", "1", "--frags-per-peak", "200", "--hosts", "2",
         "--samples", "1", "--batch", "4", "--workdir", str(tmp_path), "--timeout", "240",
         "--record", str(rec)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = json.loads(proc.stdout.splitlines()[-1])
    (sample,) = last["config5"]
    assert sample["outputs_identical"] and sample["diff_files"] == []
    assert len(sample["shard_walls_s"]) == 2 and sample["windows"] == 16
    (row,) = common.read_record(str(rec))
    assert row["kind"] == "config5" and row["backend"] == "cpu" and row["hosts"] == 2


def test_config5_reports_a_byte_difference(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for prefix in (a, b):
        for sfx in config5.OUTPUTS:
            with open(prefix + sfx, "wb") as fh:
                fh.write(b"x")
    assert config5.compare_outputs(a, b) == []
    with open(b + config5.OUTPUTS[4], "wb") as fh:
        fh.write(b"y")
    os.remove(a + config5.OUTPUTS[0])
    assert config5.compare_outputs(a, b) == [config5.OUTPUTS[0] + " (missing)",
                                             config5.OUTPUTS[4]]


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_refuse_cuda_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DRIVERS[name](["--device", "cuda"] + (["--record", str(tmp_path / "r.json")]
                                               if name in ("engine", "e2e", "config5") else []))
    assert not (tmp_path / "r.json").exists()


@pytest.mark.parametrize("name", sorted(DRIVERS))
@pytest.mark.parametrize("flag", [["--fetch-threads", "8"], ["--platform", "cpu"]])
def test_drivers_refuse_the_relay_flags(name, flag):
    with pytest.raises(SystemExit) as err:
        DRIVERS[name](["--device", "cpu"] + flag)
    assert err.value.code == 2


def test_engine_line_reads_its_at_scale_rows_from_the_port_record(tmp_path, capsys):
    """The engine line at the tests' size, with its e2e part, on a record
    that e2e.py wrote: no at-scale keys (the row is below 10,000 peaks,
    and ATSCALE.json's TPU rows are not read); then, with an e2e and a
    config5 row of 10,000 peaks in the record, their numbers."""
    rec = str(tmp_path / "rec.json")
    assert e2e.main(["--device", "cpu", "--peaks", "2", "--chroms", "1",
                     "--frags-per-peak", "200", "--workdir", str(tmp_path),
                     "--record", rec]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert {"metric", "value", "unit", "wall_s", "peaks", "fragments", "ingest_MBps",
            "ingest_frags_per_s", "bam_MB", "peak_rss_MB", "dyads_called", "nfrs",
            "synth_s", "windows_per_s", "device"} <= set(row)
    (written,) = common.read_record(rec)
    assert written["kind"] == "e2e" and written["backend"] == "cpu"
    assert written["device"] is None and written["windows"] == row["windows"]

    def line():
        assert engine.main(TINY + ["--repeats", "2", "--cpu-windows", "1",
                                   "--e2e-peaks", "2", "--device", "cpu",
                                   "--record", rec]) == 0
        return json.loads(capsys.readouterr().out.splitlines()[-1])

    first = line()
    assert {"metric", "value", "unit", "vs_baseline", "e2e_windows_per_s", "e2e_peaks",
            "e2e_wall_s", "e2e_vs_engine", "device"} <= set(first)
    assert len(first["repeats_windows_per_s"]) == 2 and first["device"] == "cpu"
    assert "per CPU process" in first["metric"] and first["host_cores"] >= 1
    assert not [k for k in first if k.startswith(("config4", "config5"))]
    cpu = torch.device("cpu")
    common.record(dict(written, peaks=10000, windows_per_s=1.5, wall_s=2.5), cpu, rec)
    common.record({"kind": "config5", "hosts": 2, "samples": 1, "peaks": 10000,
                   "wall_s": 3.5, "windows": 20000, "windows_per_s": 4.5}, cpu, rec)
    second = line()
    assert (second["config4_windows_per_s"], second["config4_wall_s"],
            second["config4_peaks"], second["config4_backend"]) == (1.5, 2.5, 10000, "cpu")
    assert (second["config5_windows_per_s"], second["config5_hosts"],
            second["config5_backend"]) == (4.5, 2, "cpu")
    assert len(common.read_record(rec)) == 3


def test_record_keeps_the_last_rows(tmp_path):
    rec = str(tmp_path / "rec.json")
    for i in range(common.KEEP + 3):
        common.record({"kind": "e2e", "i": i}, torch.device("cpu"), rec)
    rows = common.read_record(rec)
    assert len(rows) == common.KEEP and rows[0]["i"] == 3 and rows[-1]["i"] == common.KEEP + 2
    assert common.read_record(str(tmp_path / "none.json")) == []


def test_breakdown_splits_the_loop(engines):
    _, teng = engines
    mids, szs, nibs = engine.make_inputs(np.random.default_rng(2), 2, 2, 64, teng.width,
                                         teng.seq_codes_width())
    split = engine.breakdown(teng, "delta12", mids, szs, nibs, depth=3)
    assert split["encode_ms"] > 0 and split["loop_without_encode_ms"] > 0
    assert split["pin_ms"] is None  # pinning needs a card
