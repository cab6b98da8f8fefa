"""The port's multi-host run (nucleoatac_torch.models.distributed_pipeline)
on the CPU: two hosts run in turn and finalized equal the single-host run
and meet the reference's bar against the JAX package's own two-host run;
the finalize guards refuse incomplete, stale or corrupted shards; the
sharded size histogram equals the full one; two gloo processes (jax
blocked) share the histogram and finish through the barrier; the command
line runs --num_hosts/--host_id, --finalize and --profile."""
import gzip
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from nucleoatac_tpu.config import RunConfig, WindowParams
from nucleoatac_torch.cli.nucleoatac import main as torch_nucleoatac
from nucleoatac_torch.models.distributed_pipeline import finalize_shards, run_distributed
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NUCPOS_SUFFIXES,
    RUN_SUFFIXES,
    SIGNAL_SUFFIXES,
    compare_runs,
)
from synth import make_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RunConfig(window=WindowParams(core=256, batch=4))
TEXT_SUFFIXES = (".occ.bedgraph.gz", ".occpeaks.bed.gz", ".nucpos.bed.gz",
                 ".nucmap_combined.bed.gz", ".nfrpos.bed.gz")


@pytest.fixture(scope="module")
def ex(tmp_path_factory):
    e = make_example(tmp_path_factory.mktemp("torch_dist"))
    # second peak chunk so the 2-host split is non-trivial
    with open(e["bed"], "a") as fh:
        fh.write("chr1\t3600\t5600\tpeak2\n")
    return e


def _text(path):
    with gzip.open(path, "rt") as fh:
        return fh.read()


def _two_hosts(ex, prefix, cfg=CFG, hosts=(0, 1)):
    for k in hosts:
        run_distributed(ex["bam"], ex["bed"], prefix, fasta_path=ex["fasta"],
                        cfg=cfg, host_id=k, num_hosts=2, device="cpu")


def _finalize(ex, prefix, cfg=CFG):
    finalize_shards(prefix, 2, ex["bam"], ex["bed"], ex["fasta"], None, cfg)


@pytest.fixture(scope="module")
def runs(ex, tmp_path_factory):
    """The port's single-host run, its two-host run (hosts in turn, then
    finalize) and the JAX package's two-host run, on one config."""
    from nucleoatac_tpu.models import distributed_pipeline as jdist
    from nucleoatac_torch.models.pipeline import run_pipeline

    d = tmp_path_factory.mktemp("torch_dist_runs")
    out = {k: str(d / k) for k in ("single", "multi", "jax")}
    run_pipeline(ex["bam"], ex["bed"], out["single"], fasta_path=ex["fasta"],
                 cfg=CFG, write_plots=False, device="cpu")
    _two_hosts(ex, out["multi"])
    _finalize(ex, out["multi"])
    for k in (0, 1):
        jdist.run_distributed(ex["bam"], ex["bed"], out["jax"], fasta_path=ex["fasta"],
                              cfg=CFG, host_id=k, num_hosts=2)
    jdist.finalize_shards(out["jax"], 2, ex["bam"], ex["bed"], ex["fasta"], None, CFG)
    return out, d


@pytest.mark.parametrize("suffix", TEXT_SUFFIXES)
def test_two_host_shards_equal_single_run(runs, suffix):
    out, _ = runs
    want = _text(out["single"] + suffix)
    assert want and _text(out["multi"] + suffix) == want
    assert os.path.exists(out["multi"] + suffix + ".tbi")


def test_two_host_nuc_dist_equal_and_no_shard_left(runs):
    out, d = runs
    s = np.loadtxt(out["single"] + ".nuc_dist.txt", ndmin=2)
    m = np.loadtxt(out["multi"] + ".nuc_dist.txt", ndmin=2)
    np.testing.assert_array_equal(s, m)
    assert s.sum() > 0
    assert not [f for f in os.listdir(d) if ".part" in f]


@pytest.fixture(scope="module")
def ref_stats(runs):
    out, _ = runs
    return compare_runs(out["jax"], out["multi"], CFG.nuc.exact_tol)


@pytest.mark.parametrize("suffix", EXACT_SUFFIXES + NUCPOS_SUFFIXES)
def test_two_host_rows_equal_reference_two_host_run(ref_stats, suffix):
    assert ref_stats[suffix] > 0


@pytest.mark.parametrize("suffix", SIGNAL_SUFFIXES)
def test_two_host_signal_within_exact_tol_of_reference(ref_stats, suffix):
    assert ref_stats[suffix + " max_abs_diff"] <= CFG.nuc.exact_tol


# ---------------- the finalize guard ---------------------------------------
def _corrupt(prefix):
    p = prefix + ".part1.nucpos.bed.gz"
    raw = bytearray(open(p, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(p, "wb").write(bytes(raw))


def _stale(prefix):
    mpath = prefix + ".part1.manifest.json"
    m = json.load(open(mpath))
    m["fingerprint"] = "deadbeefdeadbeef"
    json.dump(m, open(mpath, "w"))


@pytest.mark.parametrize("fault,hosts,match", [
    # host 1 crashed: no shard, no manifest
    (None, (0,), "did not complete"),
    # host 1's manifest is from another run or config
    (_stale, (0, 1), "stale"),
    # corrupted shard bytes fail the checksum
    (_corrupt, (0, 1), "checksum|size"),
])
def test_finalize_refuses_incomplete_or_stale_shards(ex, tmp_path, fault, hosts, match):
    prefix = str(tmp_path / "multi")
    _two_hosts(ex, prefix, hosts=hosts)
    if fault:
        fault(prefix)
    with pytest.raises(RuntimeError, match=match):
        _finalize(ex, prefix)
    assert not os.path.exists(prefix + ".nfrpos.bed.gz")
    # a fresh host 1 repairs it: intact shards merge
    _two_hosts(ex, prefix, hosts=(1,))
    _finalize(ex, prefix)
    assert os.path.exists(prefix + ".nfrpos.bed.gz")


def test_finalize_refuses_another_config(ex, tmp_path):
    """The fingerprint hashes the config: --finalize must get the hosts'
    flags."""
    import dataclasses

    prefix = str(tmp_path / "multi")
    _two_hosts(ex, prefix)
    other = dataclasses.replace(CFG, nuc=dataclasses.replace(CFG.nuc, min_z=2.5))
    with pytest.raises(RuntimeError, match="stale"):
        _finalize(ex, prefix, other)


# ---------------- the histogram ---------------------------------------------
def test_sharded_histogram_fit_equals_full_fit(ex):
    """Per-host shard histograms summed in host order reproduce the full
    histogram exactly, so the collective fit is bit-equal to the full fit."""
    from nucleoatac_tpu.core.chunk import ChunkList
    from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
    from nucleoatac_tpu.core.mixture import FragmentMixDistribution
    from nucleoatac_tpu.io.bam import scan_bam
    from nucleoatac_torch.models.occ import fit_mixture
    from nucleoatac_torch.parallel.distributed import host_tile_slice

    frags = scan_bam(ex["bam"])
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    fs_full, mix_full = fit_mixture(frags, chunks, CFG)
    nhosts = 3
    total = np.zeros_like(fs_full.vals)
    for pid in range(nhosts):
        fs_local = FragmentSizes(CFG.sizes.lower, CFG.sizes.upper)
        for c in ChunkList(host_tile_slice(chunks.chunks, pid, nhosts)):
            fs_local.add_sizes(frags.window(c.chrom, c.start, c.end)[1])
        total += fs_local.vals
    np.testing.assert_array_equal(total, fs_full.vals)
    fs = FragmentSizes(CFG.sizes.lower, CFG.sizes.upper, total)
    mix = FragmentMixDistribution(CFG.sizes.lower, CFG.sizes.upper, CFG.mixture).fit(fs)
    np.testing.assert_array_equal(mix.log_mix_table(CFG.occ), mix_full.log_mix_table(CFG.occ))


def test_sharded_size_histogram_equals_bincount(rng):
    from nucleoatac_torch.parallel.mesh import sharded_size_histogram

    sizes = rng.integers(0, 300, size=(4, 500))
    valid = rng.random((4, 500)) < 0.9
    got = sharded_size_histogram(torch.from_numpy(sizes), torch.from_numpy(valid), 0, 251)
    keep = valid & (sizes < 251)
    np.testing.assert_array_equal(got.numpy(), np.bincount(sizes[keep], minlength=251))
    assert got.dtype == torch.int64


def test_init_distributed_without_launcher_env_is_one_host(monkeypatch):
    import torch.distributed as dist

    from nucleoatac_torch.parallel.distributed import group_size, init_distributed

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized() and group_size() == 1


def test_local_device_takes_local_rank_and_refuses_a_missing_card(monkeypatch):
    from nucleoatac_torch.parallel import mesh

    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="LOCAL_RANK=3 but this machine has 2"):
        mesh.local_device("cuda")


def test_local_device_cuda_without_card_raises(monkeypatch):
    from nucleoatac_torch.parallel import mesh

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.local_device("cuda")


# ---------------- the command line -----------------------------------------
def _cli_base(ex, prefix):
    return ["run", "--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
            "--out", prefix, "--batch", "4", "--device", "cpu", "--no_plots"]


@pytest.fixture(scope="module")
def cli_single(ex, tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("torch_dist_cli") / "single")
    assert torch_nucleoatac(_cli_base(ex, prefix)) == 0
    return prefix


def test_cli_hosts_then_finalize_equal_single_run(ex, cli_single, tmp_path):
    prefix = str(tmp_path / "multi")
    for k in ("0", "1"):
        assert torch_nucleoatac([*_cli_base(ex, prefix), "--num_hosts", "2",
                                 "--host_id", k]) == 0
    assert os.path.exists(prefix + ".part1.manifest.json")
    assert not os.path.exists(prefix + ".nfrpos.bed.gz")
    assert torch_nucleoatac([*_cli_base(ex, prefix), "--num_hosts", "2", "--finalize"]) == 0
    for sfx in RUN_SUFFIXES:
        assert _text(prefix + sfx) == _text(cli_single + sfx), sfx


def test_cli_profile_writes_a_trace(ex, tmp_path):
    trace_dir = tmp_path / "trace"
    prefix = str(tmp_path / "prof")
    assert torch_nucleoatac([*_cli_base(ex, prefix), "--profile", str(trace_dir)]) == 0
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(trace_dir / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert os.path.exists(prefix + ".nfrpos.bed.gz")


# ---------------- two gloo processes -----------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(code: str, tmp_path, args=()):
    """Run ``code`` as ranks 0 and 1 of a gloo group (torchrun's
    environment), jax blocked; every rank must exit 0 within 240 s."""
    script = tmp_path / "worker.py"
    script.write_text("import sys\nsys.modules['jax'] = None\n" + textwrap.dedent(code))
    port = str(_free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
        env.pop("LOCAL_RANK", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *args], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


FIT_WORKER = """
import os
import numpy as np
import torch
import torch.distributed as dist
from nucleoatac_tpu.config import RunConfig
from nucleoatac_tpu.core.chunk import Chunk, ChunkList
from nucleoatac_tpu.io.bam import BamFragments
from nucleoatac_torch.models.distributed_pipeline import fit_mixture_distributed
from nucleoatac_torch.models.occ import fit_mixture
from nucleoatac_torch.parallel.distributed import init_distributed
from nucleoatac_torch.parallel.mesh import sharded_size_histogram

pid, n = init_distributed()
assert (n, dist.get_world_size()) == (2, 2) and dist.get_backend() == "gloo"
rng = np.random.default_rng(7)
m = 5000
mids = np.sort(rng.integers(0, 20000, size=m)).astype(np.int32)
sizes = np.clip(np.concatenate([rng.normal(147, 20, m // 2),
                                rng.exponential(45, m - m // 2) + 20]), 20, 250).astype(np.int32)
frags = BamFragments(["chr1"], [20000], {"chr1": mids}, {"chr1": sizes})
chunks = ChunkList([Chunk("chr1", i * 2500, i * 2500 + 2000) for i in range(8)])
cfg = RunConfig()
fs, mix = fit_mixture_distributed(frags, chunks, cfg, pid, 2)
fs1, mix1 = fit_mixture(frags, chunks, cfg)
assert np.array_equal(np.asarray(fs.vals), np.asarray(fs1.vals)), "histogram"
mix.save(f"dist{pid}.txt")
mix1.save(f"single{pid}.txt")
assert open(f"dist{pid}.txt").read() == open(f"single{pid}.txt").read(), "fit"
# each rank bins its half; the all_reduce gives the whole histogram
half = np.array_split(sizes.reshape(1, -1), 2, axis=1)
got = sharded_size_histogram(torch.from_numpy(half[pid]),
                             torch.ones(half[pid].shape, dtype=torch.bool), 0, 251)
assert np.array_equal(got.numpy(), np.bincount(sizes, minlength=251)), "bincount"
dist.destroy_process_group()
assert sys.modules["jax"] is None
print(f"rank {pid} OK", flush=True)
"""


def test_two_gloo_processes_share_the_size_histogram(tmp_path):
    outs = _run_ranks(FIT_WORKER, tmp_path)
    assert "rank 0 OK" in outs[0] and "rank 1 OK" in outs[1]


RUN_WORKER = """
import torch.distributed as dist
from nucleoatac_torch.cli.nucleoatac import main
rc = main(sys.argv[1:])
assert rc == 0 and not dist.is_initialized()
assert sys.modules["jax"] is None
print("rank", __import__("os").environ["RANK"], "OK", flush=True)
"""


def test_two_gloo_ranks_run_and_rank0_finalizes(ex, cli_single, tmp_path):
    """torchrun's form: `run --num_hosts 2` in two processes, the rank
    from RANK; rank 0 finalizes after the barrier; the merged files equal
    the single-host run's."""
    prefix = str(tmp_path / "ranks")
    outs = _run_ranks(RUN_WORKER, tmp_path, [*_cli_base(ex, prefix), "--num_hosts", "2"])
    assert "rank 0 OK" in outs[0] and "rank 1 OK" in outs[1]
    for sfx in RUN_SUFFIXES:
        assert _text(prefix + sfx) == _text(cli_single + sfx), sfx
    np.testing.assert_array_equal(np.loadtxt(prefix + ".nuc_dist.txt"),
                                  np.loadtxt(cli_single + ".nuc_dist.txt"))
    assert not [f for f in os.listdir(tmp_path) if ".part" in f]


# ---------------- the device guard of the kernel wrappers -------------------
@pytest.mark.cuda
def test_nuc_scores_on_a_second_card_while_the_first_is_current(rng):
    """K2 on cuda:1 while cuda:0 is current launches on cuda:1's stream
    and matches its plain version there."""
    from nucleoatac_tpu.config import NucParams
    from nucleoatac_tpu.core.vmat import VMat
    from nucleoatac_torch.ops import nuc_scores as k2
    from nucleoatac_torch.ops.xcorr import build_kernels_diag

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    B, W = 2, 512
    fmat = torch.from_numpy(rng.poisson(0.05, size=(B, 146, W)).astype(np.float32)).to(dev)
    b0 = torch.from_numpy(rng.random((B, 146, W)).astype(np.float32) / 146).to(dev)
    tabs = [torch.from_numpy(t).to(dev) for t in build_kernels_diag(VMat.default().mat, NucParams().v_floor)]
    got = k2.nuc_scores(fmat, b0, *tabs, 1e-12)
    torch.cuda.synchronize(dev)
    assert got.device == dev and torch.cuda.current_device() == 0
    want = k2.nuc_scores_plain(fmat, b0, *tabs, 1e-12)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
