"""`pyatac-torch` against the reference's `pyatac` on the synthetic example:
every subcommand writes the same files; the device V-plot aggregate equals
the host loop exactly."""
import gzip

import numpy as np
import pytest
import torch

from nucleoatac_tpu import pyatac as JP
from nucleoatac_tpu.cli.pyatac import main as jax_pyatac
from nucleoatac_tpu.core.chunk import Chunk, ChunkList
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.io.fasta import FastaFile
from nucleoatac_torch import pyatac as TP
from nucleoatac_torch.cli.pyatac import main as torch_pyatac
from synth import DYADS, make_example


@pytest.fixture(scope="module")
def ex(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pyatac")
    ex = make_example(d)
    sites = str(d / "sites.bed")
    with open(sites, "w") as fh:
        for i, dy in enumerate(DYADS):
            fh.write(f"chr1\t{dy}\t{dy + 1}\tsite\t0\t{'+-'[i % 2]}\n")
    # an occ track for `signal` (the reference's occ stage output)
    from nucleoatac_tpu.cli.nucleoatac import main as jax_nucleoatac

    occ = str(d / "occ")
    assert jax_nucleoatac(["occ", "--bed", ex["bed"], "--bam", ex["bam"],
                           "--out", occ, "--batch", "4", "--no_plots"]) == 0
    return {**ex, "sites": sites, "bg": occ + ".occ.bedgraph.gz"}


def _args(ex, out):
    bam = ["--bam", ex["bam"], "--bed", ex["bed"], "--out", out, "--no_plots"]
    return {
        "bias": (["bias", "--fasta", ex["fasta"], "--bed", ex["bed"], "--out", out],
                 [".Scores.bedgraph.gz"]),
        "vplot": (["vplot", *bam], [".VMat"]),
        "bias_vplot": (["bias_vplot", *bam, "--fasta", ex["fasta"]], [".Bias.VMat"]),
        "ins": (["ins", *bam], [".ins.bedgraph.gz"]),
        "cov": (["cov", *bam], [".cov.bedgraph.gz"]),
        "sizes": (["sizes", "--bam", ex["bam"], "--out", out, "--no_plots"],
                  [".fragmentsizes.txt"]),
        "counts": (["counts", *bam], [".counts.txt"]),
        "pwm": (["pwm", "--bam", ex["bam"], "--fasta", ex["fasta"], "--out", out,
                 "--no_plots"], [".PWM.txt"]),
        "signal": (["signal", "--bed", ex["sites"], "--bg", ex["bg"], "--out", out,
                    "--up", "100", "--down", "100", "--all", "--norm"],
                   [".signal.agg.txt", ".signal.txt"]),
        "nucleotide": (["nucleotide", "--bed", ex["sites"], "--fasta", ex["fasta"],
                        "--out", out, "--up", "20", "--down", "20"],
                       [".nucfreq.txt"]),
    }


def _content(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("cmd", [
    "bias", "vplot", "bias_vplot", "ins", "cov", "sizes", "counts", "pwm",
    "signal", "nucleotide",
])
def test_subcommand_output_equals_reference(ex, tmp_path, cmd):
    outs = {}
    for name, main in (("jax", jax_pyatac), ("torch", torch_pyatac)):
        argv, sfxs = _args(ex, str(tmp_path / name))[cmd]
        assert main(argv) == 0
        outs[name] = [_content(str(tmp_path / name) + s) for s in sfxs]
    assert all(len(c) > 0 for c in outs["jax"])
    assert outs["torch"] == outs["jax"]


@pytest.fixture(scope="module")
def frags_feats(ex):
    frags = scan_bam(ex["bam"])
    feats = ChunkList([
        Chunk("chr1", 950, 1050, strand="+"),
        Chunk("chr1", 1150, 1250, strand="-"),
        Chunk("chr1", 1450, 1550, strand="-"),
        Chunk("chr1", 2550, 2650, strand="+"),
    ])
    return frags, feats


def test_vplot_device_on_cpu_equals_host(frags_feats):
    """Integer counts: the batched device aggregate (with '-' strand flips,
    two batches) equals the host loop and the reference's device path."""
    frags, feats = frags_feats
    host = JP.aggregate_vplot(frags, feats)
    got = TP.aggregate_vplot_device(frags, feats, batch=3, device="cpu")
    assert host.sum() > 100
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, JP.aggregate_vplot_device(frags, feats, batch=3))


def test_bias_vplot_equals_reference(ex, frags_feats):
    frags, feats = frags_feats
    fasta, pwm = FastaFile(ex["fasta"]), PWM.default()
    fs = JP.sizes_histogram(frags, None, 0, 251)
    np.testing.assert_array_equal(
        TP.bias_vplot(frags, fasta, pwm, feats, fs),
        JP.bias_vplot(frags, fasta, pwm, feats, fs),
    )


def test_vplot_device_flag_needs_a_card(ex, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: vplot --device runs there")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        torch_pyatac(["vplot", "--bam", ex["bam"], "--bed", ex["bed"],
                      "--out", str(tmp_path / "v"), "--no_plots", "--device"])
