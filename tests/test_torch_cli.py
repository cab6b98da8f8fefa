"""`nucleoatac-torch` (device cpu) against the reference's `nucleoatac` CLI
(CPU backend) on the synthetic example: the staged occ/nuc/merge/nfr
commands, `run --resume` and `run --bias_track` meet the reference's
output bar (nucleoatac_torch/parity.py) and recover the planted truth;
vprocess round-trips; the flags map onto the config, every --transfer and
--conv value of the reference included; the reference's flags that have no
meaning here (--platform, --fetch-threads, --device tpu) exit nonzero."""
import gzip
import os

import numpy as np
import pytest
import torch

from nucleoatac_tpu.cli.nucleoatac import main as jax_nucleoatac
from nucleoatac_tpu.cli.pyatac import main as jax_pyatac
from nucleoatac_torch.cli.nucleoatac import build_config, nucleoatac_parser
from nucleoatac_torch.cli.nucleoatac import main as torch_nucleoatac
from nucleoatac_torch.cli.pyatac import main as torch_pyatac
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NUCPOS_SUFFIXES,
    SIGNAL_SUFFIXES,
    compare_runs,
    read_rows,
)
from synth import DYADS, NFR_GAP, make_example

EXACT_TOL = 8e-4  # NucParams().exact_tol, the CLI default


def _staged(main, ex, out, device_args):
    base = ["--bed", ex["bed"], "--bam", ex["bam"], "--out", out, "--batch", "4",
            "--no_plots", *device_args]
    fa = ["--fasta", ex["fasta"]]
    assert main(["occ", *base]) == 0
    assert main(["nuc", *base, *fa]) == 0
    assert main(["merge", "--occpeaks", out + ".occpeaks.bed.gz",
                 "--nucpos", out + ".nucpos.bed.gz", "--out", out]) == 0
    assert main(["nfr", *base, *fa]) == 0


def _runs(nucleoatac, pyatac, ex, d, device_args):
    """run, run --resume (into a copy of the run's occ files), pyatac bias,
    run --bias_track; returns the output prefixes."""
    common = ["--bed", ex["bed"], "--bam", ex["bam"], "--batch", "4",
              "--no_plots", "--fasta", ex["fasta"], *device_args]
    out = {k: str(d / k) for k in ("run", "resume", "bias", "via")}
    assert nucleoatac(["run", *common, "--out", out["run"]]) == 0
    for sfx in (".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
                ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
                ".fragmentsizes.txt", ".occ_fit.txt"):
        for ext in ("", ".tbi") if sfx.endswith(".gz") else ("",):
            with open(out["run"] + sfx + ext, "rb") as a, open(out["resume"] + sfx + ext, "wb") as b:
                b.write(a.read())
    assert nucleoatac(["run", *common, "--out", out["resume"], "--resume"]) == 0
    assert pyatac(["bias", "--fasta", ex["fasta"], "--bed", ex["bed"],
                   "--out", out["bias"]]) == 0
    assert nucleoatac(["run", *common, "--out", out["via"],
                       "--bias_track", out["bias"] + ".Scores.bedgraph.gz"]) == 0
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    ex = make_example(d)
    prefixes = {}
    for name, nm, pm, dev in (
        ("jax", jax_nucleoatac, jax_pyatac, []),
        ("torch", torch_nucleoatac, torch_pyatac, ["--device", "cpu"]),
    ):
        sub = d / name
        sub.mkdir()
        _staged(nm, ex, str(sub / "st"), dev)
        prefixes[name] = {"staged": str(sub / "st"), **_runs(nm, pm, ex, sub, dev)}
    return prefixes


ALL_SUFFIXES = EXACT_SUFFIXES + NUCPOS_SUFFIXES + SIGNAL_SUFFIXES


@pytest.mark.parametrize("kind", ["staged", "run", "resume", "via"])
def test_cli_runs_meet_reference_bar(cli_runs, kind):
    """Six files row-equal, nucpos rows equal but for column 8, signal
    tracks within nuc.exact_tol of the reference's."""
    stats = compare_runs(cli_runs["jax"][kind], cli_runs["torch"][kind], EXACT_TOL)
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        assert stats[sfx] > 0, sfx
    for sfx in SIGNAL_SUFFIXES:
        assert stats[sfx + " max_abs_diff"] <= EXACT_TOL


def test_staged_recovers_planted_dyads_and_nfr(cli_runs):
    out = cli_runs["torch"]["staged"]
    calls = read_rows(out + ".nucpos.bed.gz")
    called = sorted(int(c[1]) for c in calls)
    for dy in DYADS:
        assert min(abs(c - dy) for c in called) <= 15, (dy, called)
    # occ stats re-read from the occ stage's files (file handoff)
    assert any(float(c[4]) > 0.5 for c in calls)
    nfrs = read_rows(out + ".nfrpos.bed.gz")
    assert any(int(f[1]) < NFR_GAP[1] and int(f[2]) > NFR_GAP[0] for f in nfrs)


@pytest.mark.parametrize("suffix", ALL_SUFFIXES)
def test_staged_equals_run_row_for_row(cli_runs, suffix):
    """The staged commands print exactly what the fused run prints."""
    t = cli_runs["torch"]
    assert read_rows(t["staged"] + suffix) == read_rows(t["run"] + suffix)


@pytest.mark.parametrize("suffix", [".nucpos.bed.gz", ".nfrpos.bed.gz"])
def test_resume_reproduces_run(cli_runs, suffix):
    t = cli_runs["torch"]
    with gzip.open(t["run"] + suffix) as a, gzip.open(t["resume"] + suffix) as b:
        assert a.read() == b.read()


def test_bias_track_matches_fasta_pwm(cli_runs):
    """--bias_track reproduces the FASTA+PWM run: same dyads, bias stats
    within the bedgraph's 5-decimal bias quantization, occ byte-identical."""
    t = cli_runs["torch"]
    a = read_rows(t["run"] + ".nucpos.bed.gz")
    b = read_rows(t["via"] + ".nucpos.bed.gz")
    assert a and [r[1] for r in a] == [r[1] for r in b]
    for ra, rb in zip(a, b):
        for j in (3, 7, 9):  # z, lr, signal: bias-dependent stats
            np.testing.assert_allclose(float(ra[j]), float(rb[j]), rtol=1e-3, atol=1e-3)
    with gzip.open(t["run"] + ".occ.bedgraph.gz") as x, gzip.open(t["via"] + ".occ.bedgraph.gz") as y:
        assert x.read() == y.read()


def test_vprocess_roundtrip_matches_reference(tmp_path):
    from nucleoatac_torch.core.vmat import VMat

    ex = make_example(tmp_path)
    mats = {}
    for name, nm, pm in (("jax", jax_nucleoatac, jax_pyatac),
                         ("torch", torch_nucleoatac, torch_pyatac)):
        out = str(tmp_path / name)
        assert pm(["vplot", "--bam", ex["bam"], "--bed", ex["bed"], "--out", out,
                   "--no_plots"]) == 0
        assert nm(["vprocess", "--vplot", out + ".VMat", "--out", out,
                   "--no_plots"]) == 0
        mats[name] = open(out + ".VMat").read()
    assert mats["torch"] == mats["jax"]
    v = VMat.open(str(tmp_path / "torch") + ".VMat")
    assert v.width == 147 and v.lower == 105
    assert abs(v.mat.sum() - 1.0) < 1e-9
    np.testing.assert_allclose(v.mat, v.mat[:, ::-1], atol=1e-12)


BASE = ["--bam", "x.bam", "--bed", "x.bed", "--out", "o"]


@pytest.mark.parametrize("cmd", ["run", "occ", "nuc", "nfr"])
def test_build_config_maps_device_conv_transfer(cmd):
    args = nucleoatac_parser().parse_args(
        [cmd, *BASE, "--device", "cpu", "--conv", "diag_pallas",
         "--transfer", "delta12", "--batch", "8", "--strict"])
    cfg = build_config(args)
    assert args.device == "cpu"
    assert cfg.window.conv == "diag_pallas"
    assert cfg.window.transfer == "delta12"
    assert cfg.window.batch == 8 and cfg.nuc.strict is True
    dflt = build_config(nucleoatac_parser().parse_args([cmd, *BASE]))
    assert nucleoatac_parser().parse_args([cmd, *BASE]).device == "cuda"
    assert (dflt.window.conv, dflt.window.transfer) == ("diag", "pool")


@pytest.mark.parametrize("flag", [
    ["--device", "tpu"], ["--platform", "cpu"], ["--fetch-threads", "2"],
])
def test_cli_rejects_unported_choices(flag):
    with pytest.raises(SystemExit) as e:
        nucleoatac_parser().parse_args(["run", *BASE, *flag])
    assert e.value.code == 2


@pytest.mark.parametrize("flag", [
    ["--transfer", w] for w in ("pool", "delta12", "delta", "packed", "frags", "dense")
] + [["--conv", c] for c in ("diag", "diag_pallas", "direct")])
def test_cli_takes_every_reference_choice(flag):
    """Every --transfer and --conv value of `nucleoatac` parses and reaches
    the config."""
    cfg = build_config(nucleoatac_parser().parse_args(["run", *BASE, *flag]))
    field = "transfer" if flag[0] == "--transfer" else "conv"
    assert getattr(cfg.window, field) == flag[1]


def test_upper_above_255_falls_back_to_packed(capsys):
    """The reference's behaviour: a warning, then the packed wire."""
    cfg = build_config(nucleoatac_parser().parse_args(["run", *BASE, "--upper", "300"]))
    assert (cfg.window.transfer, cfg.sizes.upper) == ("packed", 300)
    assert "falling back to 'packed'" in capsys.readouterr().err


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda is valid here")
    ex = make_example(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_nucleoatac(["occ", "--bed", ex["bed"], "--bam", ex["bam"],
                          "--out", str(tmp_path / "o"), "--no_plots"])
    assert not os.path.exists(str(tmp_path / "o") + ".occ.bedgraph.gz")
