"""Whole runs of the port on every wire and xcorr route the reference's
command line offers, against the JAX package's runs with the same
settings (CPU backend): `run_pipeline` with each of the six transfers and
with conv="direct" meets parity.compare_runs; the six wires print the
same rows; only pool takes the fused pass; `run --upper 300` falls back to
the packed wire with the reference's warning; the standalone stages and a
two-host run with --finalize print the single-host rows on that wire."""
import dataclasses

import numpy as np
import pytest

from nucleoatac_tpu.cli.nucleoatac import main as jax_nucleoatac
from nucleoatac_tpu.config import RunConfig, WindowParams
from nucleoatac_torch.cli.nucleoatac import main as torch_nucleoatac
from nucleoatac_torch.models import pipeline as tpipeline
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NUCPOS_SUFFIXES,
    RUN_SUFFIXES,
    SIGNAL_SUFFIXES,
    compare_runs,
    port_config,
    read_rows,
)
from nucleoatac_torch.synthetic import make_long_example
from synth import make_example

CFG = RunConfig(window=WindowParams(core=256, batch=4))
TOL = CFG.nuc.exact_tol
WIRES = ("pool", "delta12", "delta", "packed", "frags", "dense")
# the wires that carry the fragment size in one byte
UINT8_WIRES = ("pool", "delta12", "delta")
# the wires whose nuc stage scores the PWM on the device from sequence
# codes; frags and dense upload the host's f32 log-bias rows, as in the
# reference, so their signal tracks may differ by a u16 step
DEVICE_PWM = ("pool", "delta12", "delta", "packed")
RUNS = WIRES + ("direct",)


def _cfg(kind):
    wire, conv = (kind, "diag") if kind in WIRES else ("pool", kind)
    return dataclasses.replace(
        CFG, window=dataclasses.replace(CFG.window, transfer=wire, conv=conv))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's and the port's run_pipeline per kind, and which
    kinds the port ran through the fused pass."""
    from nucleoatac_tpu.models.pipeline import run_pipeline as run_jax

    d = tmp_path_factory.mktemp("torch_wires")
    ex = make_example(d)
    kw = dict(fasta_path=ex["fasta"], write_plots=False)
    fused, real = [], tpipeline.run_fused

    def spy(cfg, *a, **k):
        fused.append(cfg.window.transfer)
        return real(cfg, *a, **k)

    out, res = {}, {}
    tpipeline.run_fused = spy
    try:
        for kind in RUNS:
            out[kind] = {p: str(d / f"{p}_{kind}") for p in ("jax", "torch")}
            run_jax(ex["bam"], ex["bed"], out[kind]["jax"], cfg=_cfg(kind), **kw)
            res[kind] = tpipeline.run_pipeline(
                ex["bam"], ex["bed"], out[kind]["torch"], cfg=port_config(_cfg(kind)),
                device="cpu", **kw)
    finally:
        tpipeline.run_fused = real
    return out, res, fused


@pytest.mark.parametrize("kind", RUNS)
def test_run_meets_reference_bar(runs, kind):
    """Eight files row-equal (nucpos but its column 8) to the reference's
    run with the same settings; signal tracks within nuc.exact_tol, plus
    one u16 step on the direct route (each package rounds its own
    convolution's norm to its own u16 level)."""
    out, res, _ = runs
    tol = TOL + (res[kind].nuc_stage.max_qstep if kind == "direct" else 0.0)
    stats = compare_runs(out[kind]["jax"], out[kind]["torch"], tol)
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        assert stats[sfx] > 0, sfx
    for sfx in SIGNAL_SUFFIXES:
        assert stats[sfx + " max_abs_diff"] <= tol


@pytest.mark.parametrize("suffix", RUN_SUFFIXES)
def test_six_wires_print_the_same_rows(runs, suffix):
    """Every wire prints the pool run's rows; the signal tracks are byte
    for byte the same within each bias source and within exact_tol plus a
    u16 step across them."""
    out, res, _ = runs
    want = read_rows(out["pool"]["torch"] + suffix)
    assert want
    for wire in WIRES:
        got = read_rows(out[wire]["torch"] + suffix)
        if suffix not in SIGNAL_SUFFIXES or wire in DEVICE_PWM:
            assert got == want, wire
    if suffix in SIGNAL_SUFFIXES:
        assert read_rows(out["frags"]["torch"] + suffix) == read_rows(
            out["dense"]["torch"] + suffix)
        step = max(res[w].nuc_stage.max_qstep for w in WIRES)
        compare_runs(out["pool"]["torch"], out["dense"]["torch"], TOL + step)


def test_fused_pass_takes_pool_only(runs):
    """pool runs the fused pass, every other wire the two passes; every
    run dispatches the same nuc batches."""
    _, res, fused = runs
    assert fused == ["pool", "pool"]  # the second: direct
    steps = {k: r.engine.steps for k, r in res.items()}
    assert len(set(steps.values())) == 1 and steps["pool"] > 0, steps
    for kind in RUNS:
        assert res[kind].occ_stage.n_spot_checked > 0, kind


# ---------------- --upper past 255 ---------------------------------------
@pytest.fixture(scope="module")
def upper_runs(tmp_path_factory):
    """`run --upper 300` through both command lines (the port on the CPU),
    the port's standalone occ/nuc/merge/nfr and its two-host run with
    --finalize on the same flags."""
    d = tmp_path_factory.mktemp("torch_upper")
    ex = make_long_example(str(d))
    common = ["--bed", ex["bed"], "--bam", ex["bam"], "--fasta", ex["fasta"],
              "--batch", "4", "--no_plots", "--upper", "300"]
    tdev = ["--device", "cpu"]
    out = {k: str(d / k) for k in ("jax", "torch", "staged", "hosts")}
    assert jax_nucleoatac(["run", *common, "--out", out["jax"]]) == 0
    assert torch_nucleoatac(["run", *common, *tdev, "--out", out["torch"]]) == 0
    st = [*common, *tdev, "--out", out["staged"], "--transfer", "packed"]
    assert torch_nucleoatac(["occ", *st]) == 0
    assert torch_nucleoatac(["nuc", *st]) == 0
    assert torch_nucleoatac(["merge", "--occpeaks", out["staged"] + ".occpeaks.bed.gz",
                             "--nucpos", out["staged"] + ".nucpos.bed.gz",
                             "--out", out["staged"]]) == 0
    assert torch_nucleoatac(["nfr", *st]) == 0
    hosts = ["run", *common, *tdev, "--out", out["hosts"], "--transfer", "packed",
             "--num_hosts", "2"]
    for k in ("0", "1"):
        assert torch_nucleoatac([*hosts, "--host_id", k]) == 0
    assert torch_nucleoatac([*hosts, "--finalize"]) == 0
    return out


def test_upper_above_255_warns_and_takes_packed(capsys):
    """Under pool, delta12 and delta, --upper 300 prints the reference's
    warning and falls back to the packed wire; the wires that carry the
    size (packed, frags, dense) keep their value."""
    from nucleoatac_torch.cli.nucleoatac import build_config, nucleoatac_parser

    base = ["--bam", "x", "--bed", "y", "--out", "z", "--upper", "300"]
    for wire in WIRES:
        cfg = build_config(nucleoatac_parser().parse_args(
            ["run", *base, "--transfer", wire]))
        err = capsys.readouterr().err
        want = "packed" if wire in UINT8_WIRES else wire
        assert (cfg.window.transfer, cfg.sizes.upper) == (want, 300)
        assert (f"WARNING: --upper 300 > 255 is incompatible with the '{wire}' "
                "wire format" in err) == (wire in UINT8_WIRES)


def test_upper_300_run_meets_reference_bar(upper_runs):
    stats = compare_runs(upper_runs["jax"], upper_runs["torch"], TOL)
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        assert stats[sfx] > 0, sfx
    for sfx in SIGNAL_SUFFIXES:
        assert stats[sfx + " max_abs_diff"] <= TOL


def test_upper_300_sizes_past_255_reach_the_fit(upper_runs):
    """The fitted size histogram holds the di-nucleosomal fragments: the
    run is not one that the 251 default would have given."""
    size, count = np.loadtxt(upper_runs["torch"] + ".fragmentsizes.txt").T
    assert len(size) == 300 and count[size > 255].sum() > 50


@pytest.mark.parametrize("kind", ["staged", "hosts"])
def test_upper_300_stages_and_hosts_print_the_run(upper_runs, kind):
    """occ/nuc/merge/nfr and two hosts + --finalize on the packed wire
    print the one-process run's rows in every file."""
    for sfx in RUN_SUFFIXES:
        want = read_rows(upper_runs["torch"] + sfx)
        assert want and read_rows(upper_runs[kind] + sfx) == want, sfx
