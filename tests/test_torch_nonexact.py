"""Non-exact mode (occ.exact = nuc.exact = False) of nucleoatac_torch
against the JAX package on its CPU backend, from the same seeded inputs:
the wire-v2 occ bytes, the batched gaussian smooth, the engine's [B, 5, W]
score tracks on both xcorr routes, and whole runs held to
parity.compare_runs_nonexact."""
import dataclasses
import gzip

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nucleoatac_tpu import mirror
from nucleoatac_tpu.config import RunConfig, WindowParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.io.fasta import FastaFile
from nucleoatac_tpu.models.data import make_delta12_batches, pack_nibble_codes, tile_chunks
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.ops import occupancy as jocc
from nucleoatac_tpu.ops import smooth as jsmooth
from nucleoatac_torch.models import engine as tengine_mod
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import SeqCodesProvider
from nucleoatac_torch.ops import occupancy as tocc
from nucleoatac_torch.ops import smooth as tsmooth
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NONEXACT_STAT_TOL,
    NUCPOS_SUFFIXES,
    RUN_SUFFIXES,
    compare_runs_nonexact,
    read_rows,
)
from synth import make_example

T = torch.from_numpy
SMALL = RunConfig(window=WindowParams(core=256, batch=4))
CFG = dataclasses.replace(
    SMALL,
    occ=dataclasses.replace(SMALL.occ, exact=False),
    nuc=dataclasses.replace(SMALL.nuc, exact=False),
)
TOL = CFG.nuc.exact_tol
ROUTES = ("diag", "diag_pallas")
# the JAX package's score bars against its float64 mirror
# (tests/test_ops_vs_mirror.py), by [B, 5, W] channel
STAT_TOL = {2: NONEXACT_STAT_TOL[9], 3: NONEXACT_STAT_TOL[7], 4: NONEXACT_STAT_TOL[10]}
# max |value| each channel must reach for its comparison to mean something
# (signal is a template-weighted count: ~0.2 at a synthetic dyad)
NONVACUOUS = np.array([1.0, 1.0, 0.1, 1.0, 1.0])


def _with_conv(cfg, conv):
    return dataclasses.replace(cfg, window=dataclasses.replace(cfg.window, conv=conv))


# ---------------- wire v2 occ bytes ---------------------------------------
def _occ_inputs(rng, B=3, W=512, n=300):
    from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
    from nucleoatac_tpu.core.mixture import FragmentMixDistribution

    cfg = RunConfig()
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (2e4 * np.exp(-s / 45.0)
              + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    log_mix = np.asarray(mix.log_mix_table(cfg.occ), np.float32)
    mat = np.stack([
        mirror.rasterize(rng.integers(0, W, n), rng.integers(20, 250, n), 0, 251, W)
        for _ in range(B)
    ]).astype(np.float32)
    return cfg, mat, log_mix


@pytest.mark.parametrize("n", [40, 300])
def test_occupancy_packed3_equal_where_both_certify(rng, n):
    """Every byte equal wherever both sides set the certified bit (most
    positions); the rest are near-ties the port's f64 window sum may
    break otherwise than JAX's f32 sum."""
    cfg, mat, log_mix = _occ_inputs(rng, n=n)
    p, lo, core = cfg.occ, 64, 384
    args = (p.flank, lo, core, p.ci_drop, p.exact_tol)
    want = np.asarray(jocc.occupancy_packed3(jnp.asarray(mat), jnp.asarray(log_mix), *args))
    got = tocc.occupancy_packed3(T(mat), T(log_mix), *args).numpy()
    assert got.shape == want.shape == (3, 3, core) and got.dtype == np.uint8
    both = (got[:, 0] >> 7).astype(bool) & (want[:, 0] >> 7).astype(bool)
    assert both.mean() > 0.5
    for c in range(3):
        np.testing.assert_array_equal(got[:, c][both], want[:, c][both])


def test_occupancy_packed3_empty_windows_and_grid_guard(rng):
    """An empty window is certified and reads 0/0/G-1, as in the
    reference; a grid over 128 points does not fit the 7-bit index."""
    cfg, mat, log_mix = _occ_inputs(rng, B=1)
    G = log_mix.shape[1]
    mat[:] = 0.0
    got = tocc.occupancy_packed3(T(mat), T(log_mix), cfg.occ.flank, 64, 128).numpy()
    assert (got[0, 0] == 128).all() and (got[0, 1] == 0).all()
    assert (got[0, 2] == G - 1).all()
    with pytest.raises(ValueError, match="128"):
        tocc.occupancy_packed3(T(mat), torch.zeros(251, 129), cfg.occ.flank, 64, 128)


# ---------------- smoothing ------------------------------------------------
def test_gauss_smooth_batch_matches_jax_and_mirror(rng):
    x = rng.normal(0, 1, size=(3, 512)).astype(np.float32)
    for sd in (10.0, 25.0):
        k = tsmooth.gauss_kernel(sd)
        got = tsmooth.gauss_smooth_batch(T(x), T(k)).numpy()
        want = np.asarray(jsmooth.gauss_smooth_batch(jnp.asarray(x), jnp.asarray(k)))
        assert got.shape == x.shape
        assert np.abs(got - want).max() <= 1e-6
        for b in range(3):
            np.testing.assert_allclose(got[b], mirror.gauss_smooth(x[b], sd),
                                       rtol=1e-4, atol=1e-5)


# ---------------- the engine's non-exact entry points ---------------------
@pytest.fixture(scope="module")
def example(tmp_path_factory):
    ex = make_example(tmp_path_factory.mktemp("nonexact_example"))
    frags = scan_bam(ex["bam"], CFG.ingest)
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    from nucleoatac_torch.models.occ import fit_mixture

    fs, mix = fit_mixture(frags, chunks, CFG)
    tiles = tile_chunks(chunks, CFG.window, CFG.occ, CFG.vmat)
    jeng = DeviceEngine(CFG, mix, fs, pwm=PWM.default())
    d12 = list(make_delta12_batches(frags, tiles, jeng.width, CFG.window.batch))
    seq = SeqCodesProvider(FastaFile(ex["fasta"]), chunks, jeng, CFG.window.batch)
    nibs = [pack_nibble_codes(seq.rows(b.meta)) for b in d12]
    return ex, fs, mix, jeng, d12, nibs


def _engine(example, conv, pwm=True):
    _, fs, mix, _, _, _ = example
    return TorchEngine(_with_conv(CFG, conv), mix, fs, pwm=PWM.default() if pwm else None,
                       device="cpu")


def _check_nuc5(got, want):
    """norm and norm_smooth within nuc.exact_tol; signal, lr and fuzz at
    the JAX package's bars. Returns the max |want| per channel."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got[:, :2] - want[:, :2]).max() <= TOL
    for c, (rtol, atol) in STAT_TOL.items():
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=rtol, atol=atol)
    return np.abs(want).max(axis=(0, 2))


@pytest.mark.parametrize("conv", ROUTES)
def test_nuc_step_delta12_seq_c_matches_device_engine(example, conv):
    _, _, _, jeng, d12, nibs = example
    teng = _engine(example, conv)
    seen = np.zeros(5)
    for b, nib in zip(d12, nibs):
        want = np.asarray(jeng.nuc_step_delta12_seq_c(jnp.asarray(b.buf), jnp.asarray(nib)))
        got = teng.nuc_step_delta12_seq_c(T(b.buf), T(nib)).numpy()
        seen = np.maximum(seen, _check_nuc5(got, want))
    assert (seen > NONVACUOUS).all()
    assert teng.steps == len(d12)


@pytest.mark.parametrize("conv", ROUTES)
def test_nuc_step_delta12_c_matches_device_engine(example, conv):
    """The uploaded-log-bias form (engines without a PWM)."""
    _, fs, mix, _, d12, _ = example
    jeng = DeviceEngine(CFG, mix, fs, pwm=None)
    teng = _engine(example, conv, pwm=False)
    rng = np.random.default_rng(11)
    seen = np.zeros(5)
    for b in d12:
        logb = rng.normal(0, 0.3, size=(CFG.window.batch, jeng.width)).astype(np.float32)
        want = np.asarray(jeng.nuc_step_delta12_c(jnp.asarray(b.buf), jnp.asarray(logb)))
        got = teng.nuc_step_delta12_c(T(b.buf), T(logb)).numpy()
        seen = np.maximum(seen, _check_nuc5(got, want))
    assert (seen > NONVACUOUS).all()


def test_nuc5_routes_agree_and_zero_at_edges(example):
    """K2's reordered channels and the K1 route's epilogue give the same
    tracks; norm is 0 wherever the footprint is cut off by the window
    edge (n == 0), before the smooth."""
    _, _, _, _, d12, nibs = example
    a, b = _engine(example, "diag"), _engine(example, "diag_pallas")
    half = a.tables["_diag_kernels"][0].shape[1] // 2
    for buf, nib in zip(d12, nibs):
        x = a.nuc_step_delta12_seq_c(T(buf.buf), T(nib)).numpy()
        y = b.nuc_step_delta12_seq_c(T(buf.buf), T(nib)).numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)
        assert (x[:, 0, :half] == 0).all() and (x[:, 0, -half:] == 0).all()


@pytest.mark.parametrize("conv,k1_calls,k2_calls", [("diag", 0, 1), ("diag_pallas", 1, 0)])
def test_nuc5_route_follows_config(example, monkeypatch, conv, k1_calls, k2_calls):
    """One K2 call per batch on "diag"; one nuc_conv_outputs call (two K1
    stacks) on "diag_pallas"; each batch counts one engine step."""
    _, _, _, _, d12, nibs = example
    eng = _engine(example, conv)
    calls = {"k1": 0, "k2": 0}
    real_k1, real_k2 = tengine_mod.nuc_conv_outputs, tengine_mod.nuc_scores

    def k1(*a):
        calls["k1"] += 1
        return real_k1(*a)

    def k2(*a):
        calls["k2"] += 1
        return real_k2(*a)

    monkeypatch.setattr(tengine_mod, "nuc_conv_outputs", k1)
    monkeypatch.setattr(tengine_mod, "nuc_scores", k2)
    for b, nib in zip(d12, nibs):
        eng.nuc_step_delta12_seq_c(T(b.buf), T(nib))
    assert calls == {"k1": k1_calls * len(d12), "k2": k2_calls * len(d12)}
    assert eng.steps == len(d12)


def test_occ_step_delta12_c3_matches_device_engine(example):
    _, _, _, jeng, d12, _ = example
    teng = _engine(example, "diag")
    for b in d12:
        want = np.asarray(jeng.occ_step_delta12_c3(jnp.asarray(b.buf)))
        got = teng.occ_step_delta12_c3(T(b.buf)).numpy()
        assert got.shape == want.shape == (CFG.window.batch, 3, CFG.window.core)
        both = (got[:, 0] >> 7).astype(bool) & (want[:, 0] >> 7).astype(bool)
        assert both.mean() > 0.9
        for c in range(3):
            np.testing.assert_array_equal(got[:, c][both], want[:, c][both])


# ---------------- whole runs ----------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's non-exact run and the port's on both routes."""
    from nucleoatac_tpu.models.pipeline import run_pipeline as run_jax
    from nucleoatac_torch.models.pipeline import run_pipeline as run_torch

    d = tmp_path_factory.mktemp("torch_nonexact")
    ex = make_example(d)
    kw = dict(fasta_path=ex["fasta"], write_plots=False)
    out = {k: str(d / k) for k in ("jax", *ROUTES)}
    run_jax(ex["bam"], ex["bed"], out["jax"], cfg=CFG, **kw)
    res = {conv: run_torch(ex["bam"], ex["bed"], out[conv], cfg=_with_conv(CFG, conv),
                           device="cpu", **kw)
           for conv in ROUTES}
    return out, res


@pytest.mark.parametrize("conv", ROUTES)
def test_nonexact_run_meets_the_bar_against_jax(runs, conv):
    out, res = runs
    stats = compare_runs_nonexact(out["jax"], out[conv], TOL)
    for sfx in RUN_SUFFIXES:
        if sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
            assert stats[sfx] > 0, sfx
    assert res[conv].occ_stage is not None and res[conv].nuc_stage.refinisher is None
    assert res[conv].engine.steps > 0


@pytest.mark.parametrize("suffix", RUN_SUFFIXES)
def test_nonexact_routes_print_the_same_positions(runs, suffix):
    out, _ = runs
    a, b = read_rows(out["diag"] + suffix), read_rows(out["diag_pallas"] + suffix)
    assert a and [r[:3] for r in a] == [r[:3] for r in b]


def test_nonexact_run_has_no_cert_column_and_recovers_dyads(runs):
    from synth import DYADS

    out, res = runs
    called = sorted(int(r[1]) for r in read_rows(out["diag"] + ".nucpos.bed.gz"))
    for dy in DYADS:
        assert min(abs(c - dy) for c in called) <= 15, (dy, called)
    with gzip.open(out["diag"] + ".occ.bedgraph.gz", "rt") as fh:
        assert all(len(ln.split("\t")) == 4 for ln in fh)


def test_compare_runs_nonexact_rejects_a_stat_past_its_bar(runs, tmp_path):
    """The bar bites: an lr moved by more than its atol + rtol fails, one
    moved within it passes."""
    import shutil

    from nucleoatac_tpu.io.tabix import TabixWriter

    out, _ = runs
    for shift, ok in ((0.01, True), (1.0, False)):
        dst = str(tmp_path / f"s{shift}")
        for sfx in RUN_SUFFIXES:
            shutil.copy(out["diag"] + sfx, dst + sfx)
        rows = read_rows(out["diag"] + ".nucpos.bed.gz")
        rows[0][7] = f"{float(rows[0][7]) + shift:.5g}"
        with TabixWriter(dst + ".nucpos.bed.gz") as w:
            for r in rows:
                w.add(r[0], int(r[1]), int(r[2]), "\t".join(r))
        if ok:
            compare_runs_nonexact(out["diag"], dst, TOL)
        else:
            with pytest.raises(AssertionError, match="column 7"):
                compare_runs_nonexact(out["diag"], dst, TOL)
