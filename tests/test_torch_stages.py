"""The port's standalone stages and two-pass path against the JAX package
(CPU backend): the delta12 wire, the engine's delta12 entry points, the
named step each two-pass stage dispatches per wire and mode, the xcorr
route switch (cfg.window.conv), and whole runs — two-pass equal to
fused row for row, and to the reference's run by parity.compare_runs."""
import dataclasses
import gzip

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nucleoatac_tpu.config import RunConfig, WindowParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.models.data import (
    delta12_entry_capacity,
    encode_delta12_batch,
    make_delta12_batches,
    make_pool_batches,
    pack_nibble_codes,
    tile_chunks,
)
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.models.occ import fit_mixture as jfit_mixture
from nucleoatac_tpu.ops import rasterize as jras
from nucleoatac_torch.core.chunk import ChunkList as TChunkList
from nucleoatac_torch.core.pwm import PWM as TPWM
from nucleoatac_torch.io.bam import scan_bam as tscan_bam
from nucleoatac_torch.io.fasta import FastaFile as TFastaFile
from nucleoatac_torch.models import engine as tengine_mod
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import SeqCodesProvider
from nucleoatac_torch.ops import rasterize as tras
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NONEXACT_STAT_TOL,
    NUCPOS_SUFFIXES,
    RUN_SUFFIXES,
    SIGNAL_SUFFIXES,
    compare_runs,
    port_config,
)
from synth import make_example

T = torch.from_numpy
CFG = RunConfig(window=WindowParams(core=256, batch=4))
TCFG = port_config(CFG)  # the port's own config, same fields


# ---------------- wire v6: delta12 records --------------------------------
def _delta12_buf(rng, B=3, W=768, F=300):
    """Seeded sorted windows (one empty row, one sparse) in the reference's
    wire-v6 encoding."""
    counts = np.array([F, 0, 12][:B], np.int64)
    mids = np.zeros((B, F), np.int64)
    sizes = np.zeros((B, F), np.int64)
    for b, n in enumerate(counts):
        mids[b, :n] = np.sort(rng.integers(0, W, n))
        sizes[b, :n] = rng.integers(1, 256, n)
    E = delta12_entry_capacity(F, W)
    buf = np.zeros((B, E // 2 + E), np.uint8)
    encode_delta12_batch(mids, sizes, buf, counts)
    return buf, E, W


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta12_unpack_and_raster_exactly_equal(seed):
    buf, E, W = _delta12_buf(np.random.default_rng(seed))
    want = [np.asarray(x) for x in jras.unpack_delta12_fragments(jnp.asarray(buf), E)]
    got = [x.numpy() for x in tras.unpack_delta12_fragments(T(buf), E)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want_r = np.asarray(jras.rasterize_delta12_batch(jnp.asarray(buf), E, 0, 251, W))
    got_r = tras.rasterize_delta12_batch(T(buf), E, 0, 251, W).numpy()
    assert want_r.sum() > 100
    np.testing.assert_array_equal(got_r, want_r)


def test_delta12_sparse_extreme_gaps():
    """Multi-hundred-bp gaps split into skip records decode exactly."""
    W = 1536
    mids = np.array([[0, 16, 31, 254, 255, 256, 1535]], np.int64)
    sizes = np.full((1, 7), 147, np.int64)
    E = delta12_entry_capacity(7, W)
    buf = np.zeros((1, E // 2 + E), np.uint8)
    encode_delta12_batch(mids, sizes, buf)
    m, s, v = (x.numpy() for x in tras.unpack_delta12_fragments(T(buf), E))
    np.testing.assert_array_equal(m[0][v[0]], mids[0])
    np.testing.assert_array_equal(s[0][v[0]], sizes[0])


# ---------------- engines on real windows ---------------------------------
@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """The synthetic example read and fitted by each package on its own:
    (ex, frags, chunks, tiles) from the JAX package, then the (fs, mix)
    of each package's fit_mixture and the port's chunks."""
    from nucleoatac_torch.models.occ import fit_mixture as tfit_mixture

    ex = make_example(tmp_path_factory.mktemp("stages_example"))
    frags = scan_bam(ex["bam"], CFG.ingest)
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    tfrags = tscan_bam(ex["bam"], TCFG.ingest)
    tchunks = TChunkList.read(ex["bed"], tfrags.chrom_dict).merge()
    tiles = tile_chunks(chunks, CFG.window, CFG.occ, CFG.vmat)
    fits = {"jax": jfit_mixture(frags, chunks, CFG),
            "torch": tfit_mixture(tfrags, tchunks, TCFG)}
    return ex, frags, chunks, fits, tchunks, tiles


@pytest.fixture(scope="module")
def engines(example):
    _, _, _, fits, _, _ = example
    return (DeviceEngine(CFG, fits["jax"][1], fits["jax"][0], pwm=PWM.default()),
            TorchEngine(TCFG, fits["torch"][1], fits["torch"][0], pwm=TPWM.default(),
                        device="cpu"))


@pytest.fixture(scope="module")
def batches(example, engines):
    ex, frags, _, _, tchunks, tiles = example
    jeng, teng = engines
    d12 = list(make_delta12_batches(frags, tiles, jeng.width, CFG.window.batch))
    pools = list(make_pool_batches(frags, tiles, jeng.width, CFG.window.batch))
    seq = SeqCodesProvider(TFastaFile(ex["fasta"]), tchunks, teng, TCFG.window.batch)
    nibs = [pack_nibble_codes(seq.rows(b.meta)) for b in d12]
    return d12, pools, nibs


def test_delta12_raster_equals_pool_raster(engines, batches):
    """The two wires give the same count matrices bit for bit, so the
    two-pass and the fused path feed identical inputs to the nuc chain."""
    _, teng = engines
    d12, pools, _ = batches
    assert len(d12) == len(pools) >= 2
    for a, b in zip(d12, pools):
        assert [t.win_start for t in a.meta] == [t.win_start for t in b.meta]
        ra = teng._raster_delta12(T(a.buf))
        rb = teng._raster_pool(T(b.pool), T(b.table), b.emax)
        assert ra.sum() > 0
        assert torch.equal(ra, rb)


def test_occ_step_delta12_p2_matches_device_engine(engines, batches):
    """Occ grid indices equal wherever both engines certify."""
    jeng, teng = engines
    for b in batches[0]:
        jraw = np.asarray(jeng.occ_step_delta12_p2(jnp.asarray(b.buf)))
        traw = teng.occ_step_delta12_p2(T(b.buf)).numpy()
        assert traw.shape == jraw.shape and traw.dtype == np.uint8
        jidx, jcert = jeng.decode_occ2(jraw)
        tidx, tcert = teng.decode_occ2(traw)
        both = jcert & tcert
        assert both.mean() > 0.5
        for c in range(3):
            np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])


def _decoded_close(jeng, teng, jbuf, tbuf):
    """Decoded u16 norms within exact_tol plus one quantization step (each
    side rounds its own f32 norm to its own nearest u16 level)."""
    jn, jq = jeng.f32_from_u16(jbuf)
    tn, tq = teng.f32_from_u16(tbuf)
    assert tbuf.shape == jbuf.shape
    step = np.maximum(jq, tq)[:, None]
    assert (np.abs(tn - jn) <= jeng.cfg.nuc.exact_tol + step).all()
    assert np.abs(jn).max() > 1.0  # non-vacuous


def test_nuc_step_delta12_seq_m16_matches_device_engine(engines, batches):
    jeng, teng = engines
    d12, _, nibs = batches
    for b, nib in zip(d12, nibs):
        jbuf = np.asarray(jeng.nuc_step_delta12_seq_m16(jnp.asarray(b.buf), jnp.asarray(nib)))
        tbuf = teng.nuc_step_delta12_seq_m16(T(b.buf), T(nib)).numpy()
        _decoded_close(jeng, teng, jbuf, tbuf)


@pytest.fixture(scope="module")
def bias_engines(example):
    """Engines as the --bias_track path builds them: no PWM."""
    _, _, _, fits, _, _ = example
    return (DeviceEngine(CFG, fits["jax"][1], fits["jax"][0], pwm=None),
            TorchEngine(TCFG, fits["torch"][1], fits["torch"][0], pwm=None, device="cpu"))


def test_nuc_step_delta12_m16_matches_device_engine(bias_engines, batches):
    jeng, teng = bias_engines
    rng = np.random.default_rng(7)
    for b in batches[0]:
        logb = rng.normal(0, 0.3, size=(CFG.window.batch, jeng.width)).astype(np.float32)
        jbuf = np.asarray(jeng.nuc_step_delta12_m16(jnp.asarray(b.buf), jnp.asarray(logb)))
        tbuf = teng.nuc_step_delta12_m16(T(b.buf), T(logb)).numpy()
        _decoded_close(jeng, teng, jbuf, tbuf)


def test_two_pass_and_fused_programs_give_equal_bytes(engines, batches):
    """Per batch: the standalone occ/nuc entry points give the bytes the
    fused run_step_pool packs (same rasters, same _nucm -> _u16)."""
    _, teng = engines
    d12, pools, nibs = batches
    n_occ = 2 * teng.core + (teng.core + 3) // 4
    for a, b, nib in zip(d12, pools, nibs):
        fused = teng.run_step_pool(T(b.pool), T(b.table), T(nib), b.emax)
        assert torch.equal(fused[:, :n_occ], teng.occ_step_delta12_p2(T(a.buf)))
        assert torch.equal(fused[:, n_occ:], teng.nuc_step_delta12_seq_m16(T(a.buf), T(nib)))


# ---------------- the two-pass stages' named steps -----------------------
def _frag_words(b):
    s = np.where(b.valid, b.sizes, 0).astype(np.int32)
    m = np.where(b.valid, b.mids, 0).astype(np.int32)
    return (s << 16) | m


# The reference stages' picks (nucleoatac_tpu/models/occ.py and nuc.py,
# OccStage.run and NucStage.run): wire -> (the occ step's stem, its
# arrays), (the nuc step's stem, its fragment arrays).
REF_OCC = {"delta12": ("occ_step_delta12", lambda b: (b.buf,)),
           "delta": ("occ_step_delta", lambda b: (b.delta,)),
           "packed": ("occ_step_packed", lambda b: (b.packed,)),
           "frags": ("occ_step_packed", lambda b: (_frag_words(b),)),
           "dense": ("occ_step", lambda b: (b.mats,))}
REF_NUC = {"delta12": ("nuc_step_delta12", lambda b: (b.buf,)),
           "delta": ("nuc_step_delta", lambda b: (b.delta,)),
           "packed": ("nuc_step_packed", lambda b: (b.packed,)),
           "frags": ("nuc_step_frags", lambda b: (b.mids, b.sizes, b.valid)),
           "dense": ("nuc_step_dense", lambda b: (b.mats,))}
# non-exact mode's score bars by [B, 5, W] channel (tests/test_torch_nonexact.py)
NONEXACT_TOL = {2: NONEXACT_STAT_TOL[9], 3: NONEXACT_STAT_TOL[7], 4: NONEXACT_STAT_TOL[10]}
STAGE_WIRES = tuple(REF_OCC)


@pytest.fixture(scope="module")
def port_tiles(example):
    """The port's own fragments and tiles of the example."""
    from nucleoatac_torch.models.data import tile_chunks as ttile_chunks

    ex, _, _, _, tchunks, _ = example
    return (tscan_bam(ex["bam"], TCFG.ingest),
            ttile_chunks(tchunks, TCFG.window, TCFG.occ, TCFG.vmat))


def _stage_cfg(wire, exact):
    return dataclasses.replace(
        TCFG, window=dataclasses.replace(TCFG.window, transfer=wire),
        occ=dataclasses.replace(TCFG.occ, exact=exact),
        nuc=dataclasses.replace(TCFG.nuc, exact=exact))


def _occ_close(teng, jeng, traw, jraw, exact):
    """Grid indices equal wherever both engines certify."""
    assert traw.shape == jraw.shape and traw.dtype == np.uint8
    if exact:  # wire v8
        (tidx, tcert), (jidx, jcert) = teng.decode_occ2(traw), jeng.decode_occ2(jraw)
        both, floor = tcert & jcert, 0.5
    else:  # wire v2
        tidx, jidx = traw & 0x7F, jraw & 0x7F
        both, floor = (traw[:, 0] >> 7).astype(bool) & (jraw[:, 0] >> 7).astype(bool), 0.9
    assert both.mean() > floor
    for c in range(3):
        np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])


def _nuc5_close(got, want):
    """norm and norm_smooth within nuc.exact_tol, signal, lr and fuzz at
    the JAX package's bars."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got[:, :2] - want[:, :2]).max() <= CFG.nuc.exact_tol
    for c, (rtol, atol) in NONEXACT_TOL.items():
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=rtol, atol=atol)
    assert np.abs(want[:, 0]).max() > 1.0  # non-vacuous


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "nonexact"])
@pytest.mark.parametrize("stage,wire", [
    *[("occ", w) for w in STAGE_WIRES],
    *[("nuc", w) for w in STAGE_WIRES],
    *[("nuc_bias_track", w) for w in ("delta12", "delta", "packed")],
])
def test_two_pass_stage_dispatch_matches_the_reference_step(
        example, engines, bias_engines, port_tiles, stage, wire, exact):
    """The first batch of OccStage._batches / NucStage._batches, dispatched
    on the CPU engine, against the JAX engine's named step that the
    reference's stage picks for the wire and mode, on the same host
    arrays. "nuc_bias_track" is the --bias_track form: engines without a
    PWM, f32 log-bias rows."""
    from nucleoatac_torch.models.nuc import NucStage
    from nucleoatac_torch.models.occ import OccStage

    ex, _, _, _, tchunks, _ = example
    tfrags, ttiles = port_tiles
    jeng, teng = bias_engines if stage == "nuc_bias_track" else engines
    cfg = _stage_cfg(wire, exact)
    if stage == "occ":
        batches, dispatch = OccStage(cfg, teng)._batches(tfrags, ttiles)
        b = next(iter(batches))
        stem, arrays = REF_OCC[wire]
        want = getattr(jeng, stem + ("_p2" if exact else "_c3"))(
            *map(jnp.asarray, arrays(b)))
        _occ_close(teng, jeng, dispatch(b).numpy(), np.asarray(want), exact)
        return

    fasta = TFastaFile(ex["fasta"])
    seen = {}

    def seq_rows(metas):
        seen["codes"] = SeqCodesProvider(fasta, tchunks, teng, TCFG.window.batch).rows(metas)
        return seen["codes"]

    def log_bias_rows(batch):
        rng = np.random.default_rng(7)
        seen["logb"] = rng.normal(0, 0.3, (TCFG.window.batch, teng.width)).astype(np.float32)
        return seen["logb"]

    nstage = NucStage(cfg, teng, TPWM.default(), fasta)
    batches, dispatch = nstage._batches(tfrags, ttiles, seq_rows, log_bias_rows)
    b = next(iter(batches))
    got = dispatch(b).numpy()
    stem, arrays = REF_NUC[wire]
    seq = jeng.pwm is not None and wire in ("delta12", "delta", "packed")
    if seq:
        # nibble-packed codes on the delta wires, plain ones on packed
        last = seen["codes"] if wire == "packed" else pack_nibble_codes(seen["codes"])
    else:
        last = seen["logb"]
    step = getattr(jeng, stem + ("_seq" if seq else "") + ("_m16" if exact else "_c"))
    want = np.asarray(step(*map(jnp.asarray, arrays(b)), jnp.asarray(last)))
    assert set(seen) == {"codes" if seq else "logb"}
    if exact:
        _decoded_close(jeng, teng, want, got)
    else:
        _nuc5_close(got, want)


# ---------------- the xcorr route switch (cfg.window.conv) ----------------
def test_diag_pallas_norm_matches_device_engine(example, batches):
    """TorchEngine(conv='diag_pallas') against the reference's Pallas route
    (interpret mode on the CPU backend): f32 norms within nuc.exact_tol."""
    _, _, _, fits, _, _ = example
    jeng = DeviceEngine(CFG, fits["jax"][1], fits["jax"][0], pwm=PWM.default(),
                        conv_mode="diag_pallas")
    teng = TorchEngine(TCFG, fits["torch"][1], fits["torch"][0], pwm=TPWM.default(),
                       device="cpu", conv="diag_pallas")
    b, nib = batches[0][0], batches[2][0]
    jn = np.asarray(jeng._nucm(jeng._raster_delta12(jnp.asarray(b.buf)),
                               jeng._logbias_nib(jnp.asarray(nib))))
    tn = teng._nucm(teng._raster_delta12(T(b.buf)), teng._logbias_nib(T(nib))).numpy()
    assert tn.shape == jn.shape and np.abs(jn).max() > 1.0
    assert np.abs(tn - jn).max() <= CFG.nuc.exact_tol


@pytest.mark.parametrize("conv,k1_calls,k2_calls", [
    ("diag", 0, 1), ("diag_pallas", 1, 0),
])
def test_conv_route_follows_config(example, batches, monkeypatch, conv, k1_calls, k2_calls):
    """cfg.window.conv picks the route: diag_pallas goes through K1's
    nuc_conv_outputs (two diag_xcorr stacks), diag through K2's nuc_scores;
    each nuc batch counts one engine step."""
    import dataclasses

    _, _, _, fits, _, _ = example
    fs, mix = fits["torch"]
    cfg = dataclasses.replace(
        TCFG, window=dataclasses.replace(TCFG.window, conv=conv))
    eng = TorchEngine(cfg, mix, fs, pwm=TPWM.default(), device="cpu")
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
    d12, _, nibs = batches
    for b, nib in zip(d12, nibs):
        eng.nuc_step_delta12_seq_m16(T(b.buf), T(nib))
    assert calls == {"k1": k1_calls * len(d12), "k2": k2_calls * len(d12)}
    assert eng.steps == len(d12)


def test_conv_direct_builds_and_unknown_route_raises(example, batches):
    """conv="direct" is a route of its own (no kernel launch, one engine
    step per batch); a route the reference does not have is refused."""
    _, _, _, fits, _, _ = example
    fs, mix = fits["torch"]
    eng = TorchEngine(TCFG, mix, fs, pwm=TPWM.default(), device="cpu", conv="direct")
    b, nib = batches[0][0], batches[2][0]
    assert eng.nuc_step_delta12_seq_m16(T(b.buf), T(nib)).dtype == torch.uint8
    assert eng.steps == 1
    with pytest.raises(ValueError, match="conv"):
        TorchEngine(TCFG, mix, fs, device="cpu", conv="fft")


# ---------------- whole runs ----------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on the fused pool pass and on the two-pass delta12 stages,
    and the reference's run, on the synthetic example."""
    import dataclasses

    from nucleoatac_tpu.models.pipeline import run_pipeline as run_jax
    from nucleoatac_torch.models.pipeline import run_pipeline as run_torch

    d = tmp_path_factory.mktemp("torch_two_pass")
    ex = make_example(d)
    two = dataclasses.replace(
        CFG, window=dataclasses.replace(CFG.window, transfer="delta12"))
    kw = dict(fasta_path=ex["fasta"], write_plots=False)
    out = {k: str(d / k) for k in ("fused", "two", "jax")}
    res = {
        "fused": run_torch(ex["bam"], ex["bed"], out["fused"], cfg=TCFG, device="cpu", **kw),
        "two": run_torch(ex["bam"], ex["bed"], out["two"], cfg=port_config(two),
                         device="cpu", **kw),
    }
    run_jax(ex["bam"], ex["bed"], out["jax"], cfg=two, **kw)
    return out, res


@pytest.mark.parametrize("suffix", RUN_SUFFIXES)
def test_two_pass_equals_fused_row_for_row(runs, suffix):
    out, _ = runs
    with gzip.open(out["fused"] + suffix, "rt") as a, gzip.open(out["two"] + suffix, "rt") as b:
        want = a.read()
        assert want and b.read() == want


def test_two_pass_ran_the_standalone_stages(runs):
    _, res = runs
    assert res["two"].occ_stage.n_spot_checked > 0
    assert res["two"].engine.steps == res["fused"].engine.steps > 0
    assert [c.bed_row() for c in res["two"].nuc.calls] == [
        c.bed_row() for c in res["fused"].nuc.calls]


@pytest.fixture(scope="module")
def ref_stats(runs):
    out, _ = runs
    return compare_runs(out["jax"], out["two"], CFG.nuc.exact_tol)


@pytest.mark.parametrize("suffix", EXACT_SUFFIXES + NUCPOS_SUFFIXES)
def test_two_pass_rows_equal_reference(ref_stats, suffix):
    assert ref_stats[suffix] > 0


@pytest.mark.parametrize("suffix", SIGNAL_SUFFIXES)
def test_two_pass_signal_within_exact_tol(ref_stats, suffix):
    assert ref_stats[suffix + " max_abs_diff"] <= CFG.nuc.exact_tol
