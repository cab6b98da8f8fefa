"""The port's host->device wires and its `conv="direct"` route against the
JAX package (CPU backend), from the same seeded inputs: the packed-word,
delta-pair and fragment-list rasters (counts equal), DeviceEngine's entry
points of the delta, packed, frags and dense wires against TorchEngine's
steps of the same names, in exact and non-exact form, a size range above
255 on the packed wire, and the direct route."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nucleoatac_tpu.config import RunConfig, SizesParams, WindowParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
from nucleoatac_tpu.core.mixture import FragmentMixDistribution
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.models import data as jdata
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.models.occ import fit_mixture as jfit_mixture
from nucleoatac_tpu.ops import rasterize as jras
from nucleoatac_tpu.ops.xcorr import _conv_stack as jconv_stack
from nucleoatac_torch.core.chunk import ChunkList as TChunkList
from nucleoatac_torch.core.fragmentsizes import FragmentSizes as TFragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution as TFragmentMixDistribution
from nucleoatac_torch.core.pwm import PWM as TPWM
from nucleoatac_torch.io.bam import scan_bam as tscan_bam
from nucleoatac_torch.io.fasta import FastaFile as TFastaFile
from nucleoatac_torch.models import data as tdata
from nucleoatac_torch.models import engine as tengine_mod
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import SeqCodesProvider
from nucleoatac_torch.ops import rasterize as tras
from nucleoatac_torch.ops.xcorr import _conv_stack, conv_stack_direct
from nucleoatac_torch.parity import NONEXACT_STAT_TOL, port_config
from synth import make_example

T = torch.from_numpy
CFG = RunConfig(window=WindowParams(core=256, batch=4))
TOL = CFG.nuc.exact_tol
# non-exact [B, 5, W] channel -> the JAX package's bar against its mirror
STAT_TOL = {2: NONEXACT_STAT_TOL[9], 3: NONEXACT_STAT_TOL[7], 4: NONEXACT_STAT_TOL[10]}


def _check_nuc5(got, want):
    """[B, 5, W] tracks: norm and norm_smooth within nuc.exact_tol; signal,
    lr and fuzz at the JAX package's bars. Returns max |want| per channel."""
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got[:, :2] - want[:, :2]).max() <= TOL
    for ch, (rtol, atol) in STAT_TOL.items():
        np.testing.assert_allclose(got[:, ch], want[:, ch], rtol=rtol, atol=atol)
    return np.abs(want).max(axis=(0, 2))


# ---------------- rasters -------------------------------------------------
def _lists(rng, counts, W, size_hi):
    """Sorted window-relative midpoints and sizes per row, seeded."""
    out = []
    for n in counts:
        out.append((np.sort(rng.integers(0, W, n)).astype(np.int64),
                    rng.integers(1, size_hi, n).astype(np.int64)))
    return out


@pytest.mark.parametrize("upper", [251, 500])
def test_rasterize_packed_matches_frags(rng, upper):
    """Packed words decode to the lists they came from (sizes up to 600,
    so past 255 and past upper), and rasterize to the JAX package's
    counts and to the fragment-list raster exactly."""
    B, F, W = 3, 500, 512
    lists = _lists(rng, [F, 123, 0], W, 600)
    packed = np.zeros((B, F), np.int32)
    mids = np.zeros((B, F), np.int32)
    sizes = np.zeros((B, F), np.int32)
    valid = np.zeros((B, F), bool)
    for b, (m, s) in enumerate(lists):
        tdata.pack_fragments(m, s, packed, b)
        mids[b, :len(m)], sizes[b, :len(m)], valid[b, :len(m)] = m, s, True
    got = [x.numpy() for x in tras.unpack_fragments(T(packed))]
    for g, w in zip(got, (mids, sizes, valid)):
        np.testing.assert_array_equal(g, w)
    want = np.asarray(jras.rasterize_packed_batch(jnp.asarray(packed), 0, upper, W))
    port = tras.rasterize_packed_batch(T(packed), 0, upper, W).numpy()
    frags = tras.rasterize_batch(T(mids), T(sizes), T(valid), 0, upper, W).numpy()
    assert want.sum() > 100 and want.shape == (B, upper, W)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(frags, want)


def test_delta_roundtrip(rng):
    """Delta encode -> decode recovers the sorted lists, gaps over 255 bp
    (skip entries) and empty windows included, and equals the JAX
    package's decode element for element."""
    B, F, W = 4, 600, 1500
    lists = _lists(rng, [400, 3, 0, 120], W, 251)
    db = np.zeros((B, F, 2), np.uint8)
    for b, (m, s) in enumerate(lists):
        assert tdata.encode_delta_fragments(m, s, db, b) <= F
    got = [x.numpy() for x in tras.unpack_delta_fragments(T(db))]
    want = [np.asarray(x) for x in jras.unpack_delta_fragments(jnp.asarray(db))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    m, s, v = got
    for b, (mids, sizes) in enumerate(lists):
        np.testing.assert_array_equal(m[b][v[b]], mids)
        np.testing.assert_array_equal(s[b][v[b]], sizes)


def test_rasterize_delta_matches_frags(rng):
    """Sizes past upper (saturated at 255 by the encoder) drop out of the
    delta raster as they drop out of the fragment-list raster."""
    B, F, W = 3, 600, 1024
    lists = _lists(rng, [500, 17, 0], W, 320)
    db = np.zeros((B, F, 2), np.uint8)
    mids = np.zeros((B, F), np.int64)
    sizes = np.zeros((B, F), np.int64)
    valid = np.zeros((B, F), bool)
    for b, (m, s) in enumerate(lists):
        tdata.encode_delta_fragments(m, s, db, b)
        mids[b, :len(m)], sizes[b, :len(m)], valid[b, :len(m)] = m, np.minimum(s, 255), True
    got = tras.rasterize_delta_batch(T(db), 0, 251, W).numpy()
    want = np.asarray(jras.rasterize_delta_batch(jnp.asarray(db), 0, 251, W))
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tras.rasterize_batch(T(mids), T(sizes), T(valid), 0, 251, W).numpy())


def test_delta12_raster_matches_delta(rng):
    """The same fragments on the 12-bit records and on the delta pairs
    give the same count matrices."""
    B, F, W = 2, 256, 1536
    mids = np.sort(rng.integers(0, W, size=(B, F)), axis=1).astype(np.int64)
    sizes = rng.integers(20, 250, size=(B, F)).astype(np.int64)
    db = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
    tdata.encode_delta_batch(mids, sizes, db)
    E = tdata.delta12_entry_capacity(F, W)
    buf = np.zeros((B, E // 2 + E), np.uint8)
    tdata.encode_delta12_batch(mids, sizes, buf)
    a = tras.rasterize_delta_batch(T(db), 0, 251, W)
    b = tras.rasterize_delta12_batch(T(buf), E, 0, 251, W)
    assert a.sum() == B * F
    assert torch.equal(a, b)


# ---------------- the direct route ----------------------------------------
def test_conv_stack_direct_matches_oracle_and_jax(rng):
    """conv1d over S channels against the einsum oracle and the JAX
    package's XLA convolution: the same valid cross-correlation."""
    x = rng.random((2, 6, 40), dtype=np.float32) * 3
    k = rng.random((5, 6, 9), dtype=np.float32)
    got = conv_stack_direct(T(x), T(k))
    assert got.shape == (2, 5, 32)
    torch.testing.assert_close(got, _conv_stack(T(x), T(k)), rtol=1e-5, atol=1e-5)
    want = np.asarray(jconv_stack(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------- engine entry points on real windows ---------------------
@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """The example read and fitted by each package on its own, the JAX
    package's batches on every wire (one pool batch per delta12 batch),
    and the sequence-code rows."""
    from nucleoatac_torch.models.occ import fit_mixture as tfit_mixture

    ex = make_example(tmp_path_factory.mktemp("transfer_example"))
    frags = scan_bam(ex["bam"], CFG.ingest)
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    tcfg = port_config(CFG)
    tfrags = tscan_bam(ex["bam"], tcfg.ingest)
    tchunks = TChunkList.read(ex["bed"], tfrags.chrom_dict).merge()
    fits = {"jax": jfit_mixture(frags, chunks, CFG),
            "torch": tfit_mixture(tfrags, tchunks, tcfg)}
    jeng = DeviceEngine(CFG, fits["jax"][1], fits["jax"][0], pwm=PWM.default())
    tiles = jdata.tile_chunks(chunks, CFG.window, CFG.occ, CFG.vmat)
    W, B = jeng.width, CFG.window.batch
    wires = {
        "delta": list(jdata.make_delta_batches(frags, tiles, W, B)),
        "packed": list(jdata.make_packed_batches(frags, tiles, W, B)),
        "frags": list(jdata.make_batches(frags, tiles, W, B)),
        "dense": list(jdata.make_dense_batches(frags, tiles, W, B, CFG.sizes.lower,
                                               CFG.sizes.upper)),
        "delta12": list(jdata.make_delta12_batches(frags, tiles, W, B)),
    }
    # the pool wire over each delta12 batch's windows
    wires["pool"] = [p for b in wires["delta12"]
                     for p in jdata.make_pool_batches(frags, b.meta, W, B)]
    teng = _engine(fits, CFG)
    seq = SeqCodesProvider(TFastaFile(ex["fasta"]), tchunks, teng, B)
    codes = [seq.rows(b.meta) for b in wires["delta"]]
    rng = np.random.default_rng(5)
    logb = [rng.normal(0, 0.3, size=(B, W)).astype(np.float32) for _ in codes]
    return fits, jeng, wires, codes, logb


def _engine(fits, cfg, conv="diag"):
    fs, mix = fits["torch"]
    cfg = port_config(dataclasses.replace(
        cfg, window=dataclasses.replace(cfg.window, conv=conv)))
    return TorchEngine(cfg, mix, fs, pwm=TPWM.default(), device="cpu")


WIRE_ARGS = {
    "delta": lambda b: [b.delta],
    "packed": lambda b: [b.packed],
    "frags": lambda b: [b.mids, b.sizes, b.valid],
    "dense": lambda b: [b.mats],
}
NUC_FORMS = ("delta_seq", "delta", "packed_seq", "packed", "frags", "dense")


def _nuc_args(form, b, codes, logb):
    """Arguments of nuc_step_{form}_*: the wire, then nibble codes (delta),
    plain uint8 codes (packed) or an f32 log-bias row."""
    wire = form.replace("_seq", "")
    if form == "delta_seq":
        last = jdata.pack_nibble_codes(codes)
    elif form == "packed_seq":
        last = codes
    else:
        last = logb
    return WIRE_ARGS[wire](b) + [last]


def _rasters(jeng, teng, wire, b):
    """Both engines' f32 count matrices of one batch on ``wire``."""
    a = WIRE_ARGS[wire](b)
    if wire == "dense":
        return jnp.asarray(b.mats).astype(jnp.float32), teng._dense(T(b.mats))
    jf = {"delta": jeng._raster_delta, "packed": jeng._raster_packed, "frags": jeng._raster}
    tf = {"delta": teng._raster_delta, "packed": teng._raster_packed,
          "frags": teng._raster_frags}
    return jf[wire](*map(jnp.asarray, a)), tf[wire](*map(T, a))


@pytest.mark.parametrize("wire,sfx", [
    (w, s) for w in ("delta", "packed", "dense") for s in ("p2", "c3")])
def test_occ_step_matches_device_engine(example, wire, sfx):
    """occ_step_{delta,packed,}_{p2,c3}: grid indices equal wherever both
    engines certify, and the rasters equal."""
    fits, jeng, wires, _, _ = example
    teng = _engine(fits, CFG)
    name = f"occ_step_{wire}_{sfx}" if wire != "dense" else f"occ_step_{sfx}"
    step = getattr(teng, name)
    for b in wires[wire]:
        jm, tm = _rasters(jeng, teng, wire, b)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        a = WIRE_ARGS[wire](b)
        want = np.asarray(getattr(jeng, name)(*map(jnp.asarray, a)))
        got = step(*map(T, a)).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        if sfx == "p2":
            (jidx, jcert), (tidx, tcert) = jeng.decode_occ2(want), teng.decode_occ2(got)
            both = jcert & tcert
        else:
            jidx, tidx = want & 0x7F, got & 0x7F
            both = (got[:, 0] >> 7).astype(bool) & (want[:, 0] >> 7).astype(bool)
        assert both.mean() > 0.5
        for c in range(3):
            np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])


@pytest.mark.parametrize("form", NUC_FORMS)
def test_nuc_step_m16_matches_device_engine(example, form):
    """nuc_step_{form}_m16: the f32 norm within nuc.exact_tol, the decoded
    u16 norm within exact_tol plus one quantization step (each side rounds
    to its own u16 level)."""
    fits, jeng, wires, codes, logb = example
    teng = _engine(fits, CFG)
    wire = form.replace("_seq", "")
    peak = 0.0
    for b, c, lb in zip(wires[wire], codes, logb):
        args = _nuc_args(form, b, c, lb)
        jbuf = np.asarray(getattr(jeng, f"nuc_step_{form}_m16")(*map(jnp.asarray, args)))
        tbuf = getattr(teng, f"nuc_step_{form}_m16")(*map(T, args)).numpy()
        assert tbuf.shape == jbuf.shape and tbuf.dtype == np.uint8
        (jn, jq), (tn, tq) = jeng.f32_from_u16(jbuf), teng.f32_from_u16(tbuf)
        assert (np.abs(tn - jn) <= TOL + np.maximum(jq, tq)[:, None]).all()
        jm, tm = _rasters(jeng, teng, wire, b)
        if form.endswith("_seq"):
            jl = (jeng._logbias_nib if wire == "delta" else jeng._logbias_seq)(
                jnp.asarray(args[-1]))
            tl = (teng._logbias_nib if wire == "delta" else teng._logbias_seq)(T(args[-1]))
        else:
            jl, tl = jnp.asarray(lb), T(lb)
        j32 = np.asarray(jeng._nucm(jm, jl))
        t32 = teng._nucm(tm, tl).numpy()
        assert np.abs(t32 - j32).max() <= TOL
        peak = max(peak, float(np.abs(j32).max()))
    assert peak > 1.0  # non-vacuous


@pytest.mark.parametrize("form", NUC_FORMS)
def test_nuc_step_c_matches_device_engine(example, form):
    """nuc_step_{form}_c (non-exact): norm and norm_smooth within
    nuc.exact_tol, signal, lr and fuzz at the JAX package's bars."""
    fits, jeng, wires, codes, logb = example
    cfg = dataclasses.replace(CFG, occ=dataclasses.replace(CFG.occ, exact=False),
                              nuc=dataclasses.replace(CFG.nuc, exact=False))
    teng = _engine(fits, cfg)
    peak = np.zeros(5)
    for b, c, lb in zip(wires[form.replace("_seq", "")], codes, logb):
        args = _nuc_args(form, b, c, lb)
        want = np.asarray(getattr(jeng, f"nuc_step_{form}_c")(*map(jnp.asarray, args)))
        got = getattr(teng, f"nuc_step_{form}_c")(*map(T, args)).numpy()
        peak = np.maximum(peak, _check_nuc5(got, want))
    assert (peak > np.array([1.0, 1.0, 0.1, 1.0, 1.0])).all()
    assert teng.steps == len(codes)


@pytest.mark.parametrize("conv,k1_calls,k2_calls", [
    ("diag", 0, 1), ("diag_pallas", 1, 0), ("direct", 0, 0)])
def test_every_route_counts_its_launches_on_the_new_wires(example, monkeypatch, conv,
                                                          k1_calls, k2_calls):
    """A nuc batch on the packed and frags wires calls K2 once under
    "diag", K1's nuc_conv_outputs (two stacks) once under "diag_pallas",
    neither under "direct"; each batch counts one engine step."""
    fits, _, wires, codes, logb = example
    eng = _engine(fits, CFG, conv)
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
    for form in ("packed_seq", "frags"):
        for b, c, lb in zip(wires[form.replace("_seq", "")], codes, logb):
            getattr(eng, f"nuc_step_{form}_m16")(*map(T, _nuc_args(form, b, c, lb)))
    n = 2 * len(codes)
    assert calls == {"k1": k1_calls * n, "k2": k2_calls * n}
    assert eng.steps == n


@pytest.mark.parametrize("exact", [True, False])
def test_direct_route_matches_device_engine(example, exact):
    """TorchEngine(conv="direct") against DeviceEngine(conv_mode="direct"):
    the f32 norm within nuc.exact_tol (exact), the [B, 5, W] tracks at the
    non-exact bars (non-exact)."""
    fits, _, wires, codes, _ = example
    jeng = DeviceEngine(CFG, fits["jax"][1], fits["jax"][0], pwm=PWM.default(),
                        conv_mode="direct")
    teng = _engine(fits, CFG, "direct")
    for b, c in zip(wires["delta"], codes):
        nib = jdata.pack_nibble_codes(c)
        jm, jl = jeng._raster_delta(jnp.asarray(b.delta)), jeng._logbias_nib(jnp.asarray(nib))
        tm, tl = teng._raster_delta(T(b.delta)), teng._logbias_nib(T(nib))
        if exact:
            want, got = np.asarray(jeng._nucm(jm, jl)), teng._nucm(tm, tl).numpy()
            assert np.abs(want).max() > 1.0 and np.abs(got - want).max() <= TOL
        else:
            _check_nuc5(teng._nuc5(tm, tl).numpy(), np.asarray(jeng._nuc5(jm, jl)))


def test_direct_route_agrees_with_k2_route(example):
    """The direct route and K2's plain version compute the same scores,
    every channel at its bar."""
    fits, _, wires, codes, _ = example
    a, b = _engine(fits, CFG, "diag"), _engine(fits, CFG, "direct")
    for w, c in zip(wires["delta"], codes):
        nib = T(jdata.pack_nibble_codes(c))
        _check_nuc5(b.nuc_step_delta_seq_c(T(w.delta), nib).numpy(),
                    a.nuc_step_delta_seq_c(T(w.delta), nib).numpy())


# ---------------- a size range past 255 on the packed wire ---------------
def _upper_config(upper, port):
    """RunConfig with sizes [0, upper) on the packed wire and a fitted
    mixture over a histogram with a di-nucleosomal bump at ~340 bp."""
    cfg = RunConfig(sizes=SizesParams(upper=upper),
                    window=WindowParams(core=256, batch=2, transfer="packed"))
    sizes_cls, mix_cls = FragmentSizes, FragmentMixDistribution
    if port:
        cfg, sizes_cls, mix_cls = port_config(cfg), TFragmentSizes, TFragmentMixDistribution
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (2e4 * np.exp(-s / 45.0) + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)
              + 2e3 * np.exp(-0.5 * ((s - 340) / 25) ** 2)).astype(np.int64)
    fs = sizes_cls(cfg.sizes.lower, cfg.sizes.upper, counts)
    return cfg, fs, mix_cls(cfg.sizes.lower, cfg.sizes.upper).fit(fs)


def test_upper_500_packed_steps_match_device_engine(rng):
    """sizes.upper = 500: the raster carries 500 size rows, occ reads all
    of them and nuc its 105-251 slice; both steps meet the bars against
    DeviceEngine on fragments with sizes up to 480."""
    cfg, fs, mix = _upper_config(500, port=False)
    tcfg, tfs, tmix = _upper_config(500, port=True)
    jeng = DeviceEngine(cfg, mix, fs, pwm=PWM.default())
    teng = TorchEngine(tcfg, tmix, tfs, pwm=TPWM.default(), device="cpu")
    B, F, W = 2, 1200, jeng.width
    packed = np.zeros((B, F), np.int32)
    for b in range(B):
        tdata.pack_fragments(rng.integers(0, W, F), rng.integers(20, 480, F), packed, b)
    codes = rng.integers(0, 4, size=(B, jeng.seq_codes_width())).astype(np.uint8)
    mat = teng._raster_packed(T(packed))
    assert mat.shape == (B, 500, W) and float(mat[:, 256:].sum()) > 0
    (jidx, jcert) = jeng.decode_occ2(np.asarray(jeng.occ_step_packed_p2(jnp.asarray(packed))))
    (tidx, tcert) = teng.decode_occ2(teng.occ_step_packed_p2(packed).numpy())
    both = jcert & tcert
    assert both.mean() > 0.5
    for c in range(3):
        np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])
    j32 = np.asarray(jeng._nucm(jeng._raster_packed(jnp.asarray(packed)),
                                jeng._logbias_seq(jnp.asarray(codes))))
    t32 = teng._nucm(mat, teng._logbias_seq(T(codes))).numpy()
    assert np.abs(j32).max() > 1.0 and np.abs(t32 - j32).max() <= TOL
