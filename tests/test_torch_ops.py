"""Torch ops of the main device chain against the JAX package's ops on
the CPU backend, from the same seeded numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.models.data import pack_2bit_codes, pack_nibble_codes
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.ops import biasmat as jbias
from nucleoatac_tpu.ops import occupancy as jocc
from nucleoatac_tpu.ops import pwmseq as jpwm
from nucleoatac_tpu.ops import rasterize as jras
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.ops import biasmat as tbias
from nucleoatac_torch.ops import occupancy as tocc
from nucleoatac_torch.ops import pwmseq as tpwm
from nucleoatac_torch.ops import rasterize as tras

T = torch.from_numpy


def _pool_inputs(rng, B=3, W=640, n=400):
    """A wire-v7 pool and table built with the reference's encoder."""
    from nucleoatac_tpu.models.data import _encode_chunk_stream12

    mids = np.sort(rng.integers(-30, W + 30, size=n)).astype(np.int64)
    sizes = rng.integers(1, 300, size=n).astype(np.int64)
    nib, sz, frag_pos, pos_before = _encode_chunk_stream12(mids, sizes, -40)
    if len(nib) & 1:
        nib, sz = np.append(nib, 0), np.append(sz, 0)
    cap = len(nib)
    pool = np.concatenate([(nib[0::2] | (nib[1::2] << 4)).astype(np.uint8),
                           sz.astype(np.uint8)])
    table = np.zeros((B, 3), np.int32)
    starts = [0, 60, 200]
    for r, ws in enumerate(starts[:B]):
        j0 = int(np.searchsorted(mids, ws))
        j1 = int(np.searchsorted(mids, ws + W))
        rs = int(frag_pos[j0]) & ~1
        table[r] = (rs, int(frag_pos[j1 - 1]) + 1 - rs, int(pos_before[rs]) - ws)
    emax = int(-(-table[:, 1].max() // 2) * 2)
    assert cap >= emax
    return pool, table, emax, W


def test_pool_raster_exactly_equal(rng):
    pool, table, emax, W = _pool_inputs(rng)
    want = np.asarray(jras.rasterize_pool_batch(
        jnp.asarray(pool), jnp.asarray(table), emax, 0, 251, W))
    got = tras.rasterize_pool_batch(T(pool), T(table), emax, 0, 251, W).numpy()
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)


def test_unpack_pool_fragments_equal(rng):
    pool, table, emax, _ = _pool_inputs(rng)
    jm, js, jv = jras.unpack_pool_fragments(jnp.asarray(pool), jnp.asarray(table), emax)
    tm, ts, tv = tras.unpack_pool_fragments(T(pool), T(table), emax)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _codes(rng, B=4, wp=301, n_frac=0.02):
    codes = rng.integers(0, 4, size=(B, wp)).astype(np.uint8)
    codes[rng.random((B, wp)) < n_frac] = 4
    return codes


def test_unpack_2bit_codes_equal(rng):
    codes = _codes(rng)
    packed, esc, ok = pack_2bit_codes(codes)
    assert ok
    want = np.asarray(jpwm.unpack_2bit_codes(
        jnp.asarray(packed), codes.shape[1], jnp.asarray(esc)))
    got = tpwm.unpack_2bit_codes(T(packed), codes.shape[1], T(esc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codes)


def test_unpack_nibble_codes_equal(rng):
    codes = _codes(rng, wp=300)
    packed = pack_nibble_codes(codes)
    want = np.asarray(jpwm.unpack_nibble_codes(jnp.asarray(packed), 300))
    got = tpwm.unpack_nibble_codes(T(packed), 300).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codes)


def test_pwm_bias_batch_matches(rng):
    lr = np.asarray(PWM.default().log_ratio(), np.float32)
    codes = _codes(rng, wp=512 + lr.shape[1] - 1)
    want = np.asarray(jpwm.pwm_bias_batch(jnp.asarray(codes), jnp.asarray(lr)))
    got = tpwm.pwm_bias_batch(T(codes), T(lr)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bias_mat_batch_matches(rng):
    B, W, lo, up = 3, 768, 105, 251
    logb = rng.normal(0, 0.3, size=(B, W)).astype(np.float32)
    q = rng.random(up - lo)
    q = (q / q.sum()).astype(np.float32)
    want = np.asarray(jbias.bias_mat_batch(jnp.asarray(logb), jnp.asarray(q),
                                           lo, up, 199, W - 199))
    got = tbias.bias_mat_batch(T(logb), T(q), lo, up, 199, W - 199).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _occ_inputs(rng, B=3, W=512, n=300):
    from nucleoatac_tpu.config import RunConfig
    from nucleoatac_tpu.core.fragmentsizes import FragmentSizes
    from nucleoatac_tpu.core.mixture import FragmentMixDistribution
    from nucleoatac_tpu import mirror

    cfg = RunConfig()
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (2e4 * np.exp(-s / 45.0)
              + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    log_mix = np.asarray(mix.log_mix_table(cfg.occ), np.float32)
    grid = np.asarray(mix.alpha_grid(cfg.occ), np.float32)
    mat = np.stack([
        mirror.rasterize(rng.integers(0, W, n), rng.integers(20, 250, n), 0, 251, W)
        for _ in range(B)
    ]).astype(np.float32)
    return cfg, mat, log_mix, grid


def test_ll_and_n_match(rng):
    """|LL_torch - LL_jax| <= 1e-4 where |LL| stays below ~600 (one f32
    ulp there is 6e-5; both sums are f32, in different orders)."""
    cfg, mat, log_mix, _ = _occ_inputs(rng, n=100)
    jll, jn = jocc._ll_and_n(jnp.asarray(mat), jnp.asarray(log_mix), cfg.occ.flank)
    tll, tn = tocc._ll_and_n(T(mat), T(log_mix), cfg.occ.flank)
    assert np.abs(tll.numpy()).max() < 600
    assert np.abs(tll.numpy() - np.asarray(jll)).max() <= 1e-4
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_ll_error_vs_f64_within_certification_margin(rng):
    """At |LL| ~ 1e3 the torch LL stays within occ.exact_tol / 4 of the
    same surface in float64 (the margin the f64 certification assumes)."""
    cfg, mat, log_mix, _ = _occ_inputs(rng, n=300)
    tll, _ = tocc._ll_and_n(T(mat), T(log_mix), cfg.occ.flank)
    l64, _ = tocc._ll_and_n(T(mat).double(), T(log_mix).double(), cfg.occ.flank)
    assert np.abs(l64.numpy()).max() > 1000
    assert np.abs(tll.numpy() - l64.numpy()).max() <= cfg.occ.exact_tol / 4


def test_occupancy_packed2_equal_where_both_certify(rng):
    cfg, mat, log_mix, _ = _occ_inputs(rng)
    p, lo, core = cfg.occ, 64, 384
    args = (p.flank, lo, core, p.ci_drop, p.exact_tol)
    want = np.asarray(jocc.occupancy_packed2(jnp.asarray(mat), jnp.asarray(log_mix), *args))
    got = tocc.occupancy_packed2(T(mat), T(log_mix), *args).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    both = (got[:, :core] >> 7).astype(bool) & (want[:, :core] >> 7).astype(bool)
    assert both.mean() > 0.5
    np.testing.assert_array_equal(got[:, :core][both], want[:, :core][both])
    np.testing.assert_array_equal(got[:, core:2 * core][both],
                                  want[:, core:2 * core][both])


def test_occupancy_batch_matches_where_certified(rng):
    cfg, mat, log_mix, grid = _occ_inputs(rng)
    p = cfg.occ
    want = jocc.occupancy_batch(jnp.asarray(mat), jnp.asarray(log_mix),
                                jnp.asarray(grid), p.flank, p.ci_drop)
    got = tocc.occupancy_batch(T(mat), T(log_mix), T(grid), p.flank, p.ci_drop)
    sure = (np.asarray(want.margin) > p.exact_tol) & (np.asarray(want.ci_margin) > p.exact_tol)
    assert sure.mean() > 0.5
    for name in ("occ", "lower", "upper"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[sure], np.asarray(getattr(want, name))[sure]
        )
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))


@pytest.mark.parametrize("kind", ["random", "constant_row", "negative"])
def test_u16_bytes_equal(rng, kind):
    x = rng.normal(0, 3, size=(4, 333)).astype(np.float32)
    if kind == "constant_row":
        x[1] = 2.5
    if kind == "negative":
        x = -np.abs(x) - 7.0
    want = np.asarray(DeviceEngine._u16_impl(jnp.asarray(x)))
    got = TorchEngine._u16(T(x)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------- peak calling (ops/peaks.py) -----------------------------
@pytest.mark.parametrize("halfwin,sep,max_calls", [(60, 120, 8), (5, 9, 40)])
def test_peaks_match_jax_and_mirror(rng, halfwin, sep, max_calls):
    """local_max_batch and greedy_select_batch against the JAX package's
    ops (equal outputs, invalid padding included) and the float64 mirror,
    with plateaus and a mask to exercise the tie rules."""
    from nucleoatac_tpu.ops import peaks as jpeaks
    from nucleoatac_torch import mirror
    from nucleoatac_torch.ops import peaks as tpeaks

    B, W = 3, 500
    x = rng.normal(0, 1, size=(B, W)).astype(np.float32)
    x[:, 100:104] = 5.0
    x[:, 300] = 6.0
    mask = x > -0.5
    cand = tpeaks.local_max_batch(T(x), halfwin, T(mask))
    want_c = np.asarray(jpeaks.local_max_batch(jnp.asarray(x), halfwin, jnp.asarray(mask)))
    np.testing.assert_array_equal(cand.numpy(), want_c)
    sel = tpeaks.greedy_select_batch(T(x), cand, sep, max_calls)
    want = jpeaks.greedy_select_batch(jnp.asarray(x), jnp.asarray(want_c), sep, max_calls)
    np.testing.assert_array_equal(sel.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(sel.valid.numpy(), np.asarray(want.valid))
    for b in range(B):
        cand_r = mirror.local_max_candidates(x[b].astype(np.float64), halfwin, mask[b])
        np.testing.assert_array_equal(cand[b].numpy(), cand_r)
        sel_r = mirror.greedy_select(x[b].astype(np.float64), cand_r, sep, max_calls)
        assert sel.positions[b][sel.valid[b]].tolist() == sel_r
