"""The rest of DeviceEngine's step API on the port, against the JAX package
(CPU backend) at make_example size on test_torch_transfer's seeded example:
every public step name, the wire-v1 occ form (_c), the f32 (_m), u24 (_m24)
and core-only (_c2) nuc forms on every wire, the pool wire's standalone
steps, the u24 codec, the fused run_step_delta and run_step_delta12, the
use_pallas switch and the dry run's chained-delta12 block.

Bars:
  * occ grid indices equal wherever both engines certify (a certified
    pick is the float64 pick on both sides); the v1 flag agrees on more
    than half of the positions;
  * _m and _c2 (norm, norm_smooth) within nuc.exact_tol;
  * _u24 byte-equal to the reference's _u24_impl on equal f32 inputs,
    negative values, infinities and NaN payloads included; _m24 decoded
    within nuc.exact_tol + 2^-16 |x| of the reference's f32 norm x;
  * u16 downloads (run_step_delta*, nuc_step_pool_seq_m16) decoded within
    nuc.exact_tol + one quantization step (each side rounds its own norm
    to its own u16 level);
  * the port's run_step_delta12, run_step_delta, run_step_pool and
    run_step_pool2 print one set of bytes on the same windows.
"""
import dataclasses
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu.models import data as jdata
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_torch.core.pwm import PWM as TPWM
from nucleoatac_torch.entry import dryrun_multichip
from nucleoatac_torch.models import engine as tengine_mod
from nucleoatac_torch.models.engine import CONV_ROUTES, TorchEngine
from nucleoatac_torch.parity import port_config
from test_torch_transfer import (  # noqa: F401 (example is a fixture)
    CFG,
    NUC_FORMS,
    TOL,
    WIRE_ARGS,
    _engine,
    _nuc_args,
    example,
)

T = torch.from_numpy
STEP = re.compile(r"^(occ|nuc|full|run)_(step|impl)")
DECODERS = ("f32_from_u24", "f32_from_u16", "unpack_run", "decode_occ2")
# DeviceEngine's steps before jit (for its compile checks); PyTorch has no
# jit split, so the *_step forms stand for them
PRE_JIT = {"full_impl", "full_impl_delta_seq", "full_impl_frags", "full_impl_packed",
           "full_impl_packed_seq", "occ_impl", "nuc_impl"}


def test_torch_engine_has_every_reference_step():
    """Every public occ/nuc/full/run step of DeviceEngine and its host
    decoders are TorchEngine attributes, under the same name and with the
    same parameters in the same order; only the pre-jit forms are not."""
    ref = [n for n in dir(DeviceEngine) if STEP.match(n)]
    assert len(ref) > 70
    missing = {n for n in ref + list(DECODERS) if not hasattr(TorchEngine, n)}
    assert missing == PRE_JIT
    for n in ref:
        if n not in PRE_JIT:
            got = getattr(TorchEngine, n)
            assert got.__name__ == n
            assert list(inspect.signature(got).parameters) == \
                list(inspect.signature(getattr(DeviceEngine, n)).parameters), n


# ---------------- occupancy, wire v1 --------------------------------------
@pytest.mark.parametrize("wire", ["dense", "delta", "packed"])
def test_occ_step_c_matches_device_engine(example, wire):
    """occ_step_{wire}_c: uint8 [B, 4, W]; the three grid indices equal
    wherever both engines certify, the flag agreeing on more than half the
    positions; over the core, the port's wire-v8 picks wherever both of its
    forms certify."""
    fits, jeng, wires, _, _ = example
    teng = _engine(fits, CFG)
    name = "occ_step_c" if wire == "dense" else f"occ_step_{wire}_c"
    p2 = "occ_step_p2" if wire == "dense" else f"occ_step_{wire}_p2"
    core = slice(teng.core_lo, teng.core_lo + teng.core)
    for b in wires[wire]:
        a = WIRE_ARGS[wire](b)
        want = np.asarray(getattr(jeng, name)(*map(jnp.asarray, a)))
        got = getattr(teng, name)(*map(T, a)).numpy()
        assert got.shape == want.shape == (CFG.window.batch, 4, teng.width)
        assert got.dtype == np.uint8
        both = (got[:, 3] == 1) & (want[:, 3] == 1)
        assert both.mean() > 0.5 and (got[:, 3] == want[:, 3]).mean() > 0.5
        for c in range(3):
            np.testing.assert_array_equal(got[:, c][both], want[:, c][both])
        idx, cert = teng.decode_occ2(getattr(teng, p2)(*map(T, a)).numpy())
        sel = cert & (got[:, 3, core] == 1)
        assert sel.mean() > 0.5
        for c in range(3):
            np.testing.assert_array_equal(got[:, c, core][sel], idx[:, c][sel])


# ---------------- nuc forms m, m24, c2 on every wire ----------------------
@pytest.mark.parametrize("form", NUC_FORMS)
@pytest.mark.parametrize("sfx", ["m", "m24", "c2"])
def test_nuc_step_form_matches_device_engine(example, form, sfx):
    """nuc_step_{form}_{sfx}: the reference's shape and dtype; _m and _c2
    within nuc.exact_tol, _m24 decoded within nuc.exact_tol + 2^-16 |x|
    of the reference's f32 norm x and within 2^-16 relative of the port's
    own _m; one nuc step per call."""
    fits, jeng, wires, codes, logb = example
    teng = _engine(fits, CFG)
    name = f"nuc_step_{form}_{sfx}"
    peak = 0.0
    for b, c, lb in zip(wires[form.replace("_seq", "")], codes, logb):
        args = _nuc_args(form, b, c, lb)
        want = np.asarray(getattr(jeng, name)(*map(jnp.asarray, args)))
        got = getattr(teng, name)(*map(T, args)).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if sfx == "m24":
            m = f"nuc_step_{form}_m"
            x = np.asarray(getattr(jeng, m)(*map(jnp.asarray, args)))
            dec = teng.f32_from_u24(got)
            assert (np.abs(dec - x) <= TOL + 2.0 ** -16 * np.abs(x)).all()
            own = getattr(teng, m)(*map(T, args)).numpy()
            np.testing.assert_allclose(dec, own, rtol=2.0 ** -16, atol=1e-30)
            want = x
        else:
            assert np.abs(got - want).max() <= TOL
        peak = max(peak, float(np.abs(want).max()))
    assert peak > 1.0  # non-vacuous
    n_calls = len(codes) * (2 if sfx == "m24" else 1)
    assert teng.steps == n_calls


@pytest.mark.parametrize("name", ["occ_step_pool_p2", "nuc_step_pool_seq_m16"])
def test_pool_steps_match_device_engine(example, name):
    """The pool wire's standalone steps: occ indices equal wherever both
    engines certify; the u16 norm within nuc.exact_tol + one step."""
    fits, jeng, wires, codes, _ = example
    teng = _engine(fits, CFG)
    for p, c in zip(wires["pool"], codes):
        args = [p.pool, p.table] + ([jdata.pack_nibble_codes(c)] if "nuc" in name else [])
        want = np.asarray(getattr(jeng, name)(*map(jnp.asarray, args), p.emax))
        got = getattr(teng, name)(*map(T, args), p.emax).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        if "occ" in name:
            (jidx, jcert), (tidx, tcert) = jeng.decode_occ2(want), teng.decode_occ2(got)
            both = jcert & tcert
            assert both.mean() > 0.5
            for ch in range(3):
                np.testing.assert_array_equal(tidx[:, ch][both], jidx[:, ch][both])
        else:
            (jn, jq), (tn, tq) = jeng.f32_from_u16(want), teng.f32_from_u16(got)
            assert (np.abs(tn - jn) <= TOL + np.maximum(jq, tq)[:, None]).all()


# ---------------- the u24 codec -------------------------------------------
def test_u24_is_byte_equal_to_the_reference(rng):
    """_u24 against DeviceEngine._u24_impl on equal f32 words: ordinary
    values, signed zeros, denormals, the largest finite values (which round
    up to infinity), infinities, quiet and signalling NaNs with payloads,
    the words whose + 0x80 wraps past 2^32, and 4,096 random words."""
    special = np.array([0.0, -0.0, 1.5, -3.25, 1e-20, 12345.678, -9.999e4], np.float32)
    crafted = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC00001, 0xFFC00000,
                        0x7F800001, 0xFFBFFFFF, 0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFF7F,
                        0x7F7FFFFF, 0x7F7FFF80, 0x00000001, 0x007FFFFF, 0x807FFF80],
                       np.uint32).view(np.float32)
    words = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([special, crafted, words.view(np.float32)])
    x = np.concatenate([x, np.zeros(-len(x) % 2, np.float32)]).reshape(2, -1)
    want = np.asarray(DeviceEngine._u24_impl(jnp.asarray(x)))
    got = TorchEngine._u24(T(x)).numpy()
    assert got.dtype == np.uint8 and got.shape == x.shape + (3,)
    np.testing.assert_array_equal(got, want)
    dec = TorchEngine.f32_from_u24(got)
    np.testing.assert_array_equal(dec.view(np.uint32),
                                  DeviceEngine.f32_from_u24(want).view(np.uint32))
    np.testing.assert_allclose(dec[0, :len(special)], special, rtol=2.0 ** -16)


# ---------------- the fused delta steps -----------------------------------
@pytest.mark.parametrize("wire", ["delta", "delta12"])
def test_run_step_delta_matches_device_engine(example, wire):
    """run_step_delta / run_step_delta12, unpacked: grid indices equal
    wherever both engines certify, the u16 norm within nuc.exact_tol + one
    step; one nuc step per call."""
    fits, jeng, wires, codes, _ = example
    teng = _engine(fits, CFG)
    name = "run_step_delta" if wire == "delta" else "run_step_delta12"
    for b, c in zip(wires[wire], codes):
        w = b.delta if wire == "delta" else b.buf
        nib = jdata.pack_nibble_codes(c)
        want = np.asarray(getattr(jeng, name)(jnp.asarray(w), jnp.asarray(nib)))
        got = getattr(teng, name)(T(w), T(nib)).numpy()
        assert got.shape == want.shape and got.dtype == np.uint8
        (ji, jc, jn, jq), (ti, tc, tn, tq) = jeng.unpack_run(want), teng.unpack_run(got)
        both = jc & tc
        assert both.mean() > 0.5
        for ch in range(3):
            np.testing.assert_array_equal(ti[:, ch][both], ji[:, ch][both])
        assert (np.abs(tn - jn) <= TOL + np.maximum(jq, tq)[:, None]).all()
    assert teng.steps == len(codes)


def test_fused_steps_print_one_set_of_bytes(example):
    """On the same windows run_step_delta12, run_step_delta, run_step_pool
    and run_step_pool2 give equal bytes (one integer raster, equal nibble
    and 2-bit bias rows), whose two halves are the pool wire's standalone
    occ and nuc steps."""
    fits, _, wires, codes, _ = example
    teng = _engine(fits, CFG)
    n_occ = 2 * teng.core + (teng.core + 3) // 4
    assert len(wires["pool"]) == len(wires["delta12"]) == len(codes) > 1
    for d, d12, p, c in zip(wires["delta"], wires["delta12"], wires["pool"], codes):
        assert list(p.meta) == list(d12.meta) == list(d.meta)
        nib = jdata.pack_nibble_codes(c)
        packed2, esc, ok = jdata.pack_2bit_codes(c)
        assert ok
        outs = {"delta12": teng.run_step_delta12(d12.buf, nib),
                "delta": teng.run_step_delta(d.delta, nib),
                "pool": teng.run_step_pool(p.pool, p.table, nib, p.emax),
                "pool2": teng.run_step_pool2(p.pool, p.table, packed2, esc, p.emax)}
        for k, v in outs.items():
            assert torch.equal(v, outs["delta12"]), k
        assert torch.equal(outs["pool"][:, :n_occ],
                           teng.occ_step_pool_p2(p.pool, p.table, p.emax))
        assert torch.equal(outs["pool"][:, n_occ:],
                           teng.nuc_step_pool_seq_m16(p.pool, p.table, nib, p.emax))


# ---------------- use_pallas --------------------------------------------
@pytest.mark.parametrize("conv", CONV_ROUTES)
def test_use_pallas_takes_k2_on_every_route(example, monkeypatch, conv):
    """use_pallas=True: every nuc form, the fused step and the float
    tracks call K2 once per call (and K1 never) whatever the route, with
    the bytes of the default "diag" engine."""
    fits, _, wires, codes, _ = example
    fs, mix = fits["torch"]
    cfg = port_config(dataclasses.replace(
        CFG, window=dataclasses.replace(CFG.window, conv=conv)))
    eng = TorchEngine(cfg, mix, fs, pwm=TPWM.default(), device="cpu", use_pallas=True)
    ref = _engine(fits, CFG)
    db, nib = T(wires["delta"][0].delta), T(jdata.pack_nibble_codes(codes[0]))
    names = [f"nuc_step_delta_seq_{s}" for s in ("m", "m16", "m24", "c2", "c")]
    names += ["run_step_delta", "nuc_step_delta_seq"]
    want = {n: getattr(ref, n)(db, nib) for n in names}
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
    for n in names:
        got = getattr(eng, n)(db, nib)
        if isinstance(got, tuple):
            assert all(torch.equal(x, y) for x, y in zip(got, want[n])), n
        else:
            assert torch.equal(got, want[n]), n
    assert calls == {"k1": 0, "k2": len(names)} and eng.steps == len(names)


# ---------------- the dry run's chained-delta12 block ---------------------
@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_runs_the_chained_delta12_block(n):
    """run_step_delta12 at core 1024 over n CPU shards: the bytes of one
    device (the CPU plain path's bits do not depend on the shard), and the
    pool wires print them (the dry run raises otherwise)."""
    d = dryrun_multichip(n, device="cpu")["delta12"]
    assert d == {"batch": 64, "bytes_equal": True, "idx_err": 0, "norm_err": 0.0}


def test_dryrun_multichip_raises_when_a_pool_wire_differs(monkeypatch):
    real = TorchEngine.run_step_pool

    def flipped(self, *a):
        out = real(self, *a)
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(TorchEngine, "run_step_pool", flipped)
    with pytest.raises(AssertionError, match="pool wire output != delta12"):
        dryrun_multichip(2, device="cpu")
