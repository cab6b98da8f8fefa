"""The port's float-track step API against the JAX package (CPU; conftest
gives JAX 8 virtual devices): TorchEngine's occ_step*/nuc_step*/full_step*
on the dense, frags, packed, packed_seq and delta(_seq) entry points
against DeviceEngine's, the three xcorr routes, parallel/mesh.py ::
sharded_full_step over k CPU devices (bit-equal to one device, and held to
the reference's sharded_full_step on its 8-device mesh), and
nucleoatac_torch/entry.py (the counterparts of __graft_entry__.py's
entry() and dryrun_multichip, tests/test_parallel.py).

Bars, per field:
  * OccTracks occ, lower, upper: equal wherever both packages' margin and
    ci_margin exceed occ.exact_tol (test_torch_transfer's bar: a
    certified pick is the float64 pick on both sides); margin and
    ci_margin within occ.exact_tol; n exact.
  * NucTracks norm and norm_smooth within nuc.exact_tol
    (test_torch_engine's bar for the f32 norm); signal, lr and fuzz at
    parity.NONEXACT_STAT_TOL, the JAX package's bars against its float64
    mirror (test_torch_transfer's _check_nuc5); n exact.
The reference runs as its own tests run it: DeviceEngine's default XLA
route (use_pallas False, conv_mode "diag")."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.models import data as jdata
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.parallel import make_mesh
from nucleoatac_tpu.parallel import sharded_full_step as jax_sharded_full_step
from nucleoatac_torch.core.pwm import PWM as TPWM
from nucleoatac_torch.entry import MIRROR_TOL, dryrun_multichip, entry
from nucleoatac_torch.models.engine import CONV_ROUTES, NucTracks, OccTracks, TorchEngine
from nucleoatac_torch.ops.nuc_scores import nuc_scores
from nucleoatac_torch.ops.smooth import gauss_smooth_batch
from nucleoatac_torch.parallel import sharded_full_step
from nucleoatac_torch.parity import NONEXACT_STAT_TOL
from test_torch_engine import _tiny_config

B = 8  # windows per batch: 8 virtual JAX devices; k = 1, 2, 4, 8 torch shards
F = 640  # fragment slots per window; each row leaves some as padding
STAT_TOL = {"signal": NONEXACT_STAT_TOL[9], "lr": NONEXACT_STAT_TOL[7],
            "fuzz": NONEXACT_STAT_TOL[10]}


@pytest.fixture(scope="module")
def engines():
    """The reference's DeviceEngine and the port's TorchEngine on each xcorr
    route, from _tiny_config's size histogram at batch 8."""
    cfg, fs, mix = _tiny_config(batch=B)
    tcfg, tfs, tmix = _tiny_config(batch=B, port=True)
    jeng = DeviceEngine(cfg, mix, fs, pwm=PWM.default())
    tengs = {c: TorchEngine(tcfg, tmix, tfs, pwm=TPWM.default(), device="cpu", conv=c)
             for c in CONV_ROUTES}
    return jeng, tengs


@pytest.fixture(scope="module")
def wires(engines):
    """Seeded windows on every wire: nucleosome-sized fragments about six
    dyads per window plus short and background fragments, sorted by
    midpoint (the delta wire needs that), 300 to 640 per row; sequence
    codes with N bases; a log-bias row."""
    jeng, _ = engines
    cfg, W = jeng.cfg, jeng.width
    rng = np.random.default_rng(9)
    mids = np.zeros((B, F), np.int32)
    sizes = np.zeros((B, F), np.int32)
    valid = np.zeros((B, F), bool)
    counts = rng.integers(300, F + 1, B)
    for b, n in enumerate(counts):
        n_nuc = int(0.6 * n)
        dyads = rng.integers(120, W - 120, 6)
        m = np.concatenate([rng.choice(dyads, n_nuc) + rng.normal(0, 10, n_nuc).astype(int),
                            rng.integers(0, W, n - n_nuc)])
        s = np.concatenate([np.clip(rng.normal(156, 12, n_nuc), 120, 250),
                            np.clip(rng.exponential(45, n - n_nuc) + 24, 24, 250)])
        m = np.clip(m, 0, W - 1)
        order = np.argsort(m, kind="stable")
        mids[b, :n], sizes[b, :n], valid[b, :n] = m[order], s[order].astype(int), True
    packed = np.zeros((B, F), np.int32)
    for b, n in enumerate(counts):
        jdata.pack_fragments(mids[b, :n], sizes[b, :n], packed, b)
    db = np.zeros((B, F + W // 255 + 1, 2), np.uint8)
    jdata.encode_delta_batch(mids, sizes, db, counts)
    codes = rng.integers(0, 4, (B, jeng.seq_codes_width())).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    dense = np.stack([jdata.rasterize_host(mids[b, :n], sizes[b, :n], cfg.sizes.lower,
                                           cfg.sizes.upper, W) for b, n in enumerate(counts)])
    log_bias = rng.normal(0, 0.3, (B, W)).astype(np.float32)
    return {"frags": [mids, sizes, valid], "packed": [packed], "delta": [db],
            "dense": [dense], "log_bias": log_bias, "codes": codes,
            "nib": jdata.pack_nibble_codes(codes)}


# entry point -> (wire, the nuc branch's last argument or None for occ)
STEPS = {
    "occ_step": ("dense", None),
    "occ_step_frags": ("frags", None),
    "occ_step_packed": ("packed", None),
    "occ_step_delta": ("delta", None),
    "nuc_step": ("dense", "log_bias"),
    "nuc_step_frags": ("frags", "log_bias"),
    "nuc_step_packed": ("packed", "log_bias"),
    "nuc_step_packed_seq": ("packed", "codes"),
    "nuc_step_delta": ("delta", "log_bias"),
    "nuc_step_delta_seq": ("delta", "nib"),
    "full_step": ("dense", "log_bias"),
    "full_step_frags": ("frags", "log_bias"),
    "full_step_packed": ("packed", "log_bias"),
    "full_step_packed_seq": ("packed", "codes"),
    "full_step_delta_seq": ("delta", "nib"),
}


def _args(wires, name):
    wire, last = STEPS[name]
    return wires[wire] + ([wires[last]] if last else [])


def _np(t):
    return [np.asarray(x) for x in t]


def check_occ(cfg, got, want):
    """OccTracks against the reference's at the module's bars."""
    assert type(got) is OccTracks and got._fields == want._fields
    g, w = _np(got), _np(want)
    g, w = OccTracks(*g), OccTracks(*w)
    tol = cfg.occ.exact_tol
    np.testing.assert_array_equal(g.n, w.n)
    both = (g.margin > tol) & (g.ci_margin > tol) & (w.margin > tol) & (w.ci_margin > tol)
    assert both.mean() > 0.5
    for f in ("occ", "lower", "upper"):
        np.testing.assert_array_equal(getattr(g, f)[both], getattr(w, f)[both], f)
    for f in ("margin", "ci_margin"):
        assert np.abs(getattr(g, f) - getattr(w, f)).max() <= tol, f
    assert (g.occ[g.n > 0] > 0).any()  # non-vacuous


def check_nuc(cfg, got, want):
    """NucTracks against the reference's at the module's bars."""
    assert type(got) is NucTracks and got._fields == want._fields
    g, w = NucTracks(*_np(got)), NucTracks(*_np(want))
    assert all(x.dtype == np.float32 for x in g)
    np.testing.assert_array_equal(g.n, w.n)
    for f in ("norm", "norm_smooth"):
        assert np.abs(getattr(g, f) - getattr(w, f)).max() <= cfg.nuc.exact_tol, f
    for f, (rtol, atol) in STAT_TOL.items():
        np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=rtol, atol=atol,
                                   err_msg=f)
    assert np.abs(w.norm).max() > 1.0 and np.abs(w.lr).max() > 1.0  # non-vacuous


def check(cfg, name, got, want):
    if name.startswith("occ"):
        check_occ(cfg, got, want)
    elif name.startswith("nuc"):
        check_nuc(cfg, got, want)
    else:
        assert type(got) is tuple and len(got) == 2
        check_occ(cfg, got[0], want[0])
        check_nuc(cfg, got[1], want[1])


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_device_engine(engines, wires, name):
    """Each entry point on its wire against DeviceEngine's, on the default
    route (K2's plain version); one nuc step counted per nuc or full call."""
    jeng, tengs = engines
    teng = tengs["diag"]
    args = _args(wires, name)
    steps = teng.steps
    got = getattr(teng, name)(*args)
    want = getattr(jeng, name)(*map(jnp.asarray, args))
    check(jeng.cfg, name, got, want)
    assert teng.steps - steps == (0 if name.startswith("occ") else 1)


@pytest.mark.parametrize("conv", ["diag_pallas", "direct"])
def test_full_step_frags_routes_match_device_engine(engines, wires, conv):
    """full_step_frags on the K1 route (diag_pallas: two K1 plain versions
    and the epilogue) and on the direct route (two conv1d) against the
    reference's default route: the same function at the same bars."""
    jeng, tengs = engines
    args = _args(wires, "full_step_frags")
    got = tengs[conv].full_step_frags(*args)
    check(jeng.cfg, "full_step_frags", got, jeng.full_step_frags(*map(jnp.asarray, args)))


def test_steps_take_tensors_and_agree_across_wires(engines, wires):
    """The same fragments on every wire give one raster, so the tracks
    are bit-equal whatever the wire; tensors and host arrays alike."""
    _, tengs = engines
    teng = tengs["diag"]
    lb = wires["log_bias"]
    want = teng.full_step_frags(*map(torch.from_numpy, wires["frags"]), torch.from_numpy(lb))
    for wire in ("dense", "packed"):
        step = teng.full_step if wire == "dense" else teng.full_step_packed
        got = step(*wires[wire], lb)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert torch.equal(x, y), wire
    seq = teng.full_step_packed_seq(*wires["packed"], wires["codes"])
    nib = teng.full_step_delta_seq(*wires["delta"], wires["nib"])
    for a, b in zip(seq, nib):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("conv", CONV_ROUTES)
def test_scores_callers_keep_their_bytes(engines, wires, conv):
    """_scores now returns n too: _nucm, _nuc5 and _nucm16 give the bytes of
    their former formula (K2's [B, 5, W] channels, or the epilogue of the
    other routes, before n joined), and nuc_step's fields are _nuc5's
    channels with n the kernel's fifth channel."""
    jeng, tengs = engines
    teng = tengs[conv]
    mat = teng._raster_frags(*map(torch.from_numpy, wires["frags"]))
    lb = torch.from_numpy(wires["log_bias"])
    norm, signal, lr, fuzz, n = teng._scores(mat, lb)
    if conv == "diag":
        vlo = teng.cfg.vmat.lower - teng.cfg.sizes.lower
        k2 = nuc_scores(mat[:, vlo:], teng._bias(lb), *teng.tables["_diag_kernels"],
                        teng.cfg.nuc.var_floor)
        for i, t in enumerate((norm, signal, lr, fuzz, n)):
            assert torch.equal(t, k2[:, i])
    smooth = gauss_smooth_batch(norm, teng.tables["smooth_kernel"])
    assert torch.equal(teng._nuc5(mat, lb), torch.stack([norm, smooth, signal, lr, fuzz], 1))
    m = teng.smooth_margin()
    nucm = norm[:, teng.core_lo - m: teng.core_lo + teng.core + m]
    assert torch.equal(teng._nucm(mat, lb), nucm)
    assert torch.equal(teng._nucm16(mat, lb), teng._u16(nucm))
    tracks = teng.nuc_step(mat, lb)
    assert all(torch.equal(a, b) for a, b in
               zip(tracks, (norm, smooth, signal, lr, fuzz, n)))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jeng.nuc_step(
        jnp.asarray(mat.numpy()), jnp.asarray(wires["log_bias"])).n))


# ---------------- sharding ----------------------------------------------
def test_shard_gathers_named_tuples_in_window_order():
    """shard gathers a NamedTuple field by field (nested tuples too) in
    window order, keeping the types, and a tensor as before."""
    tcfg, tfs, tmix = _tiny_config(batch=B, port=True)
    x = torch.arange(B * 3, dtype=torch.float32).reshape(B, 3)

    def chain(a):
        return NucTracks(a, a + 1, a * 2, a[:, :1], (a - 1, a[:, 1:]), a.sum(1))

    want = chain(x)
    for k in (1, 2, 4, 8):
        eng = TorchEngine(tcfg, tmix, tfs, pwm=TPWM.default(), device=["cpu"] * k)
        got = eng.shard(chain, x.numpy())
        assert type(got) is NucTracks and type(got.fuzz) is tuple
        flat = list(got[:4]) + list(got.fuzz) + [got.n]
        for a, b in zip(flat, list(want[:4]) + list(want.fuzz) + [want.n]):
            assert torch.equal(a, b), k
        assert torch.equal(eng.shard(lambda a: a * 3, x), x * 3)


@pytest.fixture(scope="module")
def sharded_engines():
    tcfg, tfs, tmix = _tiny_config(batch=B, port=True)
    return {k: TorchEngine(tcfg, tmix, tfs, pwm=TPWM.default(), device=["cpu"] * k)
            for k in (2, 4, 8)}


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_full_step_is_bit_equal_and_meets_the_mesh(engines, wires, sharded_engines, k):
    """sharded_full_step over k CPU devices: every field the bits of one
    device, k nuc steps per call; against the reference's
    sharded_full_step on its 8-device mesh at the module's bars."""
    jeng, tengs = engines
    eng = sharded_engines[k]
    args = wires["frags"] + [wires["log_bias"]]
    one = tengs["diag"].full_step_frags(*args)
    steps = eng.steps
    got = sharded_full_step(eng)(*args)
    assert eng.steps - steps == k
    for a, b in zip(got, one):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    want = jax_sharded_full_step(jeng, make_mesh(8))(*args)
    jax.block_until_ready(want)
    check(jeng.cfg, "full_step_frags", got, want)


def test_reference_shards_the_step_over_its_mesh(engines, wires):
    jeng, _ = engines
    occ, _ = jax_sharded_full_step(jeng, make_mesh(8))(*wires["frags"], wires["log_bias"])
    assert len(occ.occ.sharding.device_set) == 8


# ---------------- entry.py ----------------------------------------------
def test_entry_runs_and_gives_finite_tracks():
    """entry(): the fused step and its example tensors on the device asked
    for; every track finite, one window pair of the reference's shape."""
    fn, args = entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    occ, nuc = fn(*args)
    for t in (*occ, *nuc):
        assert t.shape == (2, fn.__self__.width) and torch.isfinite(t).all()
    assert float(nuc.norm.abs().max()) > 0


def test_entry_matches_the_reference_entry():
    """entry() against __graft_entry__.entry(): the same example arguments
    and the fused step's tracks at the module's bars."""
    from __graft_entry__ import entry as jax_entry

    fn, args = entry(device="cpu")
    jfn, jargs = jax_entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    check(fn.__self__.cfg, "full_step_frags", fn(*args), jax.jit(jfn)(*jargs))


def test_dryrun_multichip_8_on_cpu():
    """dryrun_multichip(8) over eight CPU shards: the summed histogram, the
    sharded steps on both kernel routes and the K1 route's norm against the
    float64 mirror."""
    out = dryrun_multichip(8, device="cpu")
    assert out["devices"] == [torch.device("cpu")] * 8
    assert int(out["hist"].sum()) == 8 * 512
    assert 0 < out["mirror_err"] <= MIRROR_TOL


@pytest.mark.parametrize("n,device", [(2, ["cpu"] * 3), (3, ["cpu"] * 3)])
def test_dryrun_multichip_takes_a_device_list(n, device):
    """A list names the devices; its length must be n."""
    if n != len(device):
        with pytest.raises(ValueError, match="dry run over"):
            dryrun_multichip(n, device=device)
    else:
        assert dryrun_multichip(n, device=device)["devices"] == [torch.device("cpu")] * n


def test_dryrun_multichip_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    # "cuda" names the visible cards, of which there are none
    with pytest.raises(ValueError, match="dry run over 2 devices"):
        dryrun_multichip(2)
