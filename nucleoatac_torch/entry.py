"""The port's entry points: the fused occ+nuc step on a tiny engine, and a
dry run of the sharded step over n devices.

Counterparts of the JAX package's ``__graft_entry__.py``, with the same
synthetic size histogram, core and seeds: ``entry()`` hands back the
flagship step (TorchEngine.full_step_frags) with example tensors on the
device; ``dryrun_multichip(n)`` shards the size histogram and the fused
step over n devices and holds the K1 route's norm against the float64
mirror, then runs the chained delta12 step at core 1024 over the n
devices against one and the pool wires against it. Both run on the card
unless the caller passes ``device="cpu"``; neither falls back to the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from nucleoatac_torch import mirror
from nucleoatac_torch.config import RunConfig, WindowParams
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.core.pwm import PWM
from nucleoatac_torch.models.data import (
    _bucket,
    _encode_chunk_stream12,
    delta12_entry_capacity,
    encode_delta12_batch,
    pack_2bit_codes,
    pack_nibble_codes,
)
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.parallel.mesh import (
    local_devices,
    sharded_full_step,
    sharded_size_histogram,
)

# the K1 route's max |norm - f64| the dry run accepts (the reference's bar)
MIRROR_TOL = 1e-3


def _tiny_engine(core: int = 256, batch: int = 2, device="cuda", conv: str = "diag"):
    """(cfg, TorchEngine) from a deterministic synthetic size histogram
    (exponential + gaussian), the default PWM, on ``device`` (one device
    or a list to shard over)."""
    cfg = RunConfig(window=WindowParams(core=core, batch=batch, conv=conv))
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    counts = (
        2e4 * np.exp(-s / 45.0) + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)
    ).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, counts)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    return cfg, TorchEngine(cfg, mix, fs, pwm=PWM.default(), device=device)


def _example_args(engine, batch: int, n_frags: int = 512):
    """Padded fragment lists (mids, sizes int32, valid bool [B, F]) and a
    per-bp f32 log-bias row [B, W], host arrays from seed 0."""
    rng = np.random.default_rng(0)
    W = engine.width
    mids = rng.integers(0, W, size=(batch, n_frags)).astype(np.int32)
    sizes = rng.integers(20, 250, size=(batch, n_frags)).astype(np.int32)
    valid = np.ones((batch, n_frags), dtype=bool)
    log_bias = (0.3 * rng.standard_normal((batch, W))).astype(np.float32)
    return mids, sizes, valid, log_bias


def entry(device="cuda"):
    """(step, args): the fused occ+nuc window step (TorchEngine ::
    full_step_frags: rasterization, occupancy and the template xcorr on
    the K2 kernel) and its example arguments as tensors on ``device``;
    ``step(*args)`` gives (OccTracks, NucTracks)."""
    _, engine = _tiny_engine(device=device)
    args = tuple(torch.from_numpy(a).to(engine.device) for a in _example_args(engine, 2))
    return engine.full_step_frags, args


def _devices(n_devices: int, device) -> list:
    """"cuda" without an index: the first n visible cards (raises when
    fewer are visible); a list: taken as given; any other device: n
    shards on it."""
    if isinstance(device, (list, tuple)):
        devs = list(device)
    elif torch.device(device) == torch.device("cuda"):
        devs = local_devices(n_devices)
    else:
        devs = [device] * n_devices
    if len(devs) != n_devices:
        raise ValueError(f"dry run over {n_devices} devices, got {devs}")
    return devs


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded step over n devices, one window each: the size
    histogram summed over per-device bincounts against numpy's, the fused
    step on the K2 route with the reference's shape checks, and the fused
    step on the K1 route ("diag_pallas") with each window's core norm
    within MIRROR_TOL of the float64 mirror; then _chained_delta12.
    Devices: see _devices. Raises on any failure; returns {"devices",
    "hist", "mirror_err", "delta12"}."""
    devs = _devices(n_devices, device)
    cfg, engine = _tiny_engine(batch=n_devices, device=devs)
    mids, sizes, valid, log_bias = _example_args(engine, n_devices)

    # the collective: per-device histograms of each shard's windows, summed
    lo, up = cfg.sizes.lower, cfg.sizes.upper
    hist = engine.shard(lambda s, v: sharded_size_histogram(s, v, lo, up)[None],
                        sizes, valid).sum(dim=0)
    keep = valid & (sizes >= lo) & (sizes < up)
    want = np.bincount(sizes[keep] - lo, minlength=up - lo)
    if hist.shape != (up - lo,) or not np.array_equal(hist.cpu().numpy(), want):
        raise AssertionError("sharded size histogram != bincount")

    # the sharded fused step (windows split over the devices, tables
    # replicated, tracks gathered on the first)
    occ, nuc = sharded_full_step(engine)(mids, sizes, valid, log_bias)
    if occ.occ.shape != (n_devices, engine.width) or \
            nuc.norm.shape != (n_devices, engine.width):
        raise AssertionError(f"sharded step shapes {occ.occ.shape}, {nuc.norm.shape}")

    # the K1 route under the same sharding, against the float64 mirror
    _, eng_dp = _tiny_engine(batch=n_devices, device=devs, conv="diag_pallas")
    _, nuc_dp = sharded_full_step(eng_dp)(mids, sizes, valid, log_bias)
    n_dp = nuc_dp.norm.cpu().numpy()
    core = slice(eng_dp.core_lo, eng_dp.core_hi)
    vmat64 = np.asarray(eng_dp.vmat.mat, np.float64)
    err = 0.0
    for b in range(n_devices):
        F = mirror.rasterize(mids[b], sizes[b], cfg.vmat.lower, cfg.vmat.upper,
                             eng_dp.width).astype(np.float64)
        b0 = mirror.bias_mat(log_bias[b].astype(np.float64), eng_dp.size_probs64,
                             cfg.vmat.lower, cfg.vmat.upper, eng_dp.core_lo,
                             eng_dp.core_hi)
        norm64 = mirror.nuc_scores(F, b0, vmat64, cfg.nuc.v_floor,
                                   cfg.nuc.var_floor).norm
        e = float(np.max(np.abs(n_dp[b, core] - norm64[core])))
        if not e <= MIRROR_TOL:
            raise AssertionError(f"diag_pallas sharded norm deviates from the f64 "
                                 f"mirror: row {b} max abs diff {e}")
        err = max(err, e)
    return {"devices": engine.devices, "hist": hist, "mirror_err": err,
            "delta12": _chained_delta12(devs)}


def _pool_wire(mids: np.ndarray, sizes: np.ndarray):
    """The wire-v7 pool of sorted window-relative fragments, one window per
    row: (pool, table, emax), each window's records padded to an even
    count, as __graft_entry__.py builds it."""
    nib_parts, sz_parts, rows = [], [], []
    pos, emax = 0, 1
    for m, s in zip(mids, sizes):
        rn, rsz, _, _ = _encode_chunk_stream12(m, s, 0)
        rows.append((pos, len(rn), 0))
        emax = max(emax, len(rn))
        if len(rn) & 1:
            rn, rsz = np.append(rn, np.uint8(0)), np.append(rsz, np.uint8(0))
        nib_parts.append(rn)
        sz_parts.append(rsz)
        pos += len(rn)
    cap = _bucket(pos, minimum=1024)
    nib, sz = np.zeros(cap, np.uint8), np.zeros(cap, np.uint8)
    nib[:pos], sz[:pos] = np.concatenate(nib_parts), np.concatenate(sz_parts)
    pool = np.concatenate([(nib[0::2] | (nib[1::2] << 4)).astype(np.uint8), sz])
    return pool, np.asarray(rows, np.int32), _bucket(emax)


def _chained_delta12(devs: list) -> dict:
    """The reference dry run's last block: the chained run_step_delta12 at
    core 1024 (B = 64, or 8 per device where 64 does not divide) over
    ``devs`` against one device (devs[0]): decoded grid indices within 1
    and the u16 norm within 2e-5 plus two quantization steps, the
    reference's bars between two compilations. On the sharded engine
    run_step_pool and run_step_pool2 must print run_step_delta12's bytes.
    Returns {"batch", "bytes_equal" (sharded against one device),
    "idx_err", "norm_err"}."""
    n = len(devs)
    B = 64 if 64 % n == 0 else 8 * n
    cfg, eng_m = _tiny_engine(core=1024, batch=B, device=devs)
    _, eng_1 = _tiny_engine(core=1024, batch=B, device=devs[0])
    rng = np.random.default_rng(3)
    W, F = eng_m.width, 512
    mids = np.sort(rng.integers(0, W, size=(B, F)), axis=1).astype(np.int64)
    sizes = rng.integers(cfg.vmat.lower - 20, 250, size=(B, F)).astype(np.int64)
    E = delta12_entry_capacity(F, W)
    buf = np.zeros((B, E // 2 + E), np.uint8)
    encode_delta12_batch(mids, sizes, buf)
    codes = rng.integers(0, 4, size=(B, eng_m.seq_codes_width())).astype(np.uint8)
    codes[0, :7] = 4  # N bases: the escape list under the shards
    nib = pack_nibble_codes(codes)
    out_m = eng_m.run_step_delta12(buf, nib).cpu().numpy()
    out_1 = eng_1.run_step_delta12(buf, nib).cpu().numpy()
    idx_m, _, norm_m, q_m = eng_m.unpack_run(out_m)
    idx_1, _, norm_1, q_1 = eng_1.unpack_run(out_1)
    idx_err = int(np.abs(idx_m - idx_1).max())
    if idx_err > 1:
        raise AssertionError(f"sharded delta12 grid indices differ from one "
                             f"device's by {idx_err}")
    q_tol = 2.0 * float(max(q_m.max(), q_1.max(), 0.0))
    diff = np.abs(norm_m - norm_1)
    norm_err = float(diff.max())
    if not np.all(diff <= 2e-5 + q_tol + 2e-5 * np.abs(norm_1)):
        raise AssertionError(f"sharded delta12 norm differs from one device's by "
                             f"{norm_err} (two u16 steps: {q_tol})")
    # the pool wires rasterize the same counts: the same bytes
    pool, table, emax = _pool_wire(mids, sizes)
    if not np.array_equal(eng_m.run_step_pool(pool, table, nib, emax).cpu().numpy(), out_m):
        raise AssertionError("pool wire output != delta12 over the devices")
    packed2, esc, ok = pack_2bit_codes(codes)
    if not ok or not np.array_equal(
            eng_m.run_step_pool2(pool, table, packed2, esc, emax).cpu().numpy(), out_m):
        raise AssertionError("2-bit sequence wire output != delta12 over the devices")
    return {"batch": B, "bytes_equal": bool(np.array_equal(out_m, out_1)),
            "idx_err": idx_err, "norm_err": norm_err}
