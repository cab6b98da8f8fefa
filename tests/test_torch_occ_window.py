"""K3 (nucleoatac_torch/ops/occ_window.py): the wire-v8 occ kernel.

  * on any machine: the wrapper refuses what the kernel does not take (a
    grid past 128, a dtype, a device), and
    occupancy_packed2 on the CPU keeps its torch route (no launch);
  * on a card (marked cuda; skips here): K3 and its plain version
    (ops/occupancy.py :: packed2_from_proj, the torch form of the same
    steps) on the same float32 projection and column counts give the same
    wire-v8 bytes, at the main path's shapes, at G = 128, 16 and 1, at
    flanks 2, 30 and 150, at a core that is not a multiple of 4, at a batch
    and a core that fill no tile, with windows that leave the raster,
    on both memory layouts of the projection, and on batches that hold
    empty windows, exact ties in the LL surface and CI deltas over 31.

This file imports no JAX, so the card tests run where JAX is missing:
python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_occ_window.py
"""
import zlib

import numpy as np
import pytest
import torch

from nucleoatac_torch.config import OccParams, RunConfig
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.ops import occ_window as k3
from nucleoatac_torch.ops.occupancy import (
    occupancy_packed2,
    occupancy_packed2_plain,
    packed2_from_proj,
    projection_and_counts,
)

TOL = OccParams().exact_tol


def _designed(B, G, W, flank, seed, contiguous=False):
    """[B, G, W] projection terms whose window sums are exact in float64
    (multiples of 2^-12 below 2^11, so every partial sum of a window fits
    in 53 bits): ties happen as in exact arithmetic. Each window is one of: small random integers (ties in the
    argmax and at the CI threshold), a surface flat in g (every g ties, CI
    deltas past 31), a quantized parabola in g of random width (CI deltas
    on both sides of 31). Column counts: integers with runs of zeros
    longer than a window, so some core positions are empty."""
    rng = np.random.default_rng(seed)
    proj = np.empty((B, G, W), np.float32)
    g = np.arange(G)[:, None]
    for b in range(B):
        kind = b % 3
        if kind == 0:
            proj[b] = -rng.integers(0, 3, size=(G, W))
        elif kind == 1:
            proj[b] = -rng.integers(0, 4, size=(1, W))
        else:
            half = rng.uniform(3, 60)  # CI half-width in grid steps
            curv = 1.92 / (2 * flank + 1) / half ** 2
            c = rng.uniform(0, G - 1)
            proj[b] = np.round(-curv * (g - c) ** 2 * 4096) / 4096 - rng.integers(0, 2, size=(1, W))
    counts = rng.integers(0, 3, size=(B, W)).astype(np.float32)
    for b in range(B):
        lo = rng.integers(0, W)
        counts[b, lo:lo + int(rng.integers(2 * flank + 2, 4 * flank + 40))] = 0
    proj_t = torch.from_numpy(proj)
    if not contiguous:  # the SGEMM's layout: a [B, G, W] view of [B, W, G]
        proj_t = proj_t.transpose(1, 2).contiguous().transpose(1, 2)
    return proj_t, torch.from_numpy(counts)


def _realistic(B, W, seed):
    """The main path's inputs: f32 counts [B, S, W] of fragments drawn as
    the profiler draws them (about 300 to 3,000 per window, some windows
    with a stretch left empty) and the fitted log-mixture table."""
    cfg = RunConfig()
    s = np.arange(cfg.sizes.lower, cfg.sizes.upper, dtype=np.float64)
    hist = (2e4 * np.exp(-s / 45.0)
            + 1.5e4 * np.exp(-0.5 * ((s - 147) / 20) ** 2)).astype(np.int64)
    fs = FragmentSizes(cfg.sizes.lower, cfg.sizes.upper, hist)
    mix = FragmentMixDistribution(cfg.sizes.lower, cfg.sizes.upper).fit(fs)
    lm = torch.as_tensor(np.asarray(mix.log_mix_table(cfg.occ), np.float32))
    rng = np.random.default_rng(seed)
    S = cfg.sizes.upper - cfg.sizes.lower
    mat = np.zeros((B, S, W), np.float32)
    for b in range(B):
        n = int(rng.integers(300, 3000))
        mids = rng.integers(0, W, size=n)
        sizes = np.clip(np.concatenate([rng.normal(147, 20, n // 2),
                                        rng.exponential(45, n - n // 2) + 20]), 1, 250)
        keep = ~((mids > 300) & (mids < 300 + 200 * (b % 2)))
        np.add.at(mat[b], ((sizes[keep] - cfg.sizes.lower).astype(np.int64), mids[keep]), 1.0)
    return torch.from_numpy(mat), lm


def _hold_bytes(got, want, core, exact):
    """Equal wire-v8 bytes; where they are not and ``exact`` is False (a
    sum whose float64 rounding may differ from torch's order), every
    position both certify equal, and the rest reported."""
    if torch.equal(got, want):
        return
    assert not exact, "K3's bytes differ from the plain version's on exact sums"
    g, w = got.cpu().numpy(), want.cpu().numpy()
    B = g.shape[0]

    def fields(x):
        hib = x[:, 2 * core:]
        hi2 = np.stack([(hib >> (2 * q)) & 3 for q in range(4)], axis=2).reshape(B, -1)
        return x[:, :core], x[:, core:2 * core], hi2[:, :core]

    (g0, g1, g2), (w0, w1, w2) = fields(g), fields(w)
    both = ((g0 >> 7) & (w0 >> 7)).astype(bool)
    for a, b in ((g0, w0), (g1, w1), (g2, w2)):
        np.testing.assert_array_equal(a[both], b[both])
    differ = (g0 != w0) | (g1 != w1) | (g2 != w2)
    print(f"K3 vs plain: {int(differ.sum())} of {differ.size} positions differ, "
          "none certified by both")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K3 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("change,err", [
    ({"G": 129}, ValueError), ({"proj_dtype": torch.float64}, TypeError),
    ({"counts_dtype": torch.float64}, TypeError), ({"device": "cpu"}, ValueError),
    ({"device": "meta"}, ValueError)])
def test_occ_window_refuses_what_the_kernel_does_not_take(change, err):
    """Raised before any launch, on any machine: a grid past the 7-bit
    index, a dtype, a device other than a card (the kernel has no CPU
    mode)."""
    B, G, W = 2, change.get("G", 8), 64
    dev = change.get("device", "cpu")
    proj = torch.zeros((B, G, W), dtype=change.get("proj_dtype", torch.float32), device=dev)
    counts = torch.zeros((B, W), dtype=change.get("counts_dtype", torch.float32), device=dev)
    n0 = k3.LAUNCHES
    with pytest.raises(err):
        k3.occ_window(proj, counts, 4, 8, 32, 1.92, TOL)
    assert k3.LAUNCHES == n0


def test_occupancy_packed2_keeps_its_torch_route_on_the_cpu():
    """On the CPU occupancy_packed2 is its plain version, bit for bit, and
    launches nothing; packed2_from_proj on projection_and_counts is
    occupancy_packed2's card route in torch ops."""
    mat, lm = _realistic(2, 512, seed=5)
    n0 = k3.LAUNCHES
    got = occupancy_packed2(mat, lm, 60, 128, 256, 1.92, TOL)
    assert torch.equal(got, occupancy_packed2_plain(mat, lm, 60, 128, 256, 1.92, TOL))
    assert k3.LAUNCHES == n0
    pc = projection_and_counts(mat, lm)
    assert torch.equal(pc[:, -1], mat.sum(dim=1))  # the counts' row is exact
    card_route = packed2_from_proj(pc[:, :-1], pc[:, -1], 60, 128, 256, 1.92, TOL)
    assert card_route.shape == got.shape == (2, 2 * 256 + 64)
    # the card route's f32 projection picks the CPU route's grid values
    # wherever both certify
    both = (card_route[:, :256] >> 7).bool() & (got[:, :256] >> 7).bool()
    assert both.float().mean() > 0.5
    assert torch.equal(card_route[:, :256][both], got[:, :256][both])


CARD_CASES = {
    # name: (B, G, W, core_lo, core, flank, ci_drop, inputs)
    "cell_realistic": (64, 101, 1536, 256, 1024, 60, 1.92, "realistic"),
    "cell_designed": (64, 101, 1536, 256, 1024, 60, 2.0, "designed"),
    "grid128": (8, 128, 768, 128, 512, 60, 1.92, "designed"),
    "grid16_contiguous": (8, 16, 768, 128, 512, 60, 2.0, "designed_contiguous"),
    "grid1": (4, 1, 512, 64, 384, 60, 1.92, "designed"),
    "flank2": (8, 101, 512, 64, 384, 2, 2.0, "designed"),  # 5 terms: no shared middle
    "flank30": (8, 101, 768, 128, 512, 30, 1.92, "designed"),
    "flank150": (8, 101, 1024, 150, 724, 150, 2.0, "designed_contiguous"),
    "core1021": (8, 101, 1536, 256, 1021, 60, 1.92, "designed"),
    "b3_core200_edges": (3, 101, 300, 10, 200, 60, 2.0, "designed"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_occ_window_kernel_matches_plain(case):
    """K3 against packed2_from_proj on the card on the same inputs: equal
    bytes (on exact sums always; on the main path's sums, equal wherever
    both certify, the rest reported), one launch per call."""
    dev = _need_cuda()
    B, G, W, lo, core, flank, ci_drop, inputs = CARD_CASES[case]
    if inputs == "realistic":
        mat, lm = _realistic(B, W, seed=7)
        mat, lm = mat.to(dev), lm.to(dev)
        pc = projection_and_counts(mat, lm)
        proj, counts = pc[:, :G], pc[:, G]
        assert torch.equal(counts, mat.sum(dim=1))
        assert torch.equal(occupancy_packed2(mat, lm, flank, lo, core, ci_drop, TOL),
                           k3.occ_window(proj, counts, flank, lo, core, ci_drop, TOL))
    else:
        proj, counts = _designed(B, G, W, flank, seed=zlib.crc32(case.encode()),
                                 contiguous=inputs.endswith("contiguous"))
        proj, counts = proj.to(dev), counts.to(dev)
    n0 = k3.LAUNCHES
    got = k3.occ_window(proj, counts, flank, lo, core, ci_drop, TOL)
    torch.cuda.synchronize()
    assert k3.LAUNCHES == n0 + 1
    want = packed2_from_proj(proj, counts, flank, lo, core, ci_drop, TOL)
    assert got.shape == want.shape == (B, 2 * core + -(-core // 4))
    _hold_bytes(got, want, core, exact=inputs != "realistic")
    if inputs != "realistic":  # the batch holds what the case is for
        n = torch.nn.functional.pad(counts, (flank, flank)).unfold(1, 2 * flank + 1, 1)
        n = n.sum(dim=2)[:, lo:lo + core]
        cert = (want[:, :core] >> 7).bool()
        assert (n == 0).any() and cert.any()
        assert G == 1 or (~cert & (n > 0)).any()  # one grid value: nothing ties
