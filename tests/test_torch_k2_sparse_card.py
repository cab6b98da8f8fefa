"""K2's F sums over each staged slab's nonzero list (csrc/nuc_scores.cu),
on a card (marked cuda; every case skips without one).

The kernel counts each staged F slab's nonzero cells and sums a slab with
at most kSparseMax of them from its list in float64; denser slabs take
the split-TF32 band products. Each case holds the kernel against
nuc_scores_plain (norm within nuc.exact_tol; signal, lr and fuzz at
parity.NONEXACT_STAT_TOL; n equal) and norm against float64 within
nuc.exact_tol, and the launch's slab counters against the routes a count
of the same F gives:

  * the benchmark cell's density (about 900 fragments of the nuc size range
    per 1,536-bp window): at least 90% of the slabs on the list, and every
    slab where the same share of cells is spread evenly;
  * 10 and 100 times that coverage, the dense route taking over;
  * one window with a single dense slab among sparse ones;
  * slabs of exactly kSparseMax and kSparseMax + 1 nonzero cells;
  * an all-zero F: every channel 0;
  * non-integer F values;
  * the first and last tiles' edge columns, at a width that is not a
    multiple of 4 (the 4-byte copies) on a batch-strided F;
  * two launches on the same input: equal bits.

This file imports no JAX, so the card tests run where JAX is missing:
python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_k2_sparse_card.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.vmat import VMat
from nucleoatac_torch.ops import nuc_scores as k2
from nucleoatac_torch.ops.biasmat import bias_mat_batch
from nucleoatac_torch.ops.rasterize import rasterize_batch
from nucleoatac_torch.ops.xcorr import build_kernels_diag
from nucleoatac_torch.parity import NONEXACT_STAT_TOL

CFG = RunConfig()
CSRC = Path(k2.__file__).resolve().parent.parent / "csrc"
LO, UP = CFG.vmat.lower, CFG.vmat.upper
W = CFG.window.width(CFG.occ, CFG.vmat)
HALO = CFG.window.halo(CFG.occ, CFG.vmat)
# fragments in the nuc size range per window at the benchmark cell's density
CELL_FRAGS = 900


def _constants() -> dict:
    text = (CSRC / "xcorr.cuh").read_text()
    c = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    c["SPARSE_MAX"] = int(re.search(r"constexpr int kSparseMax = (\d+);",
                                    (CSRC / "nuc_scores.cu").read_text())[1])
    return c


C = _constants()


def _need_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K2 has no CPU mode)")
    return torch.device("cuda")


def _tables(dev, dtype=torch.float32):
    tabs = build_kernels_diag(VMat.default().mat, CFG.nuc.v_floor)
    return [torch.as_tensor(t, device=dev, dtype=dtype).contiguous() for t in tabs]


def _raster(dev, B, n, seed, uniform=False, width=W) -> torch.Tensor:
    """F [B, S, width] float32 counts of n fragments per window in the nuc
    size range: sizes as the cell draws them (a nucleosomal peak at 156
    and the short fragments' tail), or uniform over the range."""
    rng = np.random.default_rng(seed)
    if uniform:
        sizes = rng.integers(LO, UP, (B, n))
    else:
        n_nuc = n * 9 // 10
        sizes = np.concatenate([
            np.clip(rng.normal(156, 14, (B, n_nuc)), LO, UP - 1),
            np.clip(LO + rng.exponential(30, (B, n - n_nuc)), LO, UP - 1)], axis=1)
    mids = rng.integers(0, width, (B, n))
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    return rasterize_batch(t(mids), t(sizes), torch.ones((B, n), dtype=torch.bool,
                                                          device=dev), LO, UP, width)


def _b0(dev, B, seed, width=W) -> torch.Tensor:
    rng = np.random.default_rng(seed + 1)
    logb = torch.as_tensor(rng.normal(0, 0.3, (B, width)).astype(np.float32), device=dev)
    q = rng.random(UP - LO)
    q = torch.as_tensor((q / q.sum()).astype(np.float32), device=dev)
    return bias_mat_batch(logb, q, LO, UP, min(HALO, width // 4), width - min(HALO, width // 4))


def _routes(fmat: torch.Tensor, K: int) -> tuple:
    """(sparse, dense) slabs of one launch as the kernel plans them: per
    window, tile of BW outputs and slab of SK size rows, the nonzero cells
    of its staged columns [j0, j0 + xcols(K)) inside the window."""
    B, S, Wd = fmat.shape
    BW, KB, SK = C["BW"], C["KB"], C["SK"]
    XC = (BW + -(-K // KB) * KB - 1 + 3) & ~3
    Sp = -(-S // SK) * SK
    nz = F.pad((fmat != 0).to(torch.int64), (0, 0, 0, Sp - S))
    cs = F.pad(nz.reshape(B, Sp // SK, SK, Wd).sum(2).cumsum(-1), (1, 0))
    j0 = torch.arange(0, Wd - K + 1, BW, device=fmat.device)
    cnt = cs[..., (j0 + XC).clamp(max=Wd)] - cs[..., j0]
    sparse = int((cnt <= C["SPARSE_MAX"]).sum())
    return sparse, cnt.numel() - sparse


def _check(fmat, b0, integer=True) -> tuple:
    """K2 on (fmat, b0) held to the plain version and float64 at the
    bars; its slab counters equal the planned routes. n equals the plain
    version's on integer counts, and is within 1e-5 of float64 on other
    values (K2 sums F's columns in float32). Returns the output and
    (sparse, dense)."""
    dev = fmat.device
    tabs = _tables(dev)
    vf = CFG.nuc.var_floor
    before = k2.slab_counts(dev)
    got = k2.nuc_scores(fmat, b0, *tabs, vf)
    after = k2.slab_counts(dev)
    routes = (after[0] - before[0], after[1] - before[1])
    assert routes == _routes(fmat, tabs[0].shape[1])
    plain = k2.nuc_scores_plain(fmat.contiguous(), b0, *tabs, vf)
    ref = k2.nuc_scores_plain(fmat.double(), b0.double(), *_tables(dev, torch.float64), vf)
    tol = CFG.nuc.exact_tol
    bars = {"norm": (0.0, tol), "signal": NONEXACT_STAT_TOL[9],
            "lr": NONEXACT_STAT_TOL[7], "fuzz": NONEXACT_STAT_TOL[10]}
    for i, ch in enumerate(k2.CHANNELS[:4]):
        rtol, atol = bars[ch]
        torch.testing.assert_close(got[:, i], plain[:, i], rtol=rtol, atol=atol,
                                   msg=lambda m, ch=ch: f"{ch} vs plain: {m}")
    if integer:
        assert torch.equal(got[:, 4], plain[:, 4]), "n differs from the plain version"
    else:
        torch.testing.assert_close(got[:, 4].double(), ref[:, 4], rtol=1e-5, atol=0.0)
    err = float((got[:, 0].double() - ref[:, 0]).abs().max())
    assert err <= tol, f"max|norm - f64| {err:.3e} > nuc.exact_tol {tol}"
    return got, routes


@pytest.mark.cuda
def test_cell_density_sums_nearly_every_slab_from_its_list():
    """The cell's fragments per window, sizes peaked at 156 (about 0.4% of
    the cells nonzero, more in the peak's size rows): at least 90% of the
    slabs on the list. The same share of cells spread evenly: every slab."""
    dev = _need_cuda()
    fmat = _raster(dev, 16, CELL_FRAGS, 1)
    _, (sparse, dense) = _check(fmat, _b0(dev, 16, 1))
    assert 9 * dense <= sparse
    even = (torch.rand(fmat.shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
            < float((fmat != 0).float().mean())).float()
    _, (sparse, dense) = _check(even, _b0(dev, 16, 1), integer=True)
    assert dense == 0


@pytest.mark.cuda
@pytest.mark.parametrize("times", [10, 100])
def test_coverage_takes_the_dense_route(times):
    """10 and 100 times the cell's fragments (peak sizes), and 100 times
    spread over every size: the band products take over where slabs
    fill; at 100 times over every size nearly every slab is dense."""
    dev = _need_cuda()
    B = 8
    fmat = _raster(dev, B, CELL_FRAGS * times, 10 + times)
    _, (sparse, dense) = _check(fmat, _b0(dev, B, 10 + times))
    assert dense > 0
    fmat = _raster(dev, B, CELL_FRAGS * times, 20 + times, uniform=True)
    _, (sparse, dense) = _check(fmat, _b0(dev, B, 20 + times))
    if times == 100:
        assert dense > 9 * sparse


@pytest.mark.cuda
def test_one_dense_slab_among_sparse_ones():
    dev = _need_cuda()
    B = 4
    fmat = _raster(dev, B, CELL_FRAGS, 3)
    fmat[1, 40:40 + C["SK"], :192] = 0.0
    before = _routes(fmat, 147)
    rng = np.random.default_rng(3)
    # columns below BW are staged by the first tile alone
    block = rng.integers(1, 4, (C["SK"], 180)).astype(np.float32)
    fmat[1, 40:40 + C["SK"], 10:190] = torch.as_tensor(block, device=dev)
    _, (sparse, dense) = _check(fmat, _b0(dev, B, 3))
    assert (sparse, dense) == (before[0] - 1, before[1] + 1)


@pytest.mark.cuda
def test_slabs_at_the_crossover():
    """The first tile's first slab holds exactly kSparseMax nonzero staged
    cells (the list), its second kSparseMax + 1 (the band products)."""
    dev = _need_cuda()
    B, K, SK, smax = 2, 147, C["SK"], C["SPARSE_MAX"]
    XC = (C["BW"] + -(-K // C["KB"]) * C["KB"] - 1 + 3) & ~3
    fmat = torch.zeros((B, UP - LO, W), device=dev)
    rng = np.random.default_rng(4)
    for r0, n in ((0, smax), (SK, smax + 1)):
        cells = torch.as_tensor(rng.choice(SK * XC, n, replace=False), device=dev)
        fmat[0, r0 + cells // XC, cells % XC] = torch.as_tensor(
            rng.integers(1, 3, n).astype(np.float32), device=dev)
    got, (sparse, dense) = _check(fmat, _b0(dev, B, 4))
    assert dense >= 1 and float(got[0, 4].max()) > 0


@pytest.mark.cuda
def test_all_zero_f_gives_zero_channels():
    dev = _need_cuda()
    fmat = torch.zeros((2, UP - LO, W), device=dev)
    got, (sparse, dense) = _check(fmat, _b0(dev, 2, 5))
    assert dense == 0 and torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_non_integer_values_take_the_same_routes():
    dev = _need_cuda()
    B = 8
    for n, seed in ((CELL_FRAGS, 6), (CELL_FRAGS * 40, 7)):
        counts = _raster(dev, B, n, seed)
        scale = torch.as_tensor(np.random.default_rng(seed).uniform(
            0.05, 3.3, counts.shape).astype(np.float32), device=dev)
        fmat = counts * scale
        _, routes = _check(fmat, _b0(dev, B, seed), integer=False)
        assert routes == _routes(counts, 147)


@pytest.mark.cuda
def test_edge_columns_of_the_first_and_last_tiles():
    """A batch-strided F of width 1,001 (not a multiple of 4: 4-byte
    copies) with fragments piled at both ends: the columns of the first
    and last tiles, the masked edges among them, meet the bars, and the
    masked edges are 0."""
    dev = _need_cuda()
    B, Wd, K = 4, 1001, 147
    rng = np.random.default_rng(8)
    mids = np.concatenate([rng.integers(0, 200, (B, 300)),
                           rng.integers(Wd - 200, Wd, (B, 300)),
                           rng.integers(0, Wd, (B, 300))], axis=1)
    sizes = np.clip(rng.normal(156, 30, mids.shape), 0, 250).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    mat = rasterize_batch(t(mids), t(sizes), torch.ones(mids.shape, dtype=torch.bool,
                                                         device=dev), 0, UP, Wd)
    fmat = mat[:, LO:]  # the main path's batch-strided view
    got, _ = _check(fmat, _b0(dev, B, 8, width=Wd))
    half = K // 2
    assert torch.equal(got[..., :half], torch.zeros_like(got[..., :half]))
    assert torch.equal(got[..., Wd - half:], torch.zeros_like(got[..., Wd - half:]))
    assert float(got[:, 4, half:half + 50].min()) > 0
    assert float(got[:, 4, Wd - half - 50:Wd - half].min()) > 0


@pytest.mark.cuda
def test_two_launches_give_equal_bits():
    dev = _need_cuda()
    B = 8
    fmat = _raster(dev, B, CELL_FRAGS * 10, 9)
    fmat[:, 60:80] += _raster(dev, B, CELL_FRAGS * 100, 10, uniform=True)[:, 60:80]
    b0 = _b0(dev, B, 9)
    tabs = _tables(dev)
    a = k2.nuc_scores(fmat, b0, *tabs, CFG.nuc.var_floor)
    b = k2.nuc_scores(fmat, b0, *tabs, CFG.nuc.var_floor)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    sparse, dense = _routes(fmat, 147)
    assert sparse > 0 and dense > 0
