"""The two template-xcorr kernels of nucleoatac_torch against the JAX
package: the plain versions (what the CPU runs) against the Pallas
kernels in interpret mode, the XLA diag path and the float64 mirror; the
CUDA kernels against their plain versions where a GPU is present."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nucleoatac_tpu import mirror
from nucleoatac_tpu.core.vmat import VMat
from nucleoatac_tpu.ops.pallas_diag import diag_conv_pallas
from nucleoatac_tpu.ops.pallas_kernels import nuc_scores_pallas
from nucleoatac_tpu.ops.xcorr import build_kernels, conv_stack_diag
from nucleoatac_torch.ops import diag_xcorr as k1
from nucleoatac_torch.ops import nuc_scores as k2
from nucleoatac_torch.ops import occ_window as k3
from nucleoatac_torch.ops.occupancy import occupancy_packed2
from nucleoatac_torch.ops.xcorr import build_kernels_diag

VLO, VUP = 105, 251


def _k1_inputs(rng):
    B, S, W, C, K = 3, 34, 512, 2, 37
    x = rng.random((B, S, W)).astype(np.float32)
    k2d = rng.standard_normal((C, K, S)).astype(np.float32)
    return x, k2d


def test_diag_xcorr_plain_matches_pallas_and_xla(rng):
    """K1's plain version == diag_conv_pallas (interpret) and the XLA diag
    path at HIGHEST, rtol 1e-4 (the JAX kernel's own bar)."""
    x, k2d = _k1_inputs(rng)
    got = k1.diag_xcorr(torch.from_numpy(x), torch.from_numpy(k2d)).numpy()
    xla = np.asarray(conv_stack_diag(
        jnp.asarray(x), jnp.asarray(k2d), precision=jax.lax.Precision.HIGHEST
    ))
    pal = np.asarray(diag_conv_pallas(jnp.asarray(x), k2d, interpret=True))
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pal, rtol=1e-4, atol=1e-4)


def _nuc_inputs(rng, B=2, W=1024, n=600):
    mids = rng.integers(0, W, size=(B, n))
    sizes = rng.integers(VLO, VUP, size=(B, n))
    fmat = np.stack(
        [mirror.rasterize(mids[b], sizes[b], VLO, VUP, W) for b in range(B)]
    ).astype(np.float32)
    logb = rng.normal(0, 0.3, size=(B, W))
    q = rng.random(VUP - VLO)
    q /= q.sum()
    b0 = np.stack(
        [mirror.bias_mat(logb[b], q, VLO, VUP, 100, W - 100) for b in range(B)]
    ).astype(np.float32)
    return fmat, b0


def test_nuc_scores_plain_matches_pallas_and_mirror(rng):
    """K2's plain version through nuc_scores_from_stacks (K2's own
    arguments) == nuc_scores_pallas (interpret) and mirror.nuc_scores,
    with test_pallas.py's tolerances against the mirror."""
    vm = VMat.default()
    fk, bk = build_kernels(vm.mat)
    fmat, b0 = _nuc_inputs(rng)
    got = k2.nuc_scores_from_stacks(
        torch.from_numpy(fmat), torch.from_numpy(b0),
        torch.from_numpy(fk), torch.from_numpy(bk),
    ).numpy()
    pal = nuc_scores_pallas(
        jnp.asarray(fmat), jnp.asarray(b0), fk, bk, interpret=True
    )
    for i, name in enumerate(k2.CHANNELS):
        np.testing.assert_allclose(
            got[:, i], np.asarray(getattr(pal, name)), rtol=1e-4, atol=2e-3,
            err_msg=name,
        )
    for b in range(fmat.shape[0]):
        ref = mirror.nuc_scores(
            fmat[b].astype(np.int64), b0[b].astype(np.float64), vm.mat
        )
        norm, signal, lr, fuzz, n = got[b]
        np.testing.assert_allclose(n, ref.n, atol=0.5)
        np.testing.assert_allclose(signal, ref.signal, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(norm, ref.norm, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(lr, ref.lr, rtol=1e-3, atol=5e-2)
        np.testing.assert_allclose(fuzz, ref.fuzz, rtol=1e-3, atol=1e-2)


def test_nuc_conv_outputs_matches_jax(rng):
    """K1's nuc_conv_outputs wrapper == the JAX diag conv outputs."""
    from nucleoatac_tpu.ops.xcorr import nuc_conv_outputs_diag

    tabs = build_kernels_diag(VMat.default().mat)
    fmat, b0 = _nuc_inputs(rng, B=2, W=512, n=300)
    fo, bo = k1.nuc_conv_outputs(
        torch.from_numpy(fmat), torch.from_numpy(b0),
        *[torch.from_numpy(np.ascontiguousarray(t)) for t in tabs],
    )
    jfo, jbo = nuc_conv_outputs_diag(
        jnp.asarray(fmat), jnp.asarray(b0), *tabs
    )
    np.testing.assert_allclose(fo.numpy(), np.asarray(jfo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bo.numpy(), np.asarray(jbo), rtol=1e-4, atol=1e-9)


def test_stacks_to_diag_is_exact_split():
    """The build_kernels stacks split into the build_kernels_diag tables
    bit for bit, and a stack whose rank-1 channel varies along S is
    refused."""
    vm = VMat.default().mat
    fk, bk = build_kernels(vm)
    got = k2.stacks_to_diag(torch.from_numpy(fk), torch.from_numpy(bk))
    for g, want in zip(got, build_kernels_diag(vm)):
        np.testing.assert_array_equal(g.numpy(), want)
    bad = fk.copy()
    bad[3, 5, 0] += 1.0
    with pytest.raises(ValueError, match="channel 3"):
        k2.stacks_to_diag(torch.from_numpy(bad), torch.from_numpy(bk))


def test_cpu_wrappers_count_no_launches(rng):
    """On CPU tensors the wrappers run the plain versions, and
    occupancy_packed2 (K3's caller) its torch route: no kernel launch is
    counted."""
    x, k2d = _k1_inputs(rng)
    before = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES)
    k1.diag_xcorr(torch.from_numpy(x), torch.from_numpy(k2d))
    fk, bk = build_kernels(VMat.default().mat)
    fmat, b0 = _nuc_inputs(rng, B=1, W=512, n=100)
    k2.nuc_scores_from_stacks(
        torch.from_numpy(fmat), torch.from_numpy(b0),
        torch.from_numpy(fk), torch.from_numpy(bk),
    )
    mat = torch.from_numpy(rng.poisson(0.05, size=(2, 30, 512)).astype(np.float32))
    log_mix = torch.from_numpy(-rng.random((30, 101)).astype(np.float32))
    occupancy_packed2(mat, log_mix, 60, 128, 256)
    assert (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES) == before


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_diag_xcorr_kernel_matches_plain(rng):
    dev = _need_cuda()
    x, k2d = _k1_inputs(rng)
    xt, kt = torch.from_numpy(x).to(dev), torch.from_numpy(k2d).to(dev)
    n0 = k1.LAUNCHES
    got = k1.diag_xcorr(xt, kt)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == n0 + 1
    want = k1.conv_stack_diag(xt, kt)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_nuc_scores_kernel_matches_plain(rng):
    dev = _need_cuda()
    fk, bk = build_kernels(VMat.default().mat)
    fmat, b0 = _nuc_inputs(rng)
    args = [torch.from_numpy(a).to(dev) for a in (fmat, b0, fk, bk)]
    n0 = k2.LAUNCHES
    got = k2.nuc_scores_from_stacks(*args)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == n0 + 1
    want = k2.nuc_scores_plain(
        args[0], args[1], *k2.stacks_to_diag(args[2], args[3]), 1e-12
    )
    torch.testing.assert_close(got[:, 4], want[:, 4], rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)


def test_nuc_scores_batch_matches_jax(rng):
    """The direct-conv scorer (all eight reductions as convolutions) ==
    the JAX package's nuc_scores_batch, and its norm == K2's plain norm."""
    from nucleoatac_tpu.ops.xcorr import nuc_scores_batch as jax_scores
    from nucleoatac_torch.ops.xcorr import nuc_scores_batch

    fk, bk = build_kernels(VMat.default().mat)
    fmat, b0 = _nuc_inputs(rng, B=1, W=512, n=300)
    got = nuc_scores_batch(torch.from_numpy(fmat), torch.from_numpy(b0),
                           torch.from_numpy(fk), torch.from_numpy(bk))
    want = jax_scores(jnp.asarray(fmat), jnp.asarray(b0), fk, bk)
    for name in ("signal", "n", "norm", "fuzz"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=1e-4, atol=1e-3, err_msg=name,
        )
    plain = k2.nuc_scores_from_stacks(
        torch.from_numpy(fmat), torch.from_numpy(b0),
        torch.from_numpy(fk), torch.from_numpy(bk),
    )
    np.testing.assert_allclose(got.norm.numpy(), plain[:, 0].numpy(), atol=1e-4)


# ---------------- the tile plan of csrc/xcorr.cuh --------------------------
def _cuh_constants():
    import re

    src = (k1.__file__.rsplit("ops", 1)[0] + "csrc/xcorr.cuh")
    text = open(src).read()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _tile_plan(x, k2d, j0, c):
    """One tile of the kernel's decomposition in float64: the taps cut into
    bands of KB that join the reduction (band b reads the x slab shifted by
    KB * b columns), one D of 2 KB x NCOL, then the diagonal sum of D."""
    S, W = x.shape
    K = k2d.shape[1]
    BW, KB, NCOL = c["BW"], c["KB"], c["NCOL"]
    NB = -(-K // KB)
    XC = (BW + NB * KB - 1 + 3) & ~3
    xs = np.zeros((S, XC))
    xs[:, : max(0, min(W, j0 + XC) - j0)] = x[:, j0:j0 + XC]
    D = np.zeros((2 * KB, NCOL))
    for b in range(NB):
        A = np.zeros((2, KB, S))
        k = np.arange(b * KB, min(K, (b + 1) * KB))
        A[:, : len(k)] = k2d[:, k]
        D += A.reshape(2 * KB, S) @ xs[:, b * KB: b * KB + NCOL]
    kk = np.arange(KB)
    return np.stack([[D[ch * KB + kk, jl + kk].sum() for jl in range(BW)]
                     for ch in range(2)])


@pytest.mark.parametrize("S,W,K", [(34, 512, 37), (146, 1536, 147), (5, 300, 33),
                                   (12, 1024, 401)])
def test_tile_plan_of_xcorr_cuh_equals_plain(S, W, K):
    """The banded diagonal GEMM of csrc/xcorr.cuh, with the tile constants
    read from that file, sums exactly the valid cross-correlation: the
    bands, the shifted slabs, the zero rows past K and the zero columns
    past W account for every term once. K = 401 takes more bands (13)
    and staged columns (608) than the 256 threads of a block."""
    c = _cuh_constants()
    assert c["NCOL"] >= c["BW"] + c["KB"] - 1 and c["BW"] % 4 == 0
    rng = np.random.default_rng(K)
    x, k2d = rng.random((S, W)), rng.random((2, K, S))
    Wo = W - K + 1
    got = np.concatenate([_tile_plan(x, k2d, j0, c) for j0 in range(0, Wo, c["BW"])],
                         axis=1)[:, :Wo]
    want = k1.conv_stack_diag(torch.from_numpy(x[None]), torch.from_numpy(k2d))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


# ---------------- the slab plan of K2's F sums (csrc/nuc_scores.cu) --------
def _sparse_max():
    import re

    src = k1.__file__.rsplit("ops", 1)[0] + "csrc/nuc_scores.cu"
    return int(re.search(r"constexpr int kSparseMax = (\d+);", open(src).read())[1])


def _slab_plan(x, k2d, j0, c, smax):
    """One tile of K2's F sums in float64, as the kernel plans them: each
    staged slab of SK size rows counts its nonzero cells; a slab with at
    most ``smax`` is summed from its list (the cells of column q owned by
    thread q mod NT, threads in order, each thread's columns in order and
    rows in order within a column), output jl adding v * k2d[ch, q - jl,
    s] for each entry (s, q, v) with 0 <= q - jl < K; a denser one takes
    the band products into D, whose diagonal sum joins the list sums at
    the end. Returns (out [2, BW], sparse slabs, dense slabs)."""
    S, W = x.shape
    K = k2d.shape[1]
    BW, KB, NCOL, SK = c["BW"], c["KB"], c["NCOL"], c["SK"]
    NB = -(-K // KB)
    XC = (BW + NB * KB - 1 + 3) & ~3
    xs = torch.zeros((S, XC), dtype=torch.float64)
    xs[:, : max(0, min(W, j0 + XC) - j0)] = x[:, j0:j0 + XC]
    D = torch.zeros((2 * KB, NCOL), dtype=torch.float64)
    listed = torch.zeros((2, BW), dtype=torch.float64)
    jl = torch.arange(BW)
    n_sparse = n_dense = 0
    for s0 in range(0, S, SK):
        slab = xs[s0:s0 + SK]
        nz = torch.nonzero(slab)
        if len(nz) <= smax:
            n_sparse += 1
            NT = c["NT"]
            order = torch.argsort(((nz[:, 1] % NT) * XC + nz[:, 1] // NT) * SK + nz[:, 0])
            r, q = nz[order, 0], nz[order, 1]
            k = q[:, None] - jl[None, :]
            foot = (k >= 0) & (k < K)
            kc = k.clamp(0, K - 1)
            v = slab[r, q][:, None]
            for ch in range(2):
                listed[ch] += torch.where(foot, v * k2d[ch][kc, (s0 + r)[:, None]],
                                          0.0).sum(0)
        else:
            n_dense += 1
            for b in range(NB):
                A = torch.zeros((2, KB, len(slab)), dtype=torch.float64)
                kk = torch.arange(b * KB, min(K, (b + 1) * KB))
                A[:, : len(kk)] = k2d[:, kk, s0:s0 + len(slab)]
                D += A.reshape(2 * KB, len(slab)) @ slab[:, b * KB: b * KB + NCOL]
    kk = torch.arange(KB)[:, None]
    diag = torch.stack([D[ch * KB:(ch + 1) * KB][kk, jl[None, :] + kk].sum(0)
                        for ch in range(2)])
    return listed + diag, n_sparse, n_dense


def _slab_density(S, W, K, rows, rng, smax, c):
    """F [S, W] with non-integer values (and zeros): ``rows`` names the
    density of each size row; "crossover" puts exactly smax nonzero cells
    in the first tile's first slab and smax + 1 in its second."""
    if rows == "crossover":
        x = (rng.random((S, W)) < 0.002) * (0.25 + rng.random((S, W)))
        XC = (c["BW"] + -(-K // c["KB"]) * c["KB"] - 1 + 3) & ~3
        for r0, n in ((0, smax), (c["SK"], smax + 1)):
            rows_in = min(c["SK"], S - r0)
            x[r0:r0 + rows_in, :XC] = 0.0
            cells = rng.choice(rows_in * XC, n, replace=False)
            x[r0 + cells // XC, cells % XC] = 0.25 + rng.random(n)
        return x
    dens = {"cell": [0.004], "tenfold": [0.04], "mixed": [0.003, 0.6],
            "dense": [0.5], "full": [1.0]}[rows]
    p = np.array([dens[(s // c["SK"]) % len(dens)] for s in range(S)])[:, None]
    return (rng.random((S, W)) < p) * (0.25 + rng.random((S, W)))


@pytest.mark.parametrize("rows", ["cell", "tenfold", "mixed", "dense", "full", "crossover"])
@pytest.mark.parametrize("S,W,K", [(146, 1536, 147), (34, 512, 37), (12, 1024, 401)])
def test_slab_plan_of_nuc_scores_cu_equals_plain(S, W, K, rows):
    """K2's F sums as the kernel plans them (the slab count, the crossover
    read from csrc/nuc_scores.cu, the list in its order with its
    footprint test, the band products of the dense slabs) equal the
    dense cross-correlation, in float64, at five densities and at the
    crossover; the routes the slabs take follow the rule."""
    c = _cuh_constants()
    smax = _sparse_max()
    rng = np.random.default_rng(K + len(rows))
    x = _slab_density(S, W, K, rows, rng, smax, c)
    k2d = rng.standard_normal((2, K, S))
    Wo = W - K + 1
    xt, kt = torch.from_numpy(x), torch.from_numpy(k2d)
    tiles = [_slab_plan(xt, kt, j0, c, smax) for j0 in range(0, Wo, c["BW"])]
    got = torch.cat([t[0] for t in tiles], dim=1)[:, :Wo].numpy()
    want = k1.conv_stack_diag(xt[None], kt)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    sparse, dense = sum(t[1] for t in tiles), sum(t[2] for t in tiles)
    assert sparse + dense == len(tiles) * -(-S // c["SK"])
    if rows == "cell":
        assert dense == 0
    if rows == "full":  # every cell nonzero: dense where a slab holds more than smax
        XC = (c["BW"] + -(-K // c["KB"]) * c["KB"] - 1 + 3) & ~3
        assert dense == sum(min(c["SK"], S - s0) * min(XC, W - j0) > smax
                            for j0 in range(0, Wo, c["BW"]) for s0 in range(0, S, c["SK"]))
    if rows == "dense":
        assert dense > sparse
    if rows in ("mixed", "crossover"):
        assert sparse > 0 and dense > 0
    if rows == "crossover":  # the first tile: smax cells sparse, smax + 1 dense
        assert tiles[0][1] >= 1 and tiles[0][2] >= 1
        SK = c["SK"]
        assert _slab_plan(xt[:SK], kt[:, :, :SK], 0, c, smax)[1:] == (1, 0)
        assert _slab_plan(xt[SK:2 * SK], kt[:, :, SK:2 * SK], 0, c, smax)[1:] == (0, 1)
