"""The CPU path's f32 norm and occupancy LL do not depend on the thread
count, on concurrent load or on how a batch is sharded: ops/xcorr.py ::
conv1d_stack (the 1-D stacks of K1's and K2's plain versions), whose
float32 einsum gave other bits at other thread counts; ops/xcorr.py ::
conv_stack_diag (their 2-D stacks), whose float32 GEMM each shard runs at
its own window count; ops/occupancy.py :: _ll_and_n (the occ LL einsum
and its window sum); and whole runs of the fused pool pass and the
two-pass delta12 path at different thread counts, which print the same
signal bytes."""
import dataclasses
import gzip
import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from nucleoatac_tpu.ops.occupancy import _ll_and_n as jax_ll_and_n
from nucleoatac_tpu.ops.smooth import gauss_smooth_batch as jax_gauss_smooth_batch
from nucleoatac_tpu.ops.xcorr import conv1d_stack as jax_conv1d_stack
from nucleoatac_tpu.ops.xcorr import conv_stack_diag as jax_conv_stack_diag
from nucleoatac_torch.config import RunConfig, WindowParams
from nucleoatac_torch.models.pipeline import run_pipeline
from nucleoatac_torch.ops.occupancy import _ll_and_n
from nucleoatac_torch.ops.smooth import gauss_kernel, gauss_smooth_batch
from nucleoatac_torch.ops.xcorr import conv1d_stack, conv_stack_diag
from nucleoatac_torch.parity import SIGNAL_SUFFIXES
from synth import make_example

THREADS = (1, 2, 3, 4, 5, 6, 7, 8)


@pytest.fixture
def threads():
    """Calls fn under each thread count of THREADS; restores the count."""
    n0 = torch.get_num_threads()

    def under(fn):
        out = []
        try:
            for n in THREADS:
                torch.set_num_threads(n)
                out.append(fn())
        finally:
            torch.set_num_threads(n0)
        return out

    return under


@pytest.mark.parametrize("channels", [1, 3])
def test_conv1d_stack_bits_hold_across_threads_and_load(threads, channels):
    """The same inputs give the same bits at 1 to 8 threads and from four
    threads calling it at once (K2's bsum stack is the one-channel case);
    the result is the float64 sum rounded once (within one f32 ulp) and
    within f32 rounding of the reference's."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((4, 768)).astype(np.float32) * 3e-3)
    k = torch.from_numpy(rng.normal(0, 40, (channels, 147)).astype(np.float32))
    want = conv1d_stack(x, k)
    for got in threads(lambda: conv1d_stack(x, k)):
        assert torch.equal(got, want)
    with ThreadPoolExecutor(4) as pool:
        for got in pool.map(lambda _: conv1d_stack(x, k), range(12)):
            assert torch.equal(got, want)
    win = x.double().unfold(1, 147, 1)
    ref = torch.einsum("bjk,ck->bcj", win, k.double())
    torch.testing.assert_close(want.double(), ref, rtol=1.2e-7, atol=0)
    # the reference's float32 sum: within the rounding bound of 147 terms
    bound = 147 * 2.0 ** -24 * float(torch.einsum("bjk,ck->bcj", win, k.double().abs()).max())
    jax_out = np.asarray(jax_conv1d_stack(x.numpy(), k.numpy()))
    assert np.abs(want.numpy() - jax_out).max() <= bound


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_conv_stack_diag_bits_hold_across_shards_threads_and_load(threads, scale):
    """The 2-D stacks of a batch of 8 windows, computed whole and as 2, 4
    and 8 shards (the window counts a sharded engine gives each device),
    at 1 to 8 threads and from four threads at once: one set of bits, the
    float64 sum rounded once (within half an f32 ulp of an independent
    float64 evaluation), and within f32 rounding of the reference's."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.poisson(0.05, (8, 146, 768)) * scale).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1e-2, (2, 147, 146)).astype(np.float32))

    def sharded():
        return [torch.cat([conv_stack_diag(p, k) for p in x.split(8 // n)])
                for n in (1, 2, 4, 8)]

    want = conv_stack_diag(x, k)
    for got in [g for run in threads(sharded) for g in run]:
        assert torch.equal(got, want)
    with ThreadPoolExecutor(4) as pool:
        for got in pool.map(lambda n: torch.cat([conv_stack_diag(p, k) for p in x.split(n)]),
                            (1, 2, 4, 8) * 3):
            assert torch.equal(got, want)
    win = x.double().unfold(2, 147, 1)  # [B, S, W-K+1, K]
    ref = torch.einsum("bsjk,cks->bcj", win, k.double())
    half_ulp = torch.finfo(torch.float32).eps / 2 * want.double().abs()
    assert ((want.double() - ref).abs() <= half_ulp * (1 + 1e-6)).all()
    bound = 146 * 147 * 2.0 ** -24 * float(torch.einsum("bsjk,cks->bcj", win, k.double().abs()).max())
    jax_out = np.asarray(jax_conv_stack_diag(x.numpy(), k.numpy()))
    assert np.abs(want.numpy() - jax_out).max() <= bound


def test_gauss_smooth_bits_hold_across_shards_and_threads(threads):
    """The smoothed norm of 8 rows, whole and as 2, 4 and 8 shards, at 1
    to 8 threads: one set of bits (a float32 conv1d gave one row alone
    other bits than the same row among eight), the float64 sum rounded
    once, and within f32 rounding of the reference's."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(0, 3, (8, 768)).astype(np.float32))
    k = torch.from_numpy(gauss_kernel(10.0))

    def sharded():
        return [torch.cat([gauss_smooth_batch(p, k) for p in x.split(8 // n)])
                for n in (1, 2, 4, 8)]

    want = gauss_smooth_batch(x, k)
    for got in [g for run in threads(sharded) for g in run]:
        assert torch.equal(got, want)
    K = k.shape[0]
    win = torch.nn.functional.pad(x.double(), (K // 2, K // 2)).unfold(1, K, 1)
    ref = win @ k.double().flip(0)
    half_ulp = torch.finfo(torch.float32).eps / 2 * want.double().abs()
    assert ((want.double() - ref).abs() <= half_ulp * (1 + 1e-6)).all()
    bound = K * 2.0 ** -24 * float((win.abs() @ k.double()).max())
    jax_out = np.asarray(jax_gauss_smooth_batch(x.numpy(), k.numpy()))
    assert np.abs(want.numpy() - jax_out).max() <= bound


def test_occ_ll_bits_hold_across_shards_threads_and_load(threads):
    """The occupancy LL surface of 8 windows (_ll_and_n: the [S, G]
    log-mixture einsum, then the window sum), whole and as 2, 4 and 8
    shards, at 1 to 8 threads and from four threads at once: one hash of
    its bits, the float64 surface rounded once (within half an f32 ulp of
    an independent float64 evaluation), and within f32 rounding of the
    reference's."""
    rng = np.random.default_rng(14)
    flank = 60
    mat = torch.from_numpy(rng.poisson(0.05, (8, 251, 512)).astype(np.float32))
    log_mix = torch.from_numpy(
        np.log(rng.dirichlet(np.ones(251), size=101).T).astype(np.float32))

    def digest(parts):
        ll = torch.cat([_ll_and_n(p, log_mix, flank)[0] for p in parts])
        return hashlib.sha256(ll.contiguous().numpy().tobytes()).hexdigest()

    def sharded():
        return [digest(mat.split(8 // n)) for n in (1, 2, 4, 8)]

    want = digest([mat])
    assert set(d for run in threads(sharded) for d in run) == {want}
    with ThreadPoolExecutor(4) as pool:
        assert set(pool.map(lambda n: digest(mat.split(n)), (1, 2, 4, 8) * 3)) == {want}
    ll, n = _ll_and_n(mat, log_mix, flank)
    counts = torch.nn.functional.pad(mat.double(), (flank, flank)).unfold(
        2, 2 * flank + 1, 1).sum(dim=-1)  # [B, S, W]: the window's counts first
    ref = torch.einsum("bsw,sg->bwg", counts, log_mix.double())
    assert float(ref.abs().max()) > 100
    half_ulp = torch.finfo(torch.float32).eps / 2 * ll.double().abs()
    assert ((ll.double() - ref).abs() <= half_ulp * (1 + 1e-6)).all()
    bound = (251 + 2 * flank + 1) * 2.0 ** -24 * float(ref.abs().max())
    jll, jn = jax_ll_and_n(mat.numpy(), log_mix.numpy(), flank)
    assert np.abs(ll.numpy() - np.asarray(jll)).max() <= bound
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


def test_pool_and_delta12_runs_print_one_signal_at_other_thread_counts(threads, tmp_path):
    """The fused pool pass and the two-pass delta12 path on make_example,
    each at every thread count of 1 to 8: one set of signal bytes."""
    ex = make_example(tmp_path)
    cfg = RunConfig(window=WindowParams(core=256, batch=4))
    seen = []

    def run(wire):
        c = dataclasses.replace(cfg, window=dataclasses.replace(cfg.window, transfer=wire))
        prefix = str(tmp_path / f"{wire}_{len(seen)}")
        seen.append(prefix)
        run_pipeline(ex["bam"], ex["bed"], prefix, fasta_path=ex["fasta"], cfg=c,
                     write_plots=False, device="cpu")
        out = []
        for sfx in SIGNAL_SUFFIXES:
            with gzip.open(prefix + sfx) as fh:
                out.append(fh.read())
        return out

    runs = threads(lambda: run("pool")) + threads(lambda: run("delta12"))
    assert runs[0][0] and all(r == runs[0] for r in runs)
