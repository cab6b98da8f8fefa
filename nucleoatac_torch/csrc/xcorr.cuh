// Shared tile routine of the template cross-correlation kernels
// (diag_xcorr.cu, nuc_scores.cu): a diagonal GEMM on Hopper's tensor cores.
//
// For one window b, an input x [S, W] (rows contiguous) and a table
// k2d [2, K, S], one block computes BW consecutive valid outputs
//
//   out[c, j] = sum_s sum_k k2d[c, k, s] * x[s, j + k],   j in [j0, j0 + BW)
//
// (columns past W read as zero). The TPU kernel wrote this as one GEMM
// H = Kflat @ x followed by a skew-sum over H's diagonals. Here the taps
// are cut into NB bands of KB = 32 (k = 32 b + kk, rows past K are zero),
// and the band index joins the reduction:
//
//   D[(c, kk), m] = sum_b sum_s k2d[c, 32 b + kk, s] * x[s, j0 + 32 b + m]
//   out[c, j0 + jl] = sum_kk D[(c, kk), jl + kk]
//
// D is a 64 x NCOL product (rows (c, kk), NCOL = 224 >= BW + KB - 1) with
// a reduction of NB x S: band b reads the staged x slab shifted by 32 b
// columns, so one accumulator tile in registers covers every band and the
// diagonal sum runs once per tile, through shared memory.
//
// Work at the production shape (x [64, 146, 1536], K = 147, 1,390 valid
// outputs): 2 x 146 x 147 x 1390 x 64 = 3.82 G FMA per input; the tile
// computes 64 x 224 x (5 x 152) per 192 outputs, 1.30x that. Bytes: each
// input 57.4 MB read once, 0.017 ms at 3.35 TB/s. So the bound is the
// arithmetic: three TF32 tensor-core products per term at 495 TFLOP/s
// (dense) take at least 0.046 ms per input; the FP32 pipes (67 TFLOP/s)
// would take 0.114 ms.
//
// What the design does about it:
//   * mma.sync.m16n8k8 TF32 tensor-core products, 3 per term for fp32
//     accuracy: each operand is split a = hi + lo (hi = a with its low 13
//     mantissa bits cleared, lo = a - hi, of which the tensor core reads
//     the TF32 bits) and the sum takes lo*hi + hi*lo + hi*hi; the dropped
//     lo*lo is ~2^-20 of the product. Plain TF32 (a 10-bit mantissa) would
//     miss the nuc f64 certification bar. The split is made in registers,
//     both operands, as fragments are read: the staged slabs stay fp32,
//     and the tables are not split ahead in the wrapper, which would
//     double their shared-memory reads to save two integer operations
//     per element. The tensor core's fp32 accumulation truncates, so the
//     three products of one band and k step go into a fresh 4-register
//     fragment that is then added to the running sum in fp32 (round to
//     nearest). Summed straight into one accumulator, the ~285 truncating
//     adds per output drifted ~8x further from f64, and the drift grew
//     with coverage (K2's norm error follows the fragment counts).
//   * x slabs of SK = 8 size rows and the matching table rows are copied
//     by cp.async into a ring of NSTG stages, so the next slab's copy runs
//     under the current slab's products; x goes in 16-byte copies where it
//     is 16-byte aligned (4-byte ones otherwise); no div/mod per element.
//   * 8 warps as 2 (rows) x 4 (columns); a warp holds 32 x 56 of D, so
//     each fragment of x feeds 2 row tiles and each table fragment 7
//     column tiles. Strides 360 (x) and 72 (table) make every fragment
//     load bank-conflict free.
//   * 192 outputs per block: 8 tiles per production window, 512 blocks of
//     256 threads, 2 blocks per SM (<= 128 registers, ~78 KB shared), so
//     264 run at once and the second wave is 248 of 264 slots full; a
//     persistent grid would gain at most that last 6%.
//   * K2's F tile (SPARSE_MAX >= 0) sums each sparse slab from its
//     nonzero list in float64 and runs the band products on dense slabs
//     only (see xcorr_tile); K1 and K2's B0 tile take every slab dense.
//   * Column sums (K2's rank-1 sums) are added per stage into shared
//     memory, any number of staged columns. The template width is bounded
//     only by the ring's shared memory, which grows with the bands: at
//     227 KB per block K1 takes K <= 672 and K2, with its slab list,
//     K <= 607; past that cudaFuncSetAttribute fails and the launch
//     returns its error.
//
// It stands for the GEMM and skew-sum of nucleoatac_tpu/ops/pallas_diag.py
// :: _diag_kernel (K1), whose four 2-D sums K2 (pallas_kernels.py ::
// _kernel) also needs.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace nucxc {

constexpr int NT = 256;     // threads per block (8 warps)
constexpr int BW = 192;     // valid outputs per tile (multiple of 4)
constexpr int KB = 32;      // taps per band
constexpr int SK = 8;       // size rows per stage = one mma k step
constexpr int NSTG = 3;     // cp.async ring depth
constexpr int NCOL = 224;   // columns of D: 4 warps x 7 n8 tiles
constexpr int RS = 72;      // table stage row stride (64 rows + 8)
constexpr int DS = 232;     // D staging stride
static_assert(SK == NT / 32, "one warp stages one size row");
static_assert(NCOL >= BW + KB - 1, "D must hold every band diagonal");

__host__ __device__ inline int nbands(int K) { return (K + KB - 1) / KB; }
// staged x columns of a tile (a multiple of 4)
__host__ __device__ inline int xcols(int K) {
  return (BW + nbands(K) * KB - 1 + 3) & ~3;
}
// x stage row stride: >= xcols and = 8 (mod 32) for conflict-free loads
__host__ __device__ inline int xstride(int K) {
  const int c = xcols(K);
  return c + ((8 - c % 32) + 32) % 32;
}
__host__ __device__ inline int stage_floats(int K) {
  return SK * xstride(K) + nbands(K) * SK * RS;
}
// the ring, reused for the D staging once the reduction is done
__host__ __device__ inline int ring_floats(int K) {
  const int r = NSTG * stage_floats(K);
  return r > 64 * DS ? r : 64 * DS;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo with hi a TF32 value (low 13 mantissa bits cleared) and lo
// the exact remainder; the tensor core reads lo's top 19 bits only, which
// costs ~2^-21 of a and saves a cvt per operand
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copies of stage rows s0..s0+SK-1: x columns [j0, j0 + xcols)
// into xs[row][col] (stride xstride), and the table rows of every band
// into as[b][s][(c, kk)] (stride RS). Out-of-range elements read as zero.
// BYBAND walks the table copies band by band: thread (warp, lane) copies
// tap kk = 4 warp + lane / 8 of each band and channel, the same elements
// in fewer instructions (K2's F tile; K1 and K2's B0 tile keep the
// row-group walk).
template <bool BYBAND = false>
__device__ __forceinline__ void load_stage(float* slot, const float* x,
                                           const float* k2d, int S, int W,
                                           int K, int j0, int s0, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int XC = xcols(K), XS = xstride(K), NB = nbands(K);
  const int s = s0 + warp;
  const bool srow = s < S;
  const float* grow = x + (size_t)(srow ? s : 0) * W;
  float* xrow = slot + warp * XS;
  if (vec) {  // W, the row base and j0 are multiples of 4 floats
    for (int q = 4 * lane; q < XC; q += 128) {
      const int col = j0 + q;
      const bool ok = srow && col < W;
      cp_async16(xrow + q, ok ? grow + col : x, ok);
    }
  } else {
    for (int q = lane; q < XC; q += 32) {
      const int col = j0 + q;
      const bool ok = srow && col < W;
      cp_async4(xrow + q, ok ? grow + col : x, ok);
    }
  }
  float* as = slot + SK * XS;
  const int ss = lane & 7;
  const bool scol = s0 + ss < S;
  if (BYBAND) {
    const int kk = 4 * warp + (lane >> 3);
    const size_t cstride = (size_t)K * S;
    float* d = as + ss * RS + kk;
    const float* src = k2d + (size_t)kk * S + s0 + ss;
    for (int b = 0; b < NB; ++b, d += SK * RS, src += (size_t)KB * S) {
      const bool ok = scol && b * KB + kk < K;
      cp_async4(d, ok ? src : k2d, ok);
      cp_async4(d + KB, ok ? src + cstride : k2d, ok);
    }
    return;
  }
  for (int rg = warp; rg < NB * 16; rg += 8) {
    const int rowid = rg * 4 + (lane >> 3);  // b * 64 + c * 32 + kk
    const int b = rowid >> 6, c = (rowid >> 5) & 1;
    const int k = b * KB + (rowid & 31);
    const bool ok = scol && k < K;
    cp_async4(as + (b * SK + ss) * RS + (rowid & 63),
              ok ? k2d + ((size_t)c * K + k) * S + s0 + ss : k2d, ok);
  }
}

// Shared memory of the slab list of xcorr_tile<COLSUM, SPARSE_MAX>, in
// floats: each output's list sums (f64), the entries' values (f64) and
// positions, the warps' counts.
__host__ __device__ constexpr int list_floats(int sparse_max) {
  return sparse_max < 0 ? 0 : 4 * BW + 3 * sparse_max + NT / 32;
}

// One input's tile. On return res[c * BW + jl] = out[c, j0 + jl] for
// jl < BW (every thread sees it: a __syncthreads() follows) and, with
// COLSUM, colsum[q] = sum_s x[s, j0 + q] for q < xcols(K). smem holds
// ring_floats(K) floats; res and colsum lie outside it.
//
// With SPARSE_MAX >= 0 (K2's F) the block counts each staged slab's
// nonzero cells in the pass that adds the column sums. A slab with at
// most SPARSE_MAX of them is summed from its list alone: each thread
// appends the nonzero cells of its own columns (t, t + NT, ...; rows in
// order) to `list` (list_floats(SPARSE_MAX) floats, 8-byte aligned,
// outside smem) at its place in the block's order, and output thread jl
// adds v * k2d[c, q - jl, s] for each entry (s, q, v) with
// 0 <= q - jl < K, in list order, in float64. Denser slabs take the
// band products. The f64 sums are added to the diagonal sums of the
// dense slabs (skipped where none was dense) and rounded once. Returns
// the number of dense slabs (every slab without the list).
template <bool COLSUM, int SPARSE_MAX = -1>
__device__ int xcorr_tile(const float* x, const float* k2d, int S, int W,
                          int K, int j0, bool vec, float* smem, float* res,
                          float* colsum, float* list = nullptr) {
  constexpr bool SPARSE = SPARSE_MAX >= 0;
  static_assert(COLSUM || !SPARSE, "the slab count rides on the column sums");
  // ring depth: the sparse tile's light stages keep one copy in flight
  constexpr int NS = SPARSE ? 2 : NSTG;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int NB = nbands(K), XC = xcols(K), XS = xstride(K);
  const int SF = stage_floats(K);
  const int nst = (S + SK - 1) / SK;

  float acc[2][7][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  if (COLSUM)
    for (int q = t; q < XC; q += NT) colsum[q] = 0.f;
  // the slab list: output jl's sums (lsum[c * BW + jl]); the entries'
  // values lv[e] and positions lq[e] ((row * RS) << 12 | column); each
  // warp's count of nonzero cells
  constexpr int CAP = SPARSE ? SPARSE_MAX : 0;
  double* lsum = reinterpret_cast<double*>(list);
  double* lv = lsum + (SPARSE ? 2 * BW : 0);
  int* lq = reinterpret_cast<int*>(lv + CAP);
  int* wcnt = lq + CAP;
  if (SPARSE)
    for (int i = t; i < 2 * BW; i += NT) lsum[i] = 0.0;
  int ndense = 0;

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst)
      load_stage<SPARSE>(smem + i * SF, x, k2d, S, W, K, j0, i * SK, vec);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage st landed for all; stage st-1 fully consumed
    const int nx = st + NS - 1;
    if (nx < nst)
      load_stage<SPARSE>(smem + (nx % NS) * SF, x, k2d, S, W, K, j0,
                         nx * SK, vec);
    cp_async_commit();

    const float* xs = smem + (st % NS) * SF;
    const float* as = xs + SK * XS;
    int nz = 0;  // this thread's nonzero cells (SPARSE)
    if (COLSUM)  // each thread owns columns t, t + NT, ...
      for (int q = t; q < XC; q += NT) {
        float a = 0.f;
#pragma unroll
        for (int r = 0; r < SK; ++r) {
          const float v = xs[r * XS + q];
          a += v;
          if (SPARSE) nz += v != 0.f;
        }
        colsum[q] += a;
      }
    if constexpr (SPARSE) {
      // the thread's place in the list: an inclusive scan over the warp,
      // then the warps before it
      int incl = nz;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wcnt[warp] = incl;
      __syncthreads();
      int total = 0, off = incl - nz;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        const int c = wcnt[w];
        total += c;
        off += w < warp ? c : 0;
      }
      if (total <= SPARSE_MAX) {  // the same decision in every thread
        for (int q = t; q < XC; q += NT)
#pragma unroll
          for (int r = 0; r < SK; ++r) {
            const float v = xs[r * XS + q];
            if (v != 0.f) {
              lv[off] = (double)v;
              lq[off] = ((r * RS) << 12) | q;
              ++off;
            }
          }
        __syncthreads();
        if (t < BW) {  // warps 0..5: output jl = t, both channels
          const int jl = t;
          // two partial sums per channel, entries taken in pairs, joined in
          // a fixed order: the loads of a pair overlap
          double s0 = lsum[jl], s1 = lsum[BW + jl], u0 = 0.0, u1 = 0.0;
          for (int e = 0; e < total; e += 2) {
            const bool two = e + 1 < total;
            const int ea = lq[e], eb = two ? lq[e + 1] : ea;
            // a lane outside an entry's footprint reads tap 0 and adds 0
            const int ka = (ea & 0xfff) - jl, kb = (eb & 0xfff) - jl;
            const bool ina = (unsigned)ka < (unsigned)K;
            const bool inb = two && (unsigned)kb < (unsigned)K;
            const float* pa = as + (ea >> 12) +
                              (ina ? (ka >> 5) * (SK * RS) + (ka & 31) : 0);
            const float* pb = as + (eb >> 12) +
                              (inb ? (kb >> 5) * (SK * RS) + (kb & 31) : 0);
            const double va = ina ? lv[e] : 0.0, vb = inb ? lv[e + 1] : 0.0;
            s0 = fma(va, (double)pa[0], s0);
            s1 = fma(va, (double)pa[KB], s1);
            u0 = fma(vb, (double)pb[0], u0);
            u1 = fma(vb, (double)pb[KB], u1);
          }
          lsum[jl] = s0 + u0;
          lsum[BW + jl] = s1 + u1;
        }
        continue;
      }
      ++ndense;
    }
    for (int b = 0; b < NB; ++b) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = as + (b * SK + t4) * RS + wm * 32 + mt * 16 + g;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8], ah[mt][1], al[mt][1]);
        split_tf32(a[4 * RS], ah[mt][2], al[mt][2]);
        split_tf32(a[4 * RS + 8], ah[mt][3], al[mt][3]);
      }
      const float* xb = xs + t4 * XS + b * KB + wn * 56 + g;
#pragma unroll
      for (int nt = 0; nt < 7; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(xb[nt * 8], bh0, bl0);
        split_tf32(xb[4 * XS + nt * 8], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float f[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(f, al[mt], bh0, bh1);
          mma_tf32(f, ah[mt], bl0, bl1);
          mma_tf32(f, ah[mt], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += f[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage D over it
  if (SPARSE && ndense == 0) {  // every slab took the list
    for (int i = t; i < 2 * BW; i += NT) res[i] = (float)lsum[i];
    __syncthreads();
    return 0;
  }

  float* Ds = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 7; ++nt) {
      const int row = wm * 32 + mt * 16 + g;
      const int col = wn * 56 + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(Ds + row * DS + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(Ds + (row + 8) * DS + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  for (int task = t; task < 2 * BW; task += NT) {
    const int c = task / BW, jl = task - c * BW;
    const float* d = Ds + c * KB * DS + jl;
    float a = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < KB; ++kk) a += d[kk * (DS + 1)];
    // the list sums join the dense slabs' once
    res[task] = SPARSE ? (float)(lsum[task] + (double)a) : a;
  }
  __syncthreads();  // res complete; the ring may be refilled
  return ndense;
}

// x [S, W] rows are copied 16 bytes at a time when the window base is
// 16-byte aligned and rows are whole 16-byte multiples.
inline bool vec_ok(const float* x, long long bstride, int W) {
  return ((uintptr_t)x % 16 == 0) && (W % 4 == 0) && (bstride % 4 == 0);
}

// Sets the kernel's dynamic shared memory limit; returns the CUDA error.
// A refusal (more than the card's 227 KB per block) is also taken off the
// runtime's last-error slot, so that no later launch reports it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace nucxc
