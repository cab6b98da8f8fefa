// K2: the fused nuc-score kernel. From the fragment matrix F and the bias
// matrix B0 of one window batch it computes, per valid position j (dyad
// p = j + K/2):
//   * the four 2-D template sums (signal = V.F, flogv = logV.F against F;
//     vb = V.B0, v2b = V^2.B0 against B0) with the tensor-core tile of
//     xcorr.cuh, one tile per input, F's slab by slab on one of two
//     routes (below);
//   * the four rank-1 sums (n, sum F*o, sum F*o^2 against F's column sums;
//     bsum against B0's), from column sums that the tile accumulates from
//     its staged slabs;
//   * the epilogue: mu = vb/bsum, mu2 = v2b/bsum, var = n(mu2 - mu^2),
//     norm = (signal - n mu)/sqrt(var) where var > var_floor and n > 0,
//     lr = flogv - n log max(mu, 1e-30), fuzz = sqrt(max(m2 - m1^2, 0));
//   * the edge mask: positions whose footprint leaves the window are 0.
// Output [B, 5, W] = (norm, signal, lr, fuzz, n); the [B, 8, W] conv
// outputs never reach device memory.
//
// Replaces nucleoatac_tpu/ops/pallas_kernels.py :: _kernel (launched by
// nuc_scores_pallas), which walked K steps of [C<=5, S] @ [S, W] matmuls,
// a shape that starved the TPU's matrix unit.
//
// Work per production batch (F, B0 [64, 146, 1536], K = 147, 1,390 valid
// outputs): the 2-D sums are 4 x 146 x 147 x 1390 x 64 = 7.64 G FMA
// (15.27 GFLOP); the rank-1 sums and epilogue add < 1%. Bytes: F + B0
// 114.8 MB in, 1.97 MB out, 0.035 ms at 3.35 TB/s. So the arithmetic
// binds: the tile puts the sums on the TF32 tensor cores, 3 products per
// term (see xcorr.cuh), at least 0.093 ms at 495 TFLOP/s (0.228 ms on
// the FP32 pipes, 67 TFLOP/s).
// F's two sums skip its zero cells. F holds fragment counts: at about 900
// fragments of the nuc size range per 1,536-bp window some 0.4% of its
// cells are nonzero (1-2% in the densest size rows), and a product with
// a zero cell adds exactly 0. So the tile counts each staged F slab's
// nonzero cells (8 size rows x xcols(K) columns) in its column-sum pass
// and sums a slab with at most kSparseMax of them from its nonzero list,
// in float64, rounded once with the dense slabs' diagonal sums (xcorr.cuh);
// a denser slab (a densely covered peak) takes the split-TF32 band
// products, as B0's slabs all do. The list's least work is F's bytes and
// two f64 products per entry and tap of its footprint, a few hundredths
// of the band products at 0.4%; measured, the ring's staging of each slab
// and its table rows, the count and the list cost about 0.08 ms per
// production batch at any density (the dense F tile took about 0.23), and
// each nonzero cell per slab about 0.0025 ms more: staging, not
// arithmetic, bounds the list route. Each launch adds its
// sparse and dense F slabs to `slabs` (the wrapper's two counters).
// The rank-1 sums and the epilogue are spread over all 256 threads (4 x
// 192 sums of K terms, then one thread per output), out of shared memory.
// One block per (window b, tile of BW valid outputs); the first and last
// tiles also write the masked edges.
#include "xcorr.cuh"

namespace {

using nucxc::BW;
using nucxc::NT;

// The crossover: a staged F slab (8 size rows x xcols(K) columns) with at
// most this many nonzero cells is summed from its list, a denser one by the
// band products. Measured on an H100 80GB HBM3 at 700 W with F [64, 146,
// 1536] whose cells are 1 with probability d, on a production B0 (ms per
// launch with every slab on the list / on the band products, by nonzero
// cells per slab): 1.4: 0.339 / 0.443; 11.3: 0.360 / 0.465; 22.5: 0.393
// / 0.469; 33.8: 0.421 / 0.470; 45.1: 0.448 / 0.469; 56.3: 0.475 / 0.471;
// 70.4: 0.509 / 0.469. The two routes cost the same at about 54.
constexpr int kSparseMax = 54;

__host__ __device__ inline int extra_floats(int K) {
  // res (signal, flogv, vb, v2b) | colsum F | colsum B0 | rank-1 sums |
  // F's slab list
  return 4 * BW + 2 * nucxc::xcols(K) + 4 * BW + nucxc::list_floats(kSparseMax);
}

__global__ void __launch_bounds__(NT, 2)
    nuc_scores_kernel(const float* __restrict__ fmat, long long f_bstride,
                      const float* __restrict__ b0, long long b_bstride,
                      const float* __restrict__ f2d,
                      const float* __restrict__ f1d,
                      const float* __restrict__ b2d,
                      const float* __restrict__ b1d,
                      float* __restrict__ out,
                      unsigned long long* __restrict__ slabs, int S, int W,
                      int K, float var_floor, int vec_f, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int half = K / 2;
  const int Wo = W - K + 1;
  const int j0 = blockIdx.x * BW;
  const int XC = nucxc::xcols(K);
  float* res = smem + nucxc::ring_floats(K);
  float* csf = res + 4 * BW;
  float* csb = csf + XC;
  float* sums = csb + XC;  // n, foff, foff2, bsum: [4][BW]
  float* list = sums + 4 * BW;

  nucxc::xcorr_tile<true>(b0 + (size_t)b * b_bstride, b2d, S, W, K, j0,
                          vec_b != 0, smem, res + 2 * BW, csb);
  const int ndense = nucxc::xcorr_tile<true, kSparseMax>(
      fmat + (size_t)b * f_bstride, f2d, S, W, K, j0, vec_f != 0, smem, res,
      csf, list);

  const int t = threadIdx.x;
  if (t == 0 && slabs != nullptr) {
    const int nst = (S + nucxc::SK - 1) / nucxc::SK;
    atomicAdd(slabs, (unsigned long long)(nst - ndense));
    atomicAdd(slabs + 1, (unsigned long long)ndense);
  }
  for (int task = t; task < 4 * BW; task += NT) {
    const int q = task / BW, jl = task - q * BW;
    if (j0 + jl >= Wo) continue;
    const float* w = q < 3 ? f1d + q * K : b1d;
    const float* cs = (q < 3 ? csf : csb) + jl;
    float a = 0.f;
    for (int k = 0; k < K; ++k) a = fmaf(__ldg(w + k), cs[k], a);
    sums[task] = a;
  }
  __syncthreads();

  float* ob = out + (size_t)b * 5 * W;
  for (int jl = t; jl < BW; jl += NT) {
    const int j = j0 + jl;
    if (j >= Wo) break;
    const float signal = res[jl], flogv = res[BW + jl];
    const float vb = res[2 * BW + jl], v2b = res[3 * BW + jl];
    const float n = sums[jl], foff = sums[BW + jl];
    const float foff2 = sums[2 * BW + jl], bsum = sums[3 * BW + jl];
    float norm = 0.f, lr = 0.f, fuzz = 0.f;
    const float safe_b = bsum > 0.f ? bsum : 1.f;
    const float mu = vb / safe_b;
    const float mu2 = v2b / safe_b;
    const float var = n * (mu2 - mu * mu);
    if (var > var_floor && n > 0.f)
      norm = (signal - n * mu) * (1.f / sqrtf(var));
    if (n > 0.f) {
      lr = flogv - n * logf(fmaxf(mu, 1e-30f));
      const float m1 = foff / n;
      const float m2 = foff2 / n;
      fuzz = sqrtf(fmaxf(m2 - m1 * m1, 0.f));
    }
    const int p = j + half;
    ob[p] = norm;
    ob[W + p] = signal;
    ob[2 * W + p] = lr;
    ob[3 * W + p] = fuzz;
    ob[4 * W + p] = n;
  }
  // the edge mask: positions whose footprint is cut by the window edge
  if (blockIdx.x == 0)
    for (int p = t; p < half; p += NT)
      for (int ch = 0; ch < 5; ++ch) ob[ch * W + p] = 0.f;
  if (blockIdx.x == gridDim.x - 1)
    for (int p = half + Wo + t; p < W; p += NT)
      for (int ch = 0; ch < 5; ++ch) ob[ch * W + p] = 0.f;
}

}  // namespace

// fmat, b0: [B, S, W] float32 with rows contiguous and batch strides
// f_bstride / b_bstride (elements); f2d, b2d: [2, K, S]; f1d: [3, K];
// b1d: [1, K]; out: [B, 5, W]; K odd, K <= W; slabs: null, or two
// counters to which the launch adds its sparse and dense F slabs. Returns
// the error of the shared-memory attribute (the tile's ring and the slab
// list take K <= 607), else cudaGetLastError() after the launch on
// `stream`.
extern "C" int nucleoatac_nuc_scores(const float* fmat, long long f_bstride,
                                     const float* b0, long long b_bstride,
                                     const float* f2d, const float* f1d,
                                     const float* b2d, const float* b1d,
                                     float* out, unsigned long long* slabs,
                                     int B, int S, int W, int K,
                                     float var_floor, void* stream) {
  if (K > W) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(nucxc::ring_floats(K) + extra_floats(K)) * sizeof(float);
  const cudaError_t err = nucxc::allow_smem(nuc_scores_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int Wo = W - K + 1;
  const dim3 grid((Wo + BW - 1) / BW, B);
  nuc_scores_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      fmat, f_bstride, b0, b_bstride, f2d, f1d, b2d, b1d, out, slabs, S, W,
      K, var_floor, nucxc::vec_ok(fmat, f_bstride, W),
      nucxc::vec_ok(b0, b_bstride, W));
  return (int)cudaGetLastError();
}
