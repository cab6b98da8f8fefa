// K3: the occupancy window kernel of wire v8. From the LL projection
// proj[b, g, w] = sum_s mat[b, s, w] log_mix[s, g] (the SGEMM before it)
// and the column counts n[b, w] = sum_s mat[b, s, w], it computes, per core
// position p of each window:
//   * the window log-likelihood ll[g] = sum of proj[b, g, w] over w in
//     [p - flank, p + flank], zero outside [0, W): a direct sum in float64
//     (no difference of prefix sums), rounded once to float32 (a float32
//     running sum of 121 terms of |LL| ~ 2e3 drifted past occ.exact_tol);
//   * the window count, the same sum over the counts (row G of the staged
//     slab), whose sign gives the empty flag;
//   * the picks of ops/occupancy.py :: _picks in float32 with torch's tie
//     rules (argmax takes the first index, the CI's bounds are the first
//     and the last g with ll >= llmax - ci_drop, the second best is the
//     max over g != best, ci_margin the min of |ll - thr|);
//   * the wire-v8 bytes of occupancy_packed2: argmax | certified << 7, the
//     CI deltas' low nibbles, and their fifth bits, 4 positions a byte.
// Output uint8 [B, 2*core + ceil(core/4)]; the float64 sums and the LL
// surface never reach device memory.
//
// Replaces no TPU kernel: the reference leaves the window sum and the
// picks to XLA. On the card their torch form (an f64 copy of the
// projection, an unfold-sum, a cast back, a dozen reductions) took 1.13 ms
// of a 2.36 ms step.
//
// Work per production batch (B 64, G 101, W 1,536, core 1,024, flank 60):
// summed window by window, 64 x 102 x 1,024 x 121 = 0.81 G float64 adds
// (the counts row included), 48 us on the FP64 pipes (132 SMs x 64 lanes x
// 1.98 GHz). Each thread sums a run of R consecutive positions of one row,
// whose windows share all but R - 1 terms on each side: the shared terms
// are summed once, so 23 adds per position and row (0.16 G, 9.3 us). The
// projection's core and halo are 30 MB in, 0.15 MB out (9.0 us at 3.35
// TB/s). Each term is converted to float64 once, when staged in shared
// memory. One block per (window b, tile of P core positions); it walks the
// grid in passes of GC rows (the counts are row G), and each pass's slab in
// chunks of CW columns, so any flank fits; the next chunk's loads are in
// flight while the current one is summed. The [P, G] float32 surface stays
// in shared memory for the picks.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int GC = 16;           // grid rows per pass: one per lane of a half-warp
constexpr int R = 8;             // consecutive positions per thread
constexpr int P = (NT / GC) * R; // core positions per block (128)
constexpr int CW = NT;           // slab columns per chunk: one per thread
constexpr int LD = CW + 1;       // staged row stride in doubles (odd: no bank conflicts)
constexpr int PER = GC;          // staged values per thread and chunk: one per row
constexpr int GMAX = 128;        // the 7-bit grid index of wire v8

__host__ __device__ inline int surface_stride(int G) { return G | 1; }

__host__ __device__ inline size_t smem_bytes(int G) {
  return (size_t)GC * LD * sizeof(double) + (size_t)P * surface_stride(G) * sizeof(float) +
         2 * P;
}

__global__ void __launch_bounds__(NT, 2)
    occ_window_kernel(const float* __restrict__ proj, long long sb, long long sg,
                      long long sw, const float* __restrict__ counts, long long cb,
                      unsigned char* __restrict__ out, int G, int W, int flank,
                      int core_lo, int core, float ci_drop, float exact_tol) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* slab = reinterpret_cast<double*>(smem);
  const int GS = surface_stride(G);
  float* surf = reinterpret_cast<float*>(slab + GC * LD);
  unsigned char* empty = reinterpret_cast<unsigned char*>(surf + P * GS);
  unsigned char* hi2 = empty + P;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * P;          // the tile's first core position
  const int np = min(P, core - t0);       // its positions
  const int span = 2 * flank + 1;         // terms per window
  const int L = np + 2 * flank;           // slab columns the tile reads
  const int c0 = core_lo + t0 - flank;    // window column of slab column 0
  const float* pb = proj + (size_t)b * sb;
  const float* nb = counts + (size_t)b * cb;
  const int tid = threadIdx.x;
  const int gl = tid % GC;
  const int base = (tid / GC) * R;        // slab column of the thread's first term
  const int nkc = (L + CW - 1) / CW;      // column chunks per pass
  const int nchunks = ((G + 1 + GC - 1) / GC) * nkc;  // rows 0..G-1, then the counts

  // thread tid stages column tid of each row of a chunk: coalesced where
  // the projection's columns are contiguous (the SGEMM's [B, G, W])
  float next[PER];
  auto fetch = [&](int j) {
    const int g0 = (j / nkc) * GC, k0 = (j % nkc) * CW;
    const int nk = min(CW, L - k0);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int g = g0 + u, c = c0 + k0 + tid;
      float v = 0.f;
      if (tid < nk && c >= 0 && c < W) {
        if (g < G) v = pb[g * sg + c * sw];
        else if (g == G) v = nb[c];
      }
      next[u] = v;
    }
  };

  fetch(0);
  // position base + r sums (left[r] + mid) + right[r]: mid holds the
  // terms every position of the run shares, kk = k - base in [R - 1,
  // span); left[r] its own before them, [r, R - 1); right[r] its own
  // after them, [span, span + r). Where span < R, left[r] takes them all.
  double left[R], right[R], mid = 0.0;
  const bool shared_mid = span >= R;
  for (int j = 0; j < nchunks; ++j) {
    const int k0 = (j % nkc) * CW;
    __syncthreads();  // the last chunk's sums are done with the slab
#pragma unroll
    for (int u = 0; u < PER; ++u) slab[u * LD + tid] = (double)next[u];
    __syncthreads();
    if (j + 1 < nchunks) fetch(j + 1);  // in flight while this chunk is summed
    if (k0 == 0) {
      mid = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) left[r] = right[r] = 0.0;
    }
    // the thread's terms in this chunk, each in k order
    const int lo = max(k0, base);
    const int hi = min(min(k0 + CW, L), base + R - 1 + span);
    const double* row = slab + gl * LD - k0;
    if (shared_mid) {
      const int m0 = min(max(lo, base + R - 1), hi), m1 = max(min(hi, base + span), m0);
      for (int k = lo; k < m0; ++k) {
        const double x = row[k];
#pragma unroll
        for (int r = 0; r < R - 1; ++r)
          if (r <= k - base) left[r] += x;
      }
#pragma unroll 4
      for (int k = m0; k < m1; ++k) mid += row[k];
      for (int k = m1; k < hi; ++k) {
        const double x = row[k];
#pragma unroll
        for (int r = 1; r < R; ++r)
          if (k - base - r < span) right[r] += x;
      }
    } else {
      for (int k = lo; k < hi; ++k) {
        const double x = row[k];
#pragma unroll
        for (int r = 0; r < R; ++r)
          if ((unsigned)(k - base - r) < (unsigned)span) left[r] += x;
      }
    }
    if (k0 + CW >= L) {  // the pass's last chunk: one rounding to float32
      const int g = (j / nkc) * GC + gl;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double acc = (left[r] + mid) + right[r];
        if (g < G) surf[(base + r) * GS + g] = (float)acc;
        else if (g == G) empty[base + r] = acc <= 0.0;
      }
    }
  }
  __syncthreads();

  const int p = tid;
  unsigned char* ob = out + (size_t)b * (2 * core + (core + 3) / 4);
  if (p < np) {
    const float* s = surf + p * GS;
    float llmax = s[0];
    int best = 0;
    for (int g = 1; g < G; ++g) {
      const float v = s[g];
      if (v > llmax) {
        llmax = v;
        best = g;
      }
    }
    const float thr = __fsub_rn(llmax, ci_drop);
    int first = -1, last = 0;
    float ll2 = -INFINITY, ci_margin = INFINITY;
    for (int g = 0; g < G; ++g) {
      const float v = s[g];
      if (v >= thr) {
        if (first < 0) first = g;
        last = g;
      }
      if (g != best && v > ll2) ll2 = v;
      ci_margin = fminf(ci_margin, fabsf(__fsub_rn(v, thr)));
    }
    if (first < 0) {  // no g clears thr (ci_drop < 0): torch's argmax of zeros
      first = 0;
      last = G - 1;
    }
    const float margin = __fsub_rn(llmax, ll2);
    const int lo_d = best - first, up_d = last - best;
    const bool emp = empty[p] != 0;
    const bool cert = margin > exact_tol && ci_margin > exact_tol && lo_d <= 31 &&
                      up_d <= 31 && !emp;
    const int lo_c = min(lo_d, 31), up_c = min(up_d, 31);
    const int pos = t0 + p;
    ob[pos] = (unsigned char)((emp ? 0 : best) | (cert ? 128 : 0));
    ob[core + pos] = emp ? 0 : (unsigned char)((lo_c & 0xF) | ((up_c & 0xF) << 4));
    hi2[p] = emp ? 0 : (unsigned char)((lo_c >> 4) | ((up_c >> 4) << 1));
  }
  __syncthreads();
  if (p < np && p % 4 == 0) {
    unsigned char byte = 0;
    for (int q = 0; q < 4 && p + q < np; ++q) byte |= hi2[p + q] << (2 * q);
    ob[2 * core + (t0 + p) / 4] = byte;
  }
}

}  // namespace

// proj: [B, G, W] float32, element strides (sb, sg, sw); counts: [B, W]
// float32, batch stride cb, columns contiguous; out: uint8 [B, 2*core +
// ceil(core/4)], contiguous. 1 <= G <= 128, flank >= 0, core >= 1; the
// window of a core position may leave [0, W) (zeros there). ci_drop and
// exact_tol are the float32 values torch's scalar promotion compares with.
// Returns cudaErrorInvalidValue on other arguments, the error of the
// shared-memory attribute, else cudaGetLastError() after the launch on
// `stream`.
extern "C" int nucleoatac_occ_window(const float* proj, long long sb, long long sg,
                                     long long sw, const float* counts, long long cb,
                                     unsigned char* out, int B, int G, int W, int flank,
                                     int core_lo, int core, float ci_drop,
                                     float exact_tol, void* stream) {
  if (B < 1 || G < 1 || G > GMAX || W < 1 || flank < 0 || core < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      occ_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // take the refusal off the last-error slot
    return (int)err;
  }
  const dim3 grid((core + P - 1) / P, B);
  occ_window_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      proj, sb, sg, sw, counts, cb, out, G, W, flank, core_lo, core, ci_drop, exact_tol);
  return (int)cudaGetLastError();
}
