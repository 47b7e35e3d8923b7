// comp_cumsum: sequential compensated (double-float32) cumulative sum.
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/compsum.py
// (comp_cumsum_seq).  x [K, B, N] -> (hi, lo) [K, B, N]: for every row
// (k, n) a left-to-right fold over the B bands of
//
//     s1 = acc_hi + x;  v = s1 - acc_hi;  e = (acc_hi - (s1 - v)) + (x - v)
//     lo = acc_lo + e;  s = s1 + lo;      acc = (s, lo - (s - s1))
//
// op for op as the Pallas kernel writes it.  The fold keeps the two
// properties the peaks map relies on: folding an exact zero returns the
// bitwise-identical pair, and a channel of 0/1 integers stays an exact
// integer cumsum with lo == 0.
//
// What bounds it on the H100: latency.  Each row is B dependent steps of
// a short add chain, and there are only K * N rows (3072 at the serving
// shape), about one warp per SM scheduler lane.  The loads do not depend
// on the carried pair, so the compiler can issue them ahead.
//
// Design: one thread per row, rows on consecutive threads.  In the
// [K, B, N] layout neighbouring threads read neighbouring addresses at
// every band, so each warp's loads and stores are coalesced.  Every add
// is __fadd_rn/__fsub_rn (no contraction, no reassociation), so the result
// is bit-identical to the plain version and to the TPU kernel's fold.

#include <cuda_runtime.h>

namespace {

__global__ void comp_cumsum_kernel(const float* __restrict__ x,
                                   float* __restrict__ hi,
                                   float* __restrict__ lo, int k_n, int b_n,
                                   int n_n) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(k_n) * n_n) return;
  const long long k = t / n_n;
  const long long n = t % n_n;
  const long long stride = n_n;
  long long i = k * b_n * stride + n;
  float ah = 0.0f;
  float al = 0.0f;
  for (int b = 0; b < b_n; ++b, i += stride) {
    const float xv = x[i];
    const float s1 = __fadd_rn(ah, xv);
    const float v = __fsub_rn(s1, ah);
    const float e = __fadd_rn(__fsub_rn(ah, __fsub_rn(s1, v)), __fsub_rn(xv, v));
    const float l = __fadd_rn(al, e);
    const float s = __fadd_rn(s1, l);
    const float nl = __fsub_rn(l, __fsub_rn(s, s1));
    hi[i] = s;
    lo[i] = nl;
    ah = s;
    al = nl;
  }
}

}  // namespace

extern "C" int bk_comp_cumsum(const float* x, float* hi, float* lo, int k_n,
                              int b_n, int n_n, cudaStream_t stream) {
  const long long rows = static_cast<long long>(k_n) * n_n;
  if (rows == 0) return 0;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  comp_cumsum_kernel<<<blocks, threads, 0, stream>>>(x, hi, lo, k_n, b_n, n_n);
  return static_cast<int>(cudaGetLastError());
}
