// smooth_pair: the fidelity step's smoothing pass of stage 2 (the peaks
// map's threshold) in one launch: two chained bidirectional one-pole
// smoothers, the first one's last value passed to the second as its carry.
//
// Replaces no TPU kernel: the JAX package runs these four affine scans as
// lax.associative_scan, which XLA lowers.  It was added because the plain
// PyTorch form is launch-bound: ops/scan.py recurses ~12 levels a scan and
// dispatches the combine, a cat and an interleave at every level, some 469
// launches a step for work that reads and writes each row once.
//
// Per row, e [B] -> y [B] with a = 1 - coef and cf = coef (one pair a row):
//
//   bwd(v, c0):  y = reverse(scan(reverse(cf v))) applied to c0
//   fwd(v, c0):  y = scan(cf v) applied to c0
//   s1 = fwd(b1 = bwd(e, 0), b1[0]);  y = fwd(b2 = bwd(s1, s1[B-1]), b2[0])
//
// where scan is the inclusive scan of (a, cf v_k) under
// combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2) and "applied to c0"
// is aa_k c0 + bb_k.  Every value is rounded as the plain version rounds
// it (kernels/smooth.py: the same tree as lax.associative_scan): the
// up-sweep pairs neighbours (2i, 2i+1) level by level; the down-sweep keeps
// element 0, takes odd k from the level above and folds the scanned pair
// before every even k onto it; each product and sum is rounded on its own
// (__fmul_rn / __fadd_rn; the library also builds with --fmad=false).
//
// a is the same along a row, so every unscanned a of tree level l is one
// value u_l = u_{l-1}^2 (u_0 = a), and the scanned a (aa) is the same in
// all four scans: it is computed once a row, and each scan carries only b.
//
// What bounds it on the H100: a row is read once and written once, 8 bytes
// a band (25 MB at N = 1024, B = 3072: 7.5 us at 3.35 TB/s).  Its dependent
// depth is four scans of 2 floor(log2 B) levels, a multiply and an add
// each, some 200 operations (~0.4 us).  Neither is near what it replaces.
//
// Design: one block a row.  The row, aa and every tree level of b live in
// shared memory (4 B floats, 48 KB at B = 3072, 72 KB at the kiosk's 4608,
// dynamic, opted in above 48 KB); each level is one pass of the block's
// threads and one barrier.  The first up-sweep level is fused with the
// pre-multiply and the last down-sweep level with the carry application
// and the (reversed) store, so a scan costs 2 floor(log2 B) barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxLevels = 32;

struct Tree {
  int levels;  // L = floor(log2 B): the tree's levels above the row
  float* u;    // [L + 1] the unscanned a of each level
  int* off;    // [L + 1] offset of each level in the b buffer
};

// One affine scan of the row x (read reversed where rev) applied to c0,
// written back to x in the same order; aa is the scanned a of level 0.
__device__ __forceinline__ void scan_pass(float* x, const float* aa, float* lb, const Tree& t,
                                          int b_n, float cf, float c0, bool rev) {
  const int tid = threadIdx.x, nt = blockDim.x;
  auto at = [&](int k) { return rev ? b_n - 1 - k : k; };
  // level 0 (cf v) and level 1, fused
  {
    const float u0 = t.u[0];
    float* l1 = lb + t.off[1];
    for (int i = tid; i < b_n / 2; i += nt) {
      const float v0 = __fmul_rn(cf, x[at(2 * i)]);
      const float v1 = __fmul_rn(cf, x[at(2 * i + 1)]);
      lb[2 * i] = v0;
      lb[2 * i + 1] = v1;
      l1[i] = __fadd_rn(__fmul_rn(u0, v0), v1);
    }
    if ((b_n & 1) && tid == 0) lb[b_n - 1] = __fmul_rn(cf, x[at(b_n - 1)]);
  }
  __syncthreads();
  // up-sweep: level l + 1 from level l
  for (int l = 1; l < t.levels; ++l) {
    const float u = t.u[l];
    const float* lo = lb + t.off[l];
    float* hi = lb + t.off[l + 1];
    for (int i = tid; i < (b_n >> (l + 1)); i += nt) {
      hi[i] = __fadd_rn(__fmul_rn(u, lo[2 * i]), lo[2 * i + 1]);
    }
    __syncthreads();
  }
  // down-sweep: level l in place from the scanned level l + 1 (the top
  // level, one element, is its own scan)
  for (int l = t.levels - 1; l >= 1; --l) {
    const float u = t.u[l];
    float* lo = lb + t.off[l];
    const float* hi = lb + t.off[l + 1];
    for (int k = tid + 1; k < (b_n >> l); k += nt) {
      lo[k] = (k & 1) ? hi[k >> 1] : __fadd_rn(__fmul_rn(u, hi[(k >> 1) - 1]), lo[k]);
    }
    __syncthreads();
  }
  // level 0, applied to c0 and stored
  {
    const float u0 = t.u[0];
    const float* l1 = lb + t.off[1];
    for (int k = tid; k < b_n; k += nt) {
      const float bb = k == 0 ? lb[0]
                       : (k & 1) ? l1[k >> 1]
                                 : __fadd_rn(__fmul_rn(u0, l1[(k >> 1) - 1]), lb[k]);
      x[at(k)] = __fadd_rn(__fmul_rn(aa[k], c0), bb);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
    smooth_pair_kernel(const float* __restrict__ e, const float* __restrict__ a_rows,
                       const float* __restrict__ cf_rows, float a_all, float cf_all,
                       float* __restrict__ out, int b_n) {
  extern __shared__ float smem[];
  __shared__ float s_u[kMaxLevels + 1];
  __shared__ int s_off[kMaxLevels + 1];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x;
  const float a = a_rows ? a_rows[row] : a_all;
  const float cf = cf_rows ? cf_rows[row] : cf_all;
  const int levels = 31 - __clz(b_n);
  float* x = smem;        // [B] the row between scans, in its own order
  float* aa = x + b_n;    // [B] the scanned a of level 0
  float* lb = aa + b_n;   // every level of b, level 0 first (sum of B >> l)
  if (tid == 0) {
    float u = a;
    int off = 0;
    for (int l = 0; l <= levels + 1; ++l) {  // one past the top: level 1 where B = 1
      s_u[l] = u;
      s_off[l] = off;
      off += b_n >> l;
      u = __fmul_rn(u, u);
    }
  }
  const float* src = e + row * b_n;
  for (int k = tid; k < b_n; k += nt) x[k] = src[k];
  __syncthreads();
  const Tree t{levels, s_u, s_off};

  // aa: the down-sweep of a alone, each level written over the b buffer's
  // (free until the first scan)
  if (levels >= 1 && tid == 0) lb[t.off[levels]] = t.u[levels];
  __syncthreads();
  for (int l = levels - 1; l >= 0; --l) {
    const float u = t.u[l];
    float* lo = l == 0 ? aa : lb + t.off[l];
    const float* hi = lb + t.off[l + 1];
    for (int k = tid; k < (b_n >> l); k += nt) {
      lo[k] = k == 0 ? u : (k & 1) ? hi[k >> 1] : __fmul_rn(hi[(k >> 1) - 1], u);
    }
    __syncthreads();
  }
  if (levels == 0 && tid == 0) aa[0] = a;
  __syncthreads();

  // the first smoother: backward from 0, then forward from its first value
  scan_pass(x, aa, lb, t, b_n, cf, 0.0f, true);
  scan_pass(x, aa, lb, t, b_n, cf, x[0], false);
  // the second: backward from the first one's last value, then forward
  scan_pass(x, aa, lb, t, b_n, cf, x[b_n - 1], true);
  scan_pass(x, aa, lb, t, b_n, cf, x[0], false);

  float* dst = out + row * b_n;
  for (int k = tid; k < b_n; k += nt) dst[k] = x[k];
}

// Shared memory of a block for rows of b_n bands (kernels/smooth.py:smem_bytes).
long long smem_bytes(int b_n) {
  long long floats = 2LL * b_n;
  for (int n = b_n; n >= 1; n >>= 1) floats += n;
  return floats * 4;
}

// The dynamic shared memory a block may take (227 KB), less room for the
// static arrays (kernels/smooth.py:SMEM_LIMIT).
constexpr long long kSmemLimit = 232448 - 1024;

}  // namespace

// a_rows and cf_rows are per-row [n_n] or null, in which case a_all and
// cf_all hold for every row.
extern "C" int bk_smooth_pair(const float* e, const float* a_rows, const float* cf_rows,
                              float a_all, float cf_all, float* out, int n_n, int b_n,
                              cudaStream_t stream) {
  if (n_n == 0 || b_n == 0) return 0;
  const long long bytes = smem_bytes(b_n);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      smooth_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a thread for each pair of the widest level, in whole warps
  const int threads = min(kMaxThreads, max(32, (b_n / 2 + 31) / 32 * 32));
  smooth_pair_kernel<<<static_cast<unsigned>(n_n), threads, bytes, stream>>>(
      e, a_rows, cf_rows, a_all, cf_all, out, b_n);
  return static_cast<int>(cudaGetLastError());
}
