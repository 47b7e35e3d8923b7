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
// integer cumsum with lo == 0.  It stays a left-to-right fold: a segmented
// or tree scan would round otherwise.
//
// What bounds it on the H100: the time of one band's step in one warp,
// seven dependent adds of 4 cycles, B times over.  There are only K * N
// rows (768 to 3072), under one warp for each of the card's SMs, so a warp
// has nothing to hide a load behind: it has to have many bands' loads in
// flight ahead of its fold.  The warp runs in order, so the band's load,
// its two stores and their addresses add to the adds where they do not fall
// into a wait: the fold takes some 57 cycles a band against 28 of adds.
//
// Design: one thread a row, 32 neighbouring rows a warp, one warp a block
// (so the rows spread over as many SMs as there are warps).  The warp
// copies its rows' x ahead of the fold into a ring of kStages stages of
// kBands bands in shared memory (cp.async, band_stage.cuh: full 128-byte
// lines), kStages - 1 stages ahead; a stage costs each lane a few copy
// instructions for kBands bands of fold, so the fold's own warp starts
// them.  The fold reads shared memory only, in a fully unrolled loop, and
// stores hi and lo straight out (coalesced; a store does not stall the
// fold).  Every add is __fadd_rn/__fsub_rn (no contraction, no
// reassociation), so the result is bit-identical to the plain version and
// to the TPU kernel's fold.

#include <cuda_runtime.h>

#include "band_stage.cuh"

namespace {

constexpr int kRows = 32;   // rows a block: one warp
constexpr int kBands = 64;  // bands a stage (16 and 32 read slower, 4 and 5 stages no faster)
constexpr int kStages = 3;

// One band of the fold of one row.
__device__ __forceinline__ void fold(float xv, float& ah, float& al) {
  const float s1 = __fadd_rn(ah, xv);
  const float v = __fsub_rn(s1, ah);
  const float e = __fadd_rn(__fsub_rn(ah, __fsub_rn(s1, v)), __fsub_rn(xv, v));
  const float l = __fadd_rn(al, e);
  const float s = __fadd_rn(s1, l);
  al = __fsub_rn(l, __fsub_rn(s, s1));
  ah = s;
}

__global__ void __launch_bounds__(kRows)
    comp_cumsum_kernel(const float* __restrict__ x, float* __restrict__ hi,
                       float* __restrict__ lo, int b_n, int n_n) {
  constexpr int BT = kBands, NS = kStages;
  __shared__ __align__(16) float stage[NS][BT][kRows];
  const int lane = threadIdx.x;
  // blocks run over (plane k, tile of kRows columns), tiles minor
  const int tiles = (n_n + kRows - 1) / kRows;
  const int n0 = static_cast<int>(blockIdx.x % tiles) * kRows;
  const int cols = min(kRows, n_n - n0);
  const bool vec = n_n % 4 == 0;
  // the first band's row of this block's columns
  const long long base = static_cast<long long>(blockIdx.x / tiles) * b_n * n_n + n0;
  const int n_tiles = (b_n + BT - 1) / BT;

  auto fill = [&](int t) {
    if (t < n_tiles) {
      bk::stage_rows<kRows, BT>(&stage[t % NS][0][0],
                                x + base + static_cast<long long>(t) * BT * n_n, 1, 0, n_n,
                                min(BT, b_n - t * BT), cols, vec, lane, kRows);
    }
    bk::cp_async_commit();
  };

  for (int t = 0; t < NS - 1; ++t) fill(t);
  float ah = 0.0f, al = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    bk::cp_async_wait<NS - 2>();  // this lane's share of tile t
    __syncwarp();                 // tile t is whole; every lane is done with tile t - 1
    fill(t + NS - 1);             // into the stage of tile t - 1
    if (lane >= cols) continue;
    const float* xs = &stage[t % NS][0][lane];
    const int bands = min(BT, b_n - t * BT);
    const long long at = base + static_cast<long long>(t) * BT * n_n + lane;
    if (bands == BT) {
#pragma unroll
      for (int j = 0; j < BT; ++j) {
        fold(xs[j * kRows], ah, al);
        hi[at + static_cast<long long>(j) * n_n] = ah;
        lo[at + static_cast<long long>(j) * n_n] = al;
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < bands; ++j) {
        fold(xs[j * kRows], ah, al);
        hi[at + static_cast<long long>(j) * n_n] = ah;
        lo[at + static_cast<long long>(j) * n_n] = al;
      }
    }
  }
}

}  // namespace

extern "C" int bk_comp_cumsum(const float* x, float* hi, float* lo, int k_n, int b_n,
                              int n_n, cudaStream_t stream) {
  if (k_n == 0 || b_n == 0 || n_n == 0) return 0;
  const long long blocks = static_cast<long long>(k_n) * ((n_n + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  comp_cumsum_kernel<<<static_cast<unsigned>(blocks), kRows, 0, stream>>>(x, hi, lo, b_n, n_n);
  return static_cast<int>(cudaGetLastError());
}
