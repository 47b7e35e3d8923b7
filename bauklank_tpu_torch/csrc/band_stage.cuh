// Asynchronous staging of band tiles into shared memory, shared by the two
// sequential kernels (bandchain.cu, compsum.cu).
//
// Both walk B bands in order with a value carried from band to band, and
// both are bound by the latency of that walk: a load started when the walk
// reaches its band costs a device-memory round trip on every step.  Their
// operands do not depend on the carried value, so they are copied ahead of
// the walk with cp.async into a ring of stages in shared memory, and the
// walk reads shared memory only.
//
// A stage holds `planes` x BT rows of WIDTH floats, [plane][band][column]:
// the columns are the block's streams (or rows of the prefix sum), minor in
// device memory too, so a row is WIDTH * 4 contiguous bytes there and a
// thread of the walk reads its column without a bank conflict.  Rows move
// as 16-byte copies where the operand's row pitch keeps them aligned (a
// multiple of 4 floats), else float by float; both forms are
// asynchronous.  Bands past the operand's end and columns past its width
// are not copied and must not be read.  (Records of one column's planes
// side by side, read with 16-byte loads, were tried for the chain: the
// 4-byte copies that transpose into them cost the producers more than the
// loads saved the walk.)

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bk {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of one stage's share of an operand: `planes` planes
// (`plane_pitch` floats apart) of `bands` <= BT rows (`row_pitch` floats
// apart) of `cols` <= WIDTH floats, from `src` (the first row's first
// column) to `dst` [planes][BT][WIDTH].  The `nthreads` threads numbered
// `tid` share the copies; `vec` says that every row starts on a 16-byte
// boundary (then `cols` is a multiple of 4 too).  The caller commits.
template <int WIDTH, int BT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int planes,
                                           long long plane_pitch, long long row_pitch,
                                           int bands, int cols, bool vec, int tid,
                                           int nthreads) {
  static_assert(WIDTH % 4 == 0, "a stage's rows are whole 16-byte chunks");
  if (vec) {
    constexpr int kChunks = WIDTH / 4;
    for (int i = tid; i < planes * BT * kChunks; i += nthreads) {
      const int col = (i % kChunks) * 4;
      const int row = i / kChunks;
      const int band = row % BT;
      if (band < bands && col < cols) {
        cp_async16(dst + row * WIDTH + col,
                   src + (row / BT) * plane_pitch + band * row_pitch + col);
      }
    }
  } else {
    for (int i = tid; i < planes * BT * WIDTH; i += nthreads) {
      const int col = i % WIDTH;
      const int row = i / WIDTH;
      const int band = row % BT;
      if (band < bands && col < cols) {
        cp_async4(dst + row * WIDTH + col,
                  src + (row / BT) * plane_pitch + band * row_pitch + col);
      }
    }
  }
}

}  // namespace bk
