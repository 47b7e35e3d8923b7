// frames_windowed: windowed analysis-frame fetch of both engines.
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/frames.py
// (gather_frames_windowed).  For each (stream s, frame f, channel c) it
// reads `block` samples of audio[s, c, :] from an integer start, zeroes
// the samples outside [0, T), multiplies by the analysis window, and
// writes the frame into a row of `pitch` >= block floats whose tail
// [block, pitch) is zero:
//
//     out[s, f, c, i] = i < block && 0 <= start[s, f] + i < T
//                       ? audio[s, c, start + i] * win[i] : 0
//
// With pitch = block it is the plain frame fetch (the fast engine); with
// pitch = fft it also does the zero padding the fidelity analysis needs
// before its MDFT, which the TPU path does with a lane-padded window and
// a jnp.pad after the kernel.
//
// What bounds it on the H100: device-memory bandwidth, and almost all of
// it is the output.  A stream's frames overlap heavily (the cur/prev pairs
// sit one interval apart, and at rate 0.001 a hop moves the frame by a few
// samples), so the distinct audio is a small part of the bytes; the window
// is shared by every frame.  Counted once each, the output is 85-95% of the
// bytes at the serving shapes.
//
// Design: a block of 128 threads writes one tile of kTile = 512 output
// columns of up to kGroup = 4 frames of one (stream, channel), and thread
// t owns columns 4t..4t+3 of the tile in every frame (blocks of 256 threads
// and 1024 columns, or of 2 or 3 frames, read slower on the card; capping
// the registers for more resident blocks spilled and read slower still):
//
// - The window once a block: each thread reads its four window samples
//   as one float4 into registers and uses them for all the group's
//   frames.
// - 16-byte rows.  For each frame a thread reads the audio around its
//   four samples as two float4 from a 16-byte aligned address (aligned
//   down from the first sample; the row base and the start may have any
//   residue mod 4), realigns them in registers by that residue (the same
//   for the whole frame, so the switch does not diverge), and writes one
//   float4.  All the group's loads are issued before the first product:
//   2 kGroup 16-byte loads and then kGroup 16-byte stores in flight a
//   thread, and a grid of (stream, channel, group of frames, tile) of
//   thousands of blocks at every serving shape (5120 at the kiosk's 64
//   streams).
// - The audio goes through the L2, not through shared memory.  A
//   stream's frames overlap heavily, so after the first touch a frame's
//   audio is an L2 hit; a design that staged each group's union of spans
//   in shared memory (cp.async, one barrier, frames written from there)
//   was built and timed on the card and was slower than this one at every
//   serving shape: a block's wait on its copy and the barrier cost more
//   than the L2 reads they save.  So no span needs bounding: every frame
//   reads only its own samples, and any start (a seek, a schedule jump,
//   the live ring, StretchNode's S = 1) takes the same path.  A load that
//   would leave [0, T) of the row is taken float by float, guarded.
// - Where the row pitch is not a multiple of 4 floats (or the window is
//   not 16-byte aligned) the rows cannot take 16-byte stores, and the same
//   kernel runs with one float a column (kVec = false; thread t owns
//   columns t, t + 128, t + 256, t + 384).  Offsets are 64-bit.
//
// The TPU kernel's 128-lane alignment, its three shifted DMA views and its
// rotation matmul existed only to realign an unaligned DMA on the TPU.  The
// product is one IEEE multiply (built with --fmad=false; __fmul_rn pins it
// anyway) and a sample outside the frame is a select, not a product, so the
// result is bit-identical to the plain version, NaN and inf included.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 4 * kThreads;  // output columns a block writes per frame
constexpr int kGroup = 4;            // frames a block writes

// Four consecutive floats starting r floats into a.
__device__ __forceinline__ float4 shifted(const float4& a, const float4& b, int r) {
  switch (r) {
    case 0: return a;
    case 1: return make_float4(a.y, a.z, a.w, b.x);
    case 2: return make_float4(a.z, a.w, b.x, b.y);
    default: return make_float4(a.w, b.x, b.y, b.z);
  }
}

// The samples [a0, a0 + 4) of a row, &row[a0] 16-byte aligned; zero
// outside [0, T), and all zero unless `live`.
__device__ __forceinline__ float4 load4(const float* row, long long a0, int t_len, bool live) {
  if (live && a0 >= 0 && a0 + 4 <= t_len) return __ldg(reinterpret_cast<const float4*>(row + a0));
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long e = a0 + q;
    v[q] = live && e >= 0 && e < t_len ? __ldg(row + e) : 0.0f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    frames_windowed_kernel(const float* __restrict__ audio, const int* __restrict__ starts,
                           const float* __restrict__ win, float* __restrict__ out,
                           int channels, int t_len, int frames, int block, int pitch,
                           int groups, int tiles) {
  // blockIdx.x = ((s * C + c) * groups + group) * tiles + tile: the tiles of
  // one row are neighbours
  long long b = blockIdx.x;
  const int tile = static_cast<int>(b % tiles);
  b /= tiles;
  const int f0 = static_cast<int>(b % groups) * kGroup;
  b /= groups;
  const int c = static_cast<int>(b % channels);
  const long long s = b / channels;
  const int n_frames = min(kGroup, frames - f0);
  const int i0 = tile * kTile;
  const float* row = audio + (s * channels + c) * static_cast<long long>(t_len);
  const long long frame_pitch = static_cast<long long>(channels) * pitch;
  float* dst0 = out + ((s * frames + f0) * channels + c) * static_cast<long long>(pitch);

  long long st[kGroup];
#pragma unroll
  for (int f = 0; f < kGroup; ++f) st[f] = f < n_frames ? starts[s * frames + f0 + f] : 0;

  if constexpr (kVec) {
    const int j = i0 + 4 * static_cast<int>(threadIdx.x);
    if (j >= pitch) return;
    float w[4];
    if (j + 4 <= block) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(win + j));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = j + q < block ? __ldg(win + j + q) : 0.0f;
    }
    // the residue of the row's base mod 4 floats: sample g's aligned
    // float4 starts at g - ((g + mis) & 3)
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    float4 lo[kGroup], hi[kGroup];
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      const long long g = st[f] + j;
      const long long a0 = g - ((g + mis) & 3);
      const bool live = f < n_frames && j < block;
      lo[f] = load4(row, a0, t_len, live);
      hi[f] = load4(row, a0 + 4, t_len, live);
    }
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      if (f >= n_frames) break;
      const long long g = st[f] + j;  // the audio sample of column j
      const float4 x = shifted(lo[f], hi[f], static_cast<int>((g + mis) & 3));
      const float xs[4] = {x.x, x.y, x.z, x.w};
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = j + q < block && g + q >= 0 && g + q < t_len;
        y[q] = ok ? __fmul_rn(xs[q], w[q]) : 0.0f;
      }
      *reinterpret_cast<float4*>(dst0 + f * frame_pitch + j) = make_float4(y[0], y[1], y[2], y[3]);
    }
  } else {
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      if (f >= n_frames) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = i0 + static_cast<int>(threadIdx.x) + q * kThreads;
        if (col >= pitch) continue;
        const long long g = st[f] + col;
        const bool ok = col < block && g >= 0 && g < t_len;
        dst0[f * frame_pitch + col] = ok ? __fmul_rn(__ldg(row + g), __ldg(win + col)) : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" int bk_frames_windowed(const float* audio, const int* starts, const float* win,
                                  float* out, int streams, int channels, int t_len, int frames,
                                  int block, int pitch, cudaStream_t stream) {
  if (streams == 0 || channels == 0 || frames == 0 || pitch == 0) return 0;
  const long long tiles = (pitch + kTile - 1) / kTile;
  const long long groups = (frames + kGroup - 1) / kGroup;
  const long long blocks = static_cast<long long>(streams) * channels * groups * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = pitch % 4 == 0 && (reinterpret_cast<uintptr_t>(win) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec) {
    frames_windowed_kernel<true><<<grid, kThreads, 0, stream>>>(
        audio, starts, win, out, channels, t_len, frames, block, pitch,
        static_cast<int>(groups), static_cast<int>(tiles));
  } else {
    frames_windowed_kernel<false><<<grid, kThreads, 0, stream>>>(
        audio, starts, win, out, channels, t_len, frames, block, pitch,
        static_cast<int>(groups), static_cast<int>(tiles));
  }
  return static_cast<int>(cudaGetLastError());
}
