// frames_windowed: windowed analysis-frame fetch for the fidelity step.
//
// Replaces the TPU kernel bauklank_tpu/ops/pallas/frames.py
// (gather_frames_windowed).  For each (stream s, frame f, channel c) it
// reads `block` samples of audio[s, c, :] from an integer start, zeroes
// the samples outside [0, T), and multiplies by the analysis window:
//
//     out[s, f, c, i] = 0 <= start[s, f] + i < T ? audio[s, c, start + i] * win[i] : 0
//
// What bounds it on the H100: device-memory bandwidth.  Each output
// sample costs one audio read, one window read (L1/L2-resident: the
// window is shared by every frame) and one write; there is no reuse to
// exploit beyond the overlap of neighbouring frames, which L2 catches.
//
// Design: one thread block per (s, f, c) row; its threads stride over
// the `block` samples, so a warp reads 32 consecutive audio samples and
// writes 32 consecutive outputs (coalesced).  The TPU kernel's 128-lane
// alignment, its three shifted DMA views and its rotation matmul existed
// only to realign an unaligned DMA on the TPU; a GPU load takes any
// address, so the frame is fetched at exactly `block` samples and no lane
// padding is needed.  The product is one IEEE multiply (built with
// --fmad=false; __fmul_rn pins it anyway), so the result is bit-identical
// to the plain version.

#include <cuda_runtime.h>

namespace {

__global__ void frames_windowed_kernel(const float* __restrict__ audio,
                                       const int* __restrict__ starts,
                                       const float* __restrict__ win,
                                       float* __restrict__ out,
                                       int channels, int t_len, int frames,
                                       int block) {
  const long long row = blockIdx.x;             // (s * F + f) * C + c
  const int c = static_cast<int>(row % channels);
  const long long sf = row / channels;           // s * F + f
  const long long s = sf / frames;
  const long long start = starts[sf];
  const float* src = audio + (s * channels + c) * static_cast<long long>(t_len);
  float* dst = out + row * static_cast<long long>(block);
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const long long g = start + i;
    dst[i] = (g >= 0 && g < t_len) ? __fmul_rn(src[g], win[i]) : 0.0f;
  }
}

}  // namespace

extern "C" int bk_frames_windowed(const float* audio, const int* starts,
                                  const float* win, float* out, int streams,
                                  int channels, int t_len, int frames,
                                  int block, cudaStream_t stream) {
  const long long rows = static_cast<long long>(streams) * frames * channels;
  if (rows == 0 || block == 0) return 0;
  frames_windowed_kernel<<<static_cast<unsigned>(rows), 256, 0, stream>>>(
      audio, starts, win, out, channels, t_len, frames, block);
  return static_cast<int>(cudaGetLastError());
}
