// K2: gather one 48x48 f32 patch per keypoint from the zero-padded pyramid
// level stack.
//
// Replaces orb_slam2_comment_tpu/ops/orb.py::gather_patches_pallas. The
// TPU kernel copied tile-aligned 56x256 superblocks and realigned them with
// lane rolls because Mosaic DMAs must start on the (8,128) tile grid; a GPU
// load has no such rule, so each patch is copied directly.
//
// Bound on the H100: ~1000 patches x 9 KB = 9 MB read and written per
// frame, a few microseconds of HBM time; the kernel is bound by launch
// latency and by the 192-byte row segments (48 floats), which a warp reads
// as coalesced 32-float runs. Design: one warp per patch, lanes stride over
// the 2304 elements row-major so consecutive lanes touch consecutive
// addresses within a row. Starts are clamped into the stack exactly as
// jax.lax.dynamic_slice clamps them, so out-of-range starts behave like the
// plain version.

#include <cuda_runtime.h>

namespace {

constexpr int P = 48;
constexpr int WARPS_PER_BLOCK = 8;

__global__ void gather_patches_kernel(const float* __restrict__ padded,
                                      const int* __restrict__ lyx,
                                      float* __restrict__ out,
                                      int n, int L, int Hp, int Wp) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const int l = min(max(lyx[warp * 3 + 0], 0), L - 1);
  const int y0 = min(max(lyx[warp * 3 + 1], 0), Hp - P);
  const int x0 = min(max(lyx[warp * 3 + 2], 0), Wp - P);
  const float* src = padded + ((size_t)l * Hp + y0) * Wp + x0;
  float* dst = out + (size_t)warp * P * P;
  for (int i = lane; i < P * P; i += 32) {
    const int r = i / P, c = i - r * P;
    dst[i] = src[(size_t)r * Wp + c];
  }
}

}  // namespace

extern "C" int slam_gather_patches(const float* padded, const int* lyx,
                                   float* out, int n, int L, int Hp, int Wp,
                                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  gather_patches_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
      padded, lyx, out, n, L, Hp, Wp);
  return (int)cudaGetLastError();
}
