// The earlier design of K1 (one launch per pyramid level), kept so that
// chip_smoke.py can time csrc/fast_nms.cu against it in turns.
//
// K1: dense FAST-9/16 score + EDGE_THRESHOLD border mask + 3x3 NMS.
//
// Replaces orb_slam2_comment_tpu/ops/orb.py::fast_nms_pallas (kernel body
// _fast_nms_kernel). Output equals the plain version
// _nms3(where(inb, fast_score_map(img), 0)) bit for bit: the score is
// max/min of f32 differences (exact), and the NMS keeps the lexicographic
// (score desc, flat index asc) maximum of each 3x3 window.
//
// Bound on the H100: one level is at most 480x640 f32 (1.2 MB in, 1.2 MB
// out), far below what the memory system moves in a microsecond; the work
// is ~16 subtractions and ~300 min/max per pixel, so the kernel is bound by
// launch latency and by its arithmetic, not by bytes. Design: each block
// owns a 32x8 output tile, loads the tile plus a 4-pixel halo (3 for the
// FAST ring, 1 for the NMS window) into shared memory once, computes the
// masked score of the tile plus a 1-pixel ring into shared memory, then
// runs the NMS from shared memory. Global memory is read once and written
// once per pixel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 8;
constexpr int HALO = 4;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;

// FAST ring (dx, dy), the order of orb.py::_RING
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out,
                                int h, int w, int margin) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[TH + 2][TW + 2];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  // tile + halo, edge-clamped like jnp.pad(mode="edge")
  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ly = i / SW, lx = i % SW;
    const int gy = min(max(y0 + ly - HALO, 0), h - 1);
    const int gx = min(max(x0 + lx - HALO, 0), w - 1);
    s_img[ly][lx] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  // masked FAST score on the tile plus a 1-pixel ring
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthreads) {
    const int ly = i / (TW + 2), lx = i % (TW + 2);
    const int gy = y0 + ly - 1, gx = x0 + lx - 1;
    float score = 0.0f;
    const bool inb = gy >= margin && gy < h - margin &&
                     gx >= margin && gx < w - margin;
    if (inb) {
      const int cy = ly + HALO - 1, cx = lx + HALO - 1;
      const float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + RING_DY[k]][cx + RING_DX[k]] - c;
      float best = -INFINITY;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mb = d[k];
        float md = -d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          const float v = d[(k + j) & 15];
          mb = fminf(mb, v);
          md = fminf(md, -v);
        }
        best = fmaxf(best, fmaxf(mb, md));
      }
      score = best;
    }
    s_score[ly][lx] = score;
  }
  __syncthreads();

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int gx = x0 + lx, gy = y0 + ly;
  if (gx >= w || gy >= h) return;
  const float sc = s_score[ly + 1][lx + 1];
  const int my_idx = gy * w + gx;
  float best_v = sc;
  int best_i = my_idx;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx == 0 && dy == 0) continue;
      const int ny = gy + dy, nx = gx + dx;
      float v;
      int i2;
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) {
        v = -INFINITY;
        i2 = 1 << 30;
      } else {
        v = s_score[ly + 1 + dy][lx + 1 + dx];
        i2 = ny * w + nx;
      }
      if (v > best_v || (v == best_v && i2 < best_i)) {
        best_v = v;
        best_i = i2;
      }
    }
  }
  out[(size_t)gy * w + gx] = (best_i == my_idx) ? sc : 0.0f;
}

}  // namespace

extern "C" int slam_prev_fast_nms(const float* img, float* out, int h, int w,
                             int margin, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, h, w, margin);
  return (int)cudaGetLastError();
}
