// K1: dense FAST-9/16 score + EDGE_THRESHOLD border mask + 3x3 NMS over
// every pyramid level of a frame, in one launch.
//
// Replaces orb_slam2_comment_tpu/ops/orb.py::fast_nms_pallas (kernel body
// _fast_nms_kernel), which the JAX package calls once per level. For each
// level l the output equals the plain version
// _nms3(where(inb, fast_score_map(level), 0)) under torch.equal: the score
// is min/max of f32 differences, exact in any order, and the NMS keeps the
// lexicographic (score desc, flat index y * w_l + x asc) maximum of each
// 3x3 window. The one thing allowed to differ is the sign of a zero score:
// the plain version forms min(-d) where this kernel forms -max(d), and
// -0.0 == +0.0 under torch.equal and under every compare downstream.
//
// Input: the zero-padded level stack [L, Hp, Wp] that K2 gathers from
// (ops/orb.py::_level_stack): level l at [l, pad + y, pad + x], zeros
// around it. The plain version edge-replicates each level; reading the
// stack's zeros instead is exact because only pixels inside the mask
// (>= EDGE_THRESHOLD = 19 px from the level's border) get a score: their
// 3-px ring lies inside the level, the 1-px NMS window of such a pixel
// lies inside the level, and every pixel outside the mask is written as 0
// whatever its ring would read. So zeros, edge replication or anything
// else around the level give the same output.
//
// Output: one flat f32 buffer, level l's [h_l, w_l] scores at out_off[l].
//
// Bound on the H100: ~950K pixels in and out (7.6 MB, ~2.3 us at 3.35
// TB/s) against ~177 min/max issue slots per pixel inside the mask (~8.1 us
// at 64 min/max per SM per clock, 132 SMs at 1.98 GHz), so the work is
// bound by the min/max issue rate. Design:
// - One launch: a flat grid of 30x30 output tiles over all levels (1143
//   blocks at 480x640); a block finds its level from the prefix of tile
//   counts in the parameter struct (passed by value). Tiles that lie
//   wholly inside a level's masked border write zeros and return.
// - A block loads its 38x38 image window (tile + 1-px NMS ring + 3-px FAST
//   ring) into shared memory once, then each warp scores a 4-row strip of
//   the 32x32 score window, one column per lane: 1024 scores for 900
//   outputs, 4 per thread, no second round; pixels outside the mask are
//   not scored. At 40 registers 6 blocks fit an SM, so the 1143 blocks
//   run in ~1.4 waves and later blocks load while earlier ones compute;
//   30-row tiles measured faster than 14, 62 or 126 rows
//   (prev_kernels/k1_variants.py; PERF.md, PR 4).
// - Arc extrema by doubling on the 16 ring differences d: running minima
//   over 2, 4 and 8 contiguous elements (circular), min9[k] =
//   min(min8[k], d[k+8]), bright = max_k min9[k]; the dark side is
//   -min_k max9[k] with the same doubling in fmaxf. 64 + 15 per polarity
//   instead of 128 + 15 + 16 negations.
// - NMS from shared memory: a pixel is kept iff every neighbour earlier in
//   raster order scores strictly less and every later one no more, which
//   is the plain version's sequential tie-break.
// SIMT only: the work is min/max on f32 values, nothing for tensor cores,
// TMA or clusters.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int OUT_H = 30;             // output tile rows
constexpr int OUT_W = 30;             // output tile columns
constexpr int SC_H = OUT_H + 2;       // score window: tile + 1-px NMS ring
constexpr int SC_W = OUT_W + 2;       // = 32, one column per lane
constexpr int IM_H = SC_H + 6;        // image window: + 3-px FAST ring
constexpr int IM_W = SC_W + 6;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS_PER_WARP = SC_H / WARPS;
static_assert(SC_W == 32 && SC_H % WARPS == 0, "one lane per column, equal strips");

struct Levels {
  int n_levels, Hp, Wp, pad, margin;
  int h[MAX_LEVELS], w[MAX_LEVELS], tiles_x[MAX_LEVELS], out_off[MAX_LEVELS];
  int tile_start[MAX_LEVELS + 1];     // prefix of tile counts
};

// The 16 ring differences of the centre at p (row stride IM_W), in the
// order of orb.py::_RING (dx, dy).
__device__ __forceinline__ void ring_diffs(const float* p, float d[16]) {
  const float c = p[0];
  d[0] = p[-3 * IM_W] - c;
  d[1] = p[-3 * IM_W + 1] - c;
  d[2] = p[-2 * IM_W + 2] - c;
  d[3] = p[-IM_W + 3] - c;
  d[4] = p[3] - c;
  d[5] = p[IM_W + 3] - c;
  d[6] = p[2 * IM_W + 2] - c;
  d[7] = p[3 * IM_W + 1] - c;
  d[8] = p[3 * IM_W] - c;
  d[9] = p[3 * IM_W - 1] - c;
  d[10] = p[2 * IM_W - 2] - c;
  d[11] = p[IM_W - 3] - c;
  d[12] = p[-3] - c;
  d[13] = p[-IM_W - 3] - c;
  d[14] = p[-2 * IM_W - 2] - c;
  d[15] = p[-3 * IM_W - 1] - c;
}

// max over the 16 circular 9-arcs of min(d) (bright), and of min(-d) =
// -max(d) (dark), by doubling.
__device__ __forceinline__ float fast_score(const float* p) {
  float d[16], a[16], b[16], t[16], u[16];
  ring_diffs(p, d);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a[k] = fminf(d[k], d[(k + 1) & 15]);
    b[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    t[k] = fminf(a[k], a[(k + 2) & 15]);
    u[k] = fmaxf(b[k], b[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    a[k] = fminf(t[k], t[(k + 4) & 15]);
    b[k] = fmaxf(u[k], u[(k + 4) & 15]);
  }
  float bright = fminf(a[0], d[8]);
  float dark = fmaxf(b[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    bright = fmaxf(bright, fminf(a[k], d[(k + 8) & 15]));
    dark = fminf(dark, fmaxf(b[k], d[(k + 8) & 15]));
  }
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(THREADS)
fast_nms_levels_kernel(const float* __restrict__ stack, float* __restrict__ out,
                       const Levels p) {
  __shared__ float s_img[IM_H][IM_W];
  __shared__ float s_score[SC_H][SC_W];

  // this block's level and tile
  int t = blockIdx.x, l = 0;
  while (l + 1 < p.n_levels && t >= p.tile_start[l + 1]) ++l;
  t -= p.tile_start[l];
  const int h = p.h[l], w = p.w[l], m = p.margin;
  const int y0 = (t / p.tiles_x[l]) * OUT_H;
  const int x0 = (t % p.tiles_x[l]) * OUT_W;
  const int y_end = min(y0 + OUT_H, h), x_end = min(x0 + OUT_W, w);
  float* __restrict__ lvl_out = out + p.out_off[l];
  const int tid = threadIdx.x;

  if (y_end <= m || y0 >= h - m || x_end <= m || x0 >= w - m) {
    // wholly inside the masked border
    for (int i = tid; i < OUT_H * OUT_W; i += THREADS) {
      const int y = y0 + i / OUT_W, x = x0 + i % OUT_W;
      if (y < y_end && x < x_end) lvl_out[y * w + x] = 0.0f;
    }
    return;
  }

  // image window: level rows y0-4 .. y0+OUT_H+3, columns x0-4 ..
  // x0+OUT_W+3, read from the stack (outside the stack it is never used,
  // see the header)
  const float* __restrict__ lvl_in = stack + (size_t)l * p.Hp * p.Wp;
  for (int i = tid; i < IM_H * IM_W; i += THREADS) {
    const int r = i / IM_W, c = i % IM_W;
    const int sy = y0 - 4 + r + p.pad, sx = x0 - 4 + c + p.pad;
    s_img[r][c] = (sy >= 0 && sy < p.Hp && sx >= 0 && sx < p.Wp)
                      ? lvl_in[(size_t)sy * p.Wp + sx] : 0.0f;
  }
  __syncthreads();

  // masked scores of the score window: level row y0-1+r, column x0-1+lane
  const int lane = tid & 31, warp = tid >> 5;
  const int x = x0 - 1 + lane;
  const bool col_in = x >= m && x < w - m;
#pragma unroll 1
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int y = y0 - 1 + r;
    float s = 0.0f;
    if (col_in && y >= m && y < h - m) s = fast_score(&s_img[r + 3][lane + 3]);
    s_score[r][lane] = s;
  }
  __syncthreads();

  // 3x3 NMS of the tile's own pixels (window rows 1..OUT_H, lanes 1..OUT_W)
  if (lane < 1 || lane > OUT_W || x >= w) return;
#pragma unroll 1
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int y = y0 - 1 + r;
    if (r < 1 || r > OUT_H || y >= h) continue;
    const float s = s_score[r][lane];
    float v = 0.0f;
    if (col_in && y >= m && y < h - m) {
      const bool keep = s_score[r - 1][lane - 1] < s && s_score[r - 1][lane] < s &&
                        s_score[r - 1][lane + 1] < s && s_score[r][lane - 1] < s &&
                        s_score[r][lane + 1] <= s && s_score[r + 1][lane - 1] <= s &&
                        s_score[r + 1][lane] <= s && s_score[r + 1][lane + 1] <= s;
      v = keep ? s : 0.0f;
    }
    lvl_out[y * w + x] = v;
  }
}

}  // namespace

// table: n_levels, Hp, Wp, pad, margin, tile rows, tile columns, then
// h[L], w[L], tiles_x[L], out_off[L], tile_start[L + 1] (host memory; see
// ops/orb.py::k1_table). Returns cudaErrorInvalidValue for a table this
// build cannot take.
extern "C" int slam_fast_nms(const float* stack, float* out, const int* table,
                             void* stream) {
  Levels p;
  const int L = table[0];
  if (L < 1 || L > MAX_LEVELS || table[5] != OUT_H || table[6] != OUT_W)
    return (int)cudaErrorInvalidValue;
  p.n_levels = L;
  p.Hp = table[1];
  p.Wp = table[2];
  p.pad = table[3];
  p.margin = table[4];
  const int* v = table + 7;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    const bool on = i < L;
    p.h[i] = on ? v[i] : 0;
    p.w[i] = on ? v[L + i] : 0;
    p.tiles_x[i] = on ? v[2 * L + i] : 1;
    p.out_off[i] = on ? v[3 * L + i] : 0;
  }
  for (int i = 0; i <= MAX_LEVELS; ++i) p.tile_start[i] = v[4 * L + min(i, L)];
  const int n_tiles = p.tile_start[L];
  fast_nms_levels_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(stack, out, p);
  return (int)cudaGetLastError();
}
