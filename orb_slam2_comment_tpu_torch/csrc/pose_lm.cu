// K3: motion-only bundle adjustment (pose-only LM) in one kernel.
//
// Replaces orb_slam2_comment_tpu/ops/lm_pallas.py::pose_optimize_pallas
// (kernel _make_kernel) and follows it where it differs from the XLA path
// of optim.pose_optimize: the depth clamp is where(|z|<1e-9, 1e-9, z), the
// damping is H_ii*(1+lambda)+1e-9, the solve is an unrolled 6x6 Cholesky
// and the pose update is a left SE3-exp with eps 1e-12. 4 rounds x 10 LM
// iterations, Huber in the first 2 rounds, chi2 reclassification of the
// inlier mask between rounds. The start and final poses are projected onto
// SO(3) by Gram-Schmidt (geometry.orthonormalize_R, eps 1e-8).
//
// Bound on the H100: ~1000 edges x 30 bytes in and ~12 MFLOP, so the bound
// is well under a microsecond; what costs is the chain of 40 dependent LM
// iterations, each a pass over the edges, a block reduction and a 6x6
// solve. One pose runs on one SM, so the pass is bound by that SM's issue
// rate and the rest by latency. The design keeps that chain short:
//  - every edge is loaded once, into shared memory (X, level weight,
//    observation, stereo and valid flags); each thread owns the edges
//    tid, tid + NT, ... and keeps their inlier mask as bits in a register
//    for all 40 iterations, so no barrier guards the edge data;
//  - one pass per iteration: at the candidate pose it forms the robust
//    cost AND the 21 + 6 normal-equation sums (Huber weights at that pose).
//    On accept those sums are the next iteration's H and b; on reject the
//    pose did not move, so the stored H and b are still exact. A round's
//    opening pass also applies the previous round's chi2 reclassification
//    (edge-local) and gives the first H and b. This is the reference's
//    arithmetic, not an approximation;
//  - one barrier per iteration: each warp reduces the 28 values with a
//    reduce-scatter butterfly (31 shuffles; lane q ends with value q),
//    writes them to double-buffered shared memory, and after one
//    __syncthreads every warp sums the warp partials in the same fixed
//    order, then runs the damped Cholesky, the SE3-exp and the accept test
//    redundantly. Every thread holds the same pose, lambda and cost with no
//    broadcast barrier. No float atomics: reruns are bit-identical.
//
// Batch axis: one block per pose over its own [n] edge set; per-edge inputs
// carry a batch stride (0 for inputs shared by every pose). A pose comes
// out the same whatever the batch it rides in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr float EPS = 1e-12f;
constexpr float ORTHO_EPS = 1e-8f;
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float HUBER_MONO = 2.44765186f;    // float(sqrt(5.991))
constexpr float HUBER_STEREO = 2.79553223f;  // float(sqrt(7.815))
constexpr int FLAG_STEREO = 1, FLAG_VALID = 2;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// One butterfly step of the reduce-scatter: lanes with bit HALF set keep
// the upper half of their values, the others the lower half, and each adds
// its partner's copy of the half it keeps.
template <int HALF>
__device__ __forceinline__ void rs_step(float (&v)[32], bool upper) {
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF];
    const float keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// 32 values per lane -> lane q holds the block total of value q, in every
// warp. s_part is one [NWARP][32] buffer; alternate buffers between calls.
__device__ __forceinline__ float block_total(float (&v)[32], float (*s_part)[32]) {
  const int lane = threadIdx.x & 31;
  rs_step<16>(v, lane & 16);
  rs_step<8>(v, lane & 8);
  rs_step<4>(v, lane & 4);
  rs_step<2>(v, lane & 2);
  rs_step<1>(v, lane & 1);
  s_part[threadIdx.x >> 5][lane] = v[0];
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) t += s_part[w][lane];
  return t;
}

__device__ __forceinline__ float lane_value(float v, int q) {
  return __shfl_sync(0xffffffffu, v, q);
}

// pose = (R row-major, t). Gram-Schmidt on the columns of R.
__device__ void orthonormalize(float (&p)[12]) {
  float x0 = p[0], x1 = p[3], x2 = p[6];
  const float nx = fmaxf(sqrtf(x0 * x0 + x1 * x1 + x2 * x2), ORTHO_EPS);
  x0 /= nx;
  x1 /= nx;
  x2 /= nx;
  const float d = x0 * p[1] + x1 * p[4] + x2 * p[7];
  float y0 = p[1] - d * x0, y1 = p[4] - d * x1, y2 = p[7] - d * x2;
  const float ny = fmaxf(sqrtf(y0 * y0 + y1 * y1 + y2 * y2), ORTHO_EPS);
  y0 /= ny;
  y1 /= ny;
  y2 /= ny;
  p[0] = x0; p[1] = y0; p[2] = x1 * y2 - x2 * y1;
  p[3] = x1; p[4] = y1; p[5] = x2 * y0 - x0 * y2;
  p[6] = x2; p[7] = y2; p[8] = x0 * y1 - x1 * y0;
}

// Solve (H + damping) dx = b, H packed lower-triangular at j*(j+1)/2 + i.
__device__ void chol6_solve(float (&H)[21], const float (&b)[6], float (&x)[6]) {
  float L[6][6], inv_d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i * (i + 1) / 2 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    inv_d[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float t = H[j * (j + 1) / 2 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv_d[i];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv_d[i];
  }
}

// out = exp(dx) * pose
__device__ void se3_left_update(const float (&dx)[6], const float (&pose)[12],
                                float (&out)[12]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(th2 + EPS);
  const bool small = th2 <= EPS;
  // sin and cos of th as sinpi/cospi of th/pi: full precision, and no
  // Payne-Hanek reduction (its local array would give the kernel a stack)
  float sn, cs;
  sincospif(th * 0.318309886f, &sn, &cs);
  const float a = small ? 1.0f - th2 / 6.0f : sn / th;
  const float bb = small ? 0.5f - th2 / 24.0f : (1.0f - cs) / (th2 + EPS);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sn) / (th2 * th + EPS);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float Rd[3][3], td[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Ji[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float e = i == j ? 1.0f : 0.0f;
      Rd[i][j] = e + a * W[i][j] + bb * w2;
      Ji[j] = e + bb * W[i][j] + cc * w2;
    }
    td[i] = Ji[0] * dx[0] + Ji[1] * dx[1] + Ji[2] * dx[2];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = Rd[i][0] * pose[j] + Rd[i][1] * pose[3 + j] + Rd[i][2] * pose[6 + j];
    out[9 + i] = Rd[i][0] * pose[9] + Rd[i][1] * pose[10] + Rd[i][2] * pose[11] + td[i];
  }
}

// One pass over this thread's edges at pose p: acc[0..20] H (lower), acc[21..26]
// b, acc[27] the robust (or plain) cost; acc[28..31] stay 0. With reclass,
// each edge's mask bit is first set from the unmasked chi2 at p.
__device__ __forceinline__ void edge_pass(const float (&p)[12], const float4* __restrict__ s_xw,
                                          const float4* __restrict__ s_ob, int n, const Cam& k,
                                          bool robust, bool reclass, uint32_t& mbits,
                                          float (&acc)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
  int kk = 0;
  for (int i = threadIdx.x; i < n; i += NT, ++kk) {
    const float4 a = s_xw[i];
    const float4 o = s_ob[i];
    const int fl = __float_as_int(o.w);
    const bool st = fl & FLAG_STEREO;
    const float xc = p[0] * a.x + p[1] * a.y + p[2] * a.z + p[9];
    const float yc = p[3] * a.x + p[4] * a.y + p[5] * a.z + p[10];
    const float zc = p[6] * a.x + p[7] * a.y + p[8] * a.z + p[11];
    const float zi = 1.0f / (fabsf(zc) < 1e-9f ? 1e-9f : zc);
    const float up = k.fx * xc * zi + k.cx;
    const float vp = k.fy * yc * zi + k.cy;
    const float ru = o.x - up;
    const float rv = o.y - vp;
    const float rur = o.z - (up - k.bf * zi);
    const float comp = st ? 1.0f : 0.0f;
    const float c2 = a.w * (ru * ru + rv * rv + comp * rur * rur);
    if (reclass) {
      const bool in = c2 <= (st ? CHI2_STEREO : CHI2_MONO) && zc > 0.0f && (fl & FLAG_VALID);
      mbits = (mbits & ~(1u << kk)) | ((in ? 1u : 0u) << kk);
    }
    if (!((mbits >> kk) & 1u)) continue;  // masked edge: contributes exactly zero
    const float delta = st ? HUBER_STEREO : HUBER_MONO;
    const float d2 = delta * delta;
    float hw = 1.0f;
    if (robust) {
      acc[27] += c2 <= d2 ? c2 : 2.0f * delta * sqrtf(fmaxf(c2, EPS)) - d2;
      hw = fminf(1.0f, delta / sqrtf(fmaxf(c2, EPS)));
    } else {
      acc[27] += c2;
    }
    const float w = a.w * hw;
    const float wc = w * comp;
    const float gxu = k.fx * zi;
    const float gzu = -k.fx * xc * zi * zi;
    const float gyv = k.fy * zi;
    const float gzv = -k.fy * yc * zi * zi;
    const float gzur = gzu + k.bf * zi * zi;
    const float Ju[6] = {-gxu, 0.0f, -gzu, -gzu * yc, -(gxu * zc - gzu * xc), gxu * yc};
    const float Jv[6] = {0.0f, -gyv, -gzv, gyv * zc - gzv * yc, gzv * xc, -gyv * xc};
    const float Jr[6] = {-gxu, 0.0f, -gzur, -gzur * yc, -(gxu * zc - gzur * xc), gxu * yc};
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const float wu = w * Ju[u], wv = w * Jv[u], wr = wc * Jr[u];
#pragma unroll
      for (int v = 0; v <= u; ++v) acc[u * (u + 1) / 2 + v] += wu * Ju[v] + wv * Jv[v] + wr * Jr[v];
      acc[21 + u] -= wu * ru + wv * rv + wr * rur;
    }
  }
}

__global__ void __launch_bounds__(NT) pose_lm_kernel(
    const float* __restrict__ Tcw0, const float* __restrict__ X, const float* __restrict__ O,
    const int* __restrict__ octave, const uint8_t* __restrict__ stereo,
    const uint8_t* __restrict__ valid, const float* __restrict__ invs2_levels,
    float* __restrict__ Tcw_out, uint8_t* __restrict__ inliers, int* __restrict__ n_inliers,
    int n, int n_levels, int sX, int sO, int sOct, int sSt, int sVal, Cam k, int rounds,
    int iters, int robust_rounds) {
  extern __shared__ float4 s_edges[];
  float4* s_xw = s_edges;      // X, level weight
  float4* s_ob = s_edges + n;  // observation, flags
  __shared__ float s_part[2][NWARP][32];
  __shared__ int s_cnt[NWARP];
  const int b = blockIdx.x;
  X += (size_t)b * sX;
  O += (size_t)b * sO;
  octave += (size_t)b * sOct;
  stereo += (size_t)b * sSt;
  valid += (size_t)b * sVal;

  // each thread loads, and later reads, only its own edges
  uint32_t mbits = 0u;
  int kk = 0;
  for (int i = threadIdx.x; i < n; i += NT, ++kk) {
    const int lv = min(max(octave[i], 0), n_levels - 1);
    const bool vd = valid[i] != 0;
    s_xw[i] = make_float4(X[3 * i], X[3 * i + 1], X[3 * i + 2], invs2_levels[lv]);
    s_ob[i] = make_float4(O[3 * i], O[3 * i + 1], O[3 * i + 2],
                          __int_as_float((stereo[i] ? FLAG_STEREO : 0) | (vd ? FLAG_VALID : 0)));
    mbits |= (vd ? 1u : 0u) << kk;
  }
  float T[12];
  {
    const float* t0 = Tcw0 + 16 * b;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) T[3 * r + c] = t0[4 * r + c];
      T[9 + r] = t0[4 * r + 3];
    }
  }
  orthonormalize(T);

  float acc[32];
  int buf = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const bool robust = rd < robust_rounds;
    edge_pass(T, s_xw, s_ob, n, k, robust, rd > 0, mbits, acc);
    float hb = block_total(acc, s_part[buf]);  // lane q: H/b value q, lane 27: cost
    buf ^= 1;
    float cost = lane_value(hb, 27);
    float lam = 1e-3f;
    for (int it = 0; it < iters; ++it) {
      float H[21], bv[6], dx[6], Tn[12];
#pragma unroll
      for (int q = 0; q < 21; ++q) H[q] = lane_value(hb, q);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        bv[q] = lane_value(hb, 21 + q);
        H[q * (q + 1) / 2 + q] = H[q * (q + 1) / 2 + q] * (1.0f + lam) + 1e-9f;
      }
      chol6_solve(H, bv, dx);
      se3_left_update(dx, T, Tn);
      edge_pass(Tn, s_xw, s_ob, n, k, robust, false, mbits, acc);
      const float hb_new = block_total(acc, s_part[buf]);
      buf ^= 1;
      const float new_cost = lane_value(hb_new, 27);
      if (new_cost < cost) {
#pragma unroll
        for (int q = 0; q < 12; ++q) T[q] = Tn[q];
        hb = hb_new;
        cost = new_cost;
        lam = fmaxf(lam * 0.5f, 1e-9f);
      } else {
        lam = fminf(lam * 4.0f, 1e6f);
      }
    }
  }
  // the last round's chi2 reclassification gives the inliers
  edge_pass(T, s_xw, s_ob, n, k, false, rounds > 0, mbits, acc);
  kk = 0;
  inliers += (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += NT, ++kk) inliers[i] = (mbits >> kk) & 1u;
  const int cnt = __reduce_add_sync(0xffffffffu, __popc(mbits));
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < NWARP; ++w) total += s_cnt[w];
    n_inliers[b] = total;
    orthonormalize(T);
    float* out = Tcw_out + 16 * b;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[4 * r + c] = T[3 * r + c];
      out[4 * r + 3] = T[9 + r];
    }
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
  }
}

}  // namespace

extern "C" int slam_pose_lm(const float* Tcw0, const float* X, const float* O,
                            const int* octave, const uint8_t* stereo, const uint8_t* valid,
                            const float* invs2_levels, float* Tcw_out, uint8_t* inliers,
                            int* n_inliers, int B, int n, int n_levels, int sX, int sO,
                            int sOct, int sSt, int sVal, float fx, float fy, float cx,
                            float cy, float bf, int rounds, int iters, int robust_rounds,
                            void* stream) {
  if (n > 32 * NT) return (int)cudaErrorInvalidValue;  // one mask bit per owned edge
  const size_t smem = (size_t)2 * n * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Cam k{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(
      Tcw0, X, O, octave, stereo, valid, invs2_levels, Tcw_out, inliers, n_inliers, n,
      n_levels, sX, sO, sOct, sSt, sVal, k, rounds, iters, robust_rounds);
  return (int)cudaGetLastError();
}
