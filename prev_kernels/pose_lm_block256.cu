// The earlier design of K3 (one 256-thread block per pose, two passes, five
// barriers and two single-thread sections per LM iteration), kept only so
// that chip_smoke.py can time the redesigned kernel against it in one run.
// The port does not use it.
//
// K3: motion-only bundle adjustment (pose-only LM) in one kernel.
//
// Replaces orb_slam2_comment_tpu/ops/lm_pallas.py::pose_optimize_pallas
// (kernel _make_kernel) and follows it where it differs from the XLA path
// of optim.pose_optimize: the depth clamp is where(|z|<1e-9, 1e-9, z), the
// damping is H_ii*(1+lambda)+1e-9, the solve is the unrolled Cholesky of
// _chol6_solve and the pose update is a left SE3-exp with eps 1e-12.
// 4 rounds x 10 LM iterations, Huber in the first 2 rounds, chi2
// reclassification of the inlier mask between rounds.
//
// Bound on the H100: the data is ~1000 edges x 44 bytes, which stays in L1;
// the 40 iterations are strictly sequential, each one a pass over the edges,
// a 27-value block reduction, a 6x6 solve and a second pass for the
// candidate cost. The kernel is bound by that dependency chain (block
// barriers and one thread's solve), not by bytes or FLOPs. Design: one
// block of 256 threads per pose keeps all 40 iterations inside the kernel,
// so the host launches once instead of ~400 small ops. Threads stride over
// the edges; warp shuffles plus a fixed-order sum over warps form the 27
// sums deterministically; thread 0 solves and broadcasts the candidate pose
// through shared memory. The per-edge inlier mask lives in the output array
// and each edge is only ever touched by the thread that owns it.
//
// Batch axis: the grid has one block per pose, and block b solves pose b
// over its own [n] edge set (inputs [B, n, ...], poses [B, 12]).
// Relocalization solves its 5 candidate poses in one launch this way;
// tracking launches B = 1. Each block runs the single-pose code, so a pose
// comes out the same whatever the batch it rides in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr float EPS = 1e-12f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum NV per-thread values over the block, in a fixed order. Every thread
// must call it; the result is in s_out[0..NV) after the call.
template <int NV>
__device__ void block_sum(const float (&v)[NV], float* s_part, float* s_out) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float x = warp_sum(v[k]);
    if (lane == 0) s_part[k * NWARP + wid] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float acc = 0.0f;
    for (int w = 0; w < NWARP; ++w) acc += s_part[threadIdx.x * NWARP + w];
    s_out[threadIdx.x] = acc;
  }
  __syncthreads();
}

struct Res {
  float ru, rv, rur, xc, yc, zc, zi;
};

__device__ __forceinline__ Res residual(const float* p, const float* X,
                                        const float* O, int i, const Cam& k) {
  const float x = X[3 * i], y = X[3 * i + 1], z = X[3 * i + 2];
  Res r;
  r.xc = p[0] * x + p[1] * y + p[2] * z + p[9];
  r.yc = p[3] * x + p[4] * y + p[5] * z + p[10];
  r.zc = p[6] * x + p[7] * y + p[8] * z + p[11];
  r.zi = 1.0f / (fabsf(r.zc) < 1e-9f ? 1e-9f : r.zc);
  const float up = k.fx * r.xc * r.zi + k.cx;
  const float vp = k.fy * r.yc * r.zi + k.cy;
  const float urp = up - k.bf * r.zi;
  r.ru = O[3 * i] - up;
  r.rv = O[3 * i + 1] - vp;
  r.rur = O[3 * i + 2] - urp;
  return r;
}

__device__ __forceinline__ float cost_term(const Res& r, float invs2, float comp,
                                           float mask, float delta, bool robust) {
  const float c2 = invs2 * (r.ru * r.ru + r.rv * r.rv + comp * r.rur * r.rur) * mask;
  if (!robust) return c2;
  if (mask <= 0.0f) return 0.0f;
  const float d2 = delta * delta;
  return c2 <= d2 * mask ? c2 : 2.0f * delta * sqrtf(fmaxf(c2, EPS)) - d2;
}

__device__ void chol6_solve(const float (&H)[21], const float (&b)[6], float (&x)[6]) {
  // H packed lower-triangular: H(j, i) with j >= i at j*(j+1)/2 + i
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = H[i * (i + 1) / 2 + i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * L[i][k];
    L[i][i] = sqrtf(fmaxf(s, 1e-12f));
    const float inv_d = 1.0f / L[i][i];
    for (int j = i + 1; j < 6; ++j) {
      float t = H[j * (j + 1) / 2 + i];
      for (int k = 0; k < i; ++k) t -= L[j][k] * L[i][k];
      L[j][i] = t * inv_d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// pose_new = exp(dx) * pose, pose = (R row-major, t)
__device__ void se3_left_update(const float (&dx)[6], const float* pose, float* out) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float th2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(th2 + EPS);
  const bool small = th2 <= EPS;
  const float a = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float bb = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / (th2 + EPS);
  const float cc = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sinf(th)) / (th2 * th + EPS);
  const float W[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float W2[3][3], Rd[3][3], J[3][3], td[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      Rd[i][j] = e + a * W[i][j] + bb * W2[i][j];
      J[i][j] = e + bb * W[i][j] + cc * W2[i][j];
    }
  for (int i = 0; i < 3; ++i) td[i] = J[i][0] * dx[0] + J[i][1] * dx[1] + J[i][2] * dx[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = Rd[i][0] * pose[j] + Rd[i][1] * pose[3 + j] + Rd[i][2] * pose[6 + j];
    out[9 + i] = Rd[i][0] * pose[9] + Rd[i][1] * pose[10] + Rd[i][2] * pose[11] + td[i];
  }
}

__global__ void __launch_bounds__(NT) pose_lm_kernel(
    const float* __restrict__ X, const float* __restrict__ O,
    const float* __restrict__ invs2, const float* __restrict__ comp,
    const float* __restrict__ valid, const float* __restrict__ delta,
    const float* __restrict__ chi2th, const float* __restrict__ pose0,
    float* __restrict__ pose_out, float* __restrict__ mask, int n, Cam k,
    int rounds, int iters, int robust_rounds) {
  __shared__ float s_part[27 * NWARP];
  __shared__ float s_sum[27];
  __shared__ float s_pose[12];
  __shared__ float s_new[12];
  __shared__ float s_lam, s_cost;
  const int tid = threadIdx.x;
  const size_t pb = blockIdx.x;  // this block's pose
  X += pb * 3 * n;
  O += pb * 3 * n;
  invs2 += pb * n;
  comp += pb * n;
  valid += pb * n;
  delta += pb * n;
  chi2th += pb * n;
  pose0 += pb * 12;
  pose_out += pb * 12;
  mask += pb * n;
  if (tid < 12) s_pose[tid] = pose0[tid];
  for (int i = tid; i < n; i += NT) mask[i] = valid[i];
  __syncthreads();

  for (int rd = 0; rd < rounds; ++rd) {
    const bool robust = rd < robust_rounds;
    {
      float c[1] = {0.0f};
      for (int i = tid; i < n; i += NT) {
        const Res r = residual(s_pose, X, O, i, k);
        c[0] += cost_term(r, invs2[i], comp[i], mask[i], delta[i], robust);
      }
      block_sum<1>(c, s_part, s_sum);
      if (tid == 0) {
        s_cost = s_sum[0];
        s_lam = 1e-3f;
      }
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      float acc[27];
#pragma unroll
      for (int q = 0; q < 27; ++q) acc[q] = 0.0f;
      for (int i = tid; i < n; i += NT) {
        const float m = mask[i];
        const Res r = residual(s_pose, X, O, i, k);
        const float c2 = invs2[i] * (r.ru * r.ru + r.rv * r.rv +
                                     comp[i] * r.rur * r.rur) * m;
        const float hw = robust ? fminf(1.0f, delta[i] / sqrtf(fmaxf(c2, EPS))) : 1.0f;
        const float w = invs2[i] * hw * m;
        if (w == 0.0f) continue;  // masked edge: contributes exactly zero
        const float wc = w * comp[i];
        const float gxu = k.fx * r.zi;
        const float gzu = -k.fx * r.xc * r.zi * r.zi;
        const float gyv = k.fy * r.zi;
        const float gzv = -k.fy * r.yc * r.zi * r.zi;
        const float gzur = gzu + k.bf * r.zi * r.zi;
        const float Ju[6] = {-gxu, 0.0f, -gzu, -gzu * r.yc,
                             -(gxu * r.zc - gzu * r.xc), gxu * r.yc};
        const float Jv[6] = {0.0f, -gyv, -gzv, gyv * r.zc - gzv * r.yc,
                             gzv * r.xc, -gyv * r.xc};
        const float Jur[6] = {-gxu, 0.0f, -gzur, -gzur * r.yc,
                              -(gxu * r.zc - gzur * r.xc), gxu * r.yc};
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b)
            acc[a * (a + 1) / 2 + b] +=
                w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]) + wc * Jur[a] * Jur[b];
          acc[21 + a] -= w * (Ju[a] * r.ru + Jv[a] * r.rv) + wc * Jur[a] * r.rur;
        }
      }
      block_sum<27>(acc, s_part, s_sum);
      if (tid == 0) {
        float H[21], b[6], dx[6];
        for (int q = 0; q < 21; ++q) H[q] = s_sum[q];
        for (int q = 0; q < 6; ++q) {
          b[q] = s_sum[21 + q];
          H[q * (q + 1) / 2 + q] = H[q * (q + 1) / 2 + q] * (1.0f + s_lam) + 1e-9f;
        }
        chol6_solve(H, b, dx);
        se3_left_update(dx, s_pose, s_new);
      }
      __syncthreads();
      float c[1] = {0.0f};
      for (int i = tid; i < n; i += NT) {
        const Res r = residual(s_new, X, O, i, k);
        c[0] += cost_term(r, invs2[i], comp[i], mask[i], delta[i], robust);
      }
      block_sum<1>(c, s_part, s_sum);
      if (tid == 0) {
        const float new_cost = s_sum[0];
        if (new_cost < s_cost) {
          for (int q = 0; q < 12; ++q) s_pose[q] = s_new[q];
          s_lam = fmaxf(s_lam * 0.5f, 1e-9f);
          s_cost = new_cost;
        } else {
          s_lam = fminf(s_lam * 4.0f, 1e6f);
        }
      }
      __syncthreads();
    }
    // chi2 reclassification against the unmasked residual
    for (int i = tid; i < n; i += NT) {
      const Res r = residual(s_pose, X, O, i, k);
      const float c2 = invs2[i] * (r.ru * r.ru + r.rv * r.rv + comp[i] * r.rur * r.rur);
      mask[i] = (c2 <= chi2th[i] && r.zc > 0.0f && valid[i] > 0.0f) ? 1.0f : 0.0f;
    }
    __syncthreads();
  }
  if (tid < 12) pose_out[tid] = s_pose[tid];
}

}  // namespace

extern "C" int slam_prev_pose_lm(const float* X, const float* O, const float* invs2,
                            const float* comp, const float* valid,
                            const float* delta, const float* chi2th,
                            const float* pose0, float* pose_out, float* mask,
                            int B, int n, float fx, float fy, float cx,
                            float cy, float bf, int rounds, int iters,
                            int robust_rounds, void* stream) {
  const Cam k{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      X, O, invs2, comp, valid, delta, chi2th, pose0, pose_out, mask, n, k,
      rounds, iters, robust_rounds);
  return (int)cudaGetLastError();
}
