// The earlier design of K4 (one block per camera and one thread per point,
// in two launches), kept only so that chip_smoke.py can time the
// redesigned kernel against it in one run. The port does not use it.
//
// K4: one local-BA linearization (normal-equation blocks of the window).
//
// Replaces orb_slam2_comment_tpu/ops/lba_pallas.py::_build_system_call
// (body _kernel; inputs prepared by prep_problem). Per observation: the
// (u, v, ur) residual, the analytic Jc (3x6) and Jp (3x3) of
// optim._edge_jacobians, the Huber weight, the robust cost and the chi2
// inlier flag. These reduce into Hcc [F,6,6], bc [F,6] (per camera),
// Hpp [9,Np], bp [3,Np] (per point) and the coupling E [F,6,3,Np] (per
// camera-point pair). The weighted Jacobians are formed FIRST and then
// multiplied (lba_pallas.py:155-166): masked observations carry w = 0 next
// to raw Jacobian entries of up to ~1e21 from the depth clamp, and
// (w*J)*J is 0 where w*(J*J) would be 0*inf = NaN.
//
// Bound on the H100: ~32k observations x ~60 bytes in and ~2.5 MB out (E
// dominates); the arithmetic is ~700 FLOPs per observation. Both are small,
// so the kernel is bound by latency and by the irregular point axis. The
// TPU kernel scattered along the point axis with a VMEM one-hot matmul; here
// the point side is a segmented reduction over observations sorted by point
// once per window (ops/lba_cuda.prep_problem), so no float atomics are used
// and the sums are deterministic. Design: kernel A runs one block per
// camera; its threads stride over the camera's observations and a
// fixed-order block reduction forms the 44 camera sums (Hcc, bc, cost,
// n_in). Kernel B runs one thread per point; it walks the point's sorted
// observations, accumulates Hpp/bp in registers, and writes each E column
// when the camera changes (observations are camera-major, so a camera's
// observations of one point are adjacent in the sorted order).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT_A = 256;
constexpr int NWARP_A = NT_A / 32;
constexpr int NT_B = 128;
constexpr int NCAM = 44;  // 36 Hcc + 6 bc + cost + n_in
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Lin {
  float r[3];
  float Jc[3][6];
  float Jp[3][3];
  float JcW[3][6];
  float JpW[3][3];
  float cost, nin;
};

__device__ __forceinline__ void linearize(int o, int c, const float* __restrict__ cam_T,
                                          const float* __restrict__ pts,
                                          const float* __restrict__ uvr,
                                          const float* __restrict__ wbase,
                                          const float* __restrict__ urmask,
                                          const int* __restrict__ obs_pt,
                                          const int* __restrict__ cam_free,
                                          bool robust, const Cam& k, Lin& L) {
  const float* T = cam_T + 16 * c;
  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  const int p = obs_pt[o];
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  const float x = R00 * px + R01 * py + R02 * pz + t0;
  const float y = R10 * px + R11 * py + R12 * pz + t1;
  const float z = R20 * px + R21 * py + R22 * pz + t2;
  const float invz = 1.0f / fmaxf(z, 1e-9f);
  const float invz2 = invz * invz;
  const float pred_u = k.fx * x * invz + k.cx;
  const float pred_v = k.fy * y * invz + k.cy;
  L.r[0] = uvr[3 * o] - pred_u;
  L.r[1] = uvr[3 * o + 1] - pred_v;
  L.r[2] = uvr[3 * o + 2] - (pred_u - k.bf * invz);

  const float wb = wbase[o];
  const float urm = urmask[o];
  const float chi2 = wb * (L.r[0] * L.r[0] + L.r[1] * L.r[1] + urm * L.r[2] * L.r[2]);
  const float delta = urm > 0.0f ? sqrtf(CHI2_STEREO) : sqrtf(CHI2_MONO);
  const float d2 = delta * delta;
  const float th = urm > 0.0f ? CHI2_STEREO : CHI2_MONO;
  const float hw = (robust && chi2 > d2) ? delta * rsqrtf(fmaxf(chi2, 1e-12f)) : 1.0f;
  const float rho = chi2 <= d2 ? chi2 : 2.0f * delta * sqrtf(fmaxf(chi2, 1e-12f)) - d2;
  L.cost = robust ? rho : chi2;
  L.nin = (wb > 0.0f && chi2 <= th) ? 1.0f : 0.0f;
  const float w0 = wb * hw;
  const float w2 = w0 * urm;
  const float fr = cam_free[c] > 0 ? 1.0f : 0.0f;

  const float D00 = -k.fx * invz;
  const float D02 = k.fx * x * invz2;
  const float D11 = -k.fy * invz;
  const float D12 = k.fy * y * invz2;
  const float D20 = -k.fx * invz;
  const float D22 = (k.fx * x - k.bf) * invz2;
  const float M00 = -D02 * y;
  const float M01 = -D00 * z + D02 * x;
  const float M02 = D00 * y;
  const float M10 = D11 * z - D12 * y;
  const float M11 = D12 * x;
  const float M12 = -D11 * x;
  const float M20 = -D22 * y;
  const float M21 = -D20 * z + D22 * x;
  const float M22 = D20 * y;
  const float Jc[3][6] = {{D00, 0.0f, D02, -M00, -M01, -M02},
                          {0.0f, D11, D12, -M10, -M11, -M12},
                          {D20, 0.0f, D22, -M20, -M21, -M22}};
  const float Jp[3][3] = {
      {D00 * R00 + D02 * R20, D00 * R01 + D02 * R21, D00 * R02 + D02 * R22},
      {D11 * R10 + D12 * R20, D11 * R11 + D12 * R21, D11 * R12 + D12 * R22},
      {D20 * R00 + D22 * R20, D20 * R01 + D22 * R21, D20 * R02 + D22 * R22}};
  const float wr[3] = {w0, w0, w2};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      L.Jc[a][i] = Jc[a][i];
      L.JcW[a][i] = fr * wr[a] * Jc[a][i];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      L.Jp[a][j] = Jp[a][j];
      L.JpW[a][j] = wr[a] * Jp[a][j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Kernel A: camera-side sums, one block per camera.
__global__ void __launch_bounds__(NT_A) lba_cam_kernel(
    const float* __restrict__ cam_T, const float* __restrict__ pts,
    const float* __restrict__ uvr, const float* __restrict__ wbase,
    const float* __restrict__ urmask, const int* __restrict__ obs_pt,
    const int* __restrict__ cam_free, float* __restrict__ cam_out, int N_per,
    int robust, Cam k) {
  __shared__ float s_part[NCAM * NWARP_A];
  const int c = blockIdx.x;
  float acc[NCAM];
#pragma unroll
  for (int q = 0; q < NCAM; ++q) acc[q] = 0.0f;
  for (int n = threadIdx.x; n < N_per; n += NT_A) {
    const int o = c * N_per + n;
    if (wbase[o] == 0.0f) continue;  // inactive: every term is exactly zero
    Lin L;
    linearize(o, c, cam_T, pts, uvr, wbase, urmask, obs_pt, cam_free, robust != 0, k, L);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[6 * i + j] += L.JcW[0][i] * L.Jc[0][j] + L.JcW[1][i] * L.Jc[1][j] +
                          L.JcW[2][i] * L.Jc[2][j];
      acc[36 + i] -= L.JcW[0][i] * L.r[0] + L.JcW[1][i] * L.r[1] + L.JcW[2][i] * L.r[2];
    }
    acc[42] += L.cost;
    acc[43] += L.nin;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NCAM; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) s_part[q * NWARP_A + wid] = v;
  }
  __syncthreads();
  if (threadIdx.x < NCAM) {
    float s = 0.0f;
    for (int w = 0; w < NWARP_A; ++w) s += s_part[threadIdx.x * NWARP_A + w];
    cam_out[c * NCAM + threadIdx.x] = s;
  }
}

// Kernel B: point-side sums (Hpp, bp) and the coupling E, one thread per
// point over its observations in sorted order.
__global__ void __launch_bounds__(NT_B) lba_point_kernel(
    const float* __restrict__ cam_T, const float* __restrict__ pts,
    const float* __restrict__ uvr, const float* __restrict__ wbase,
    const float* __restrict__ urmask, const int* __restrict__ obs_pt,
    const int* __restrict__ cam_free, const int* __restrict__ perm,
    const int* __restrict__ seg, float* __restrict__ pp_out,
    float* __restrict__ e_out, int Np, int N_per, int F, int robust, Cam k) {
  const int p = blockIdx.x * NT_B + threadIdx.x;
  if (p >= Np) return;
  for (int q = 0; q < F * 18; ++q) e_out[(size_t)q * Np + p] = 0.0f;
  float hpp[9], bp[3], e[18];
#pragma unroll
  for (int q = 0; q < 9; ++q) hpp[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 3; ++q) bp[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 18; ++q) e[q] = 0.0f;
  int cur = -1;
  const int s0 = seg[p], s1 = seg[p + 1];
  for (int s = s0; s < s1; ++s) {
    const int o = perm[s];
    if (wbase[o] == 0.0f) continue;
    const int c = o / N_per;
    Lin L;
    linearize(o, c, cam_T, pts, uvr, wbase, urmask, obs_pt, cam_free, robust != 0, k, L);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        hpp[3 * i + j] += L.JpW[0][i] * L.Jp[0][j] + L.JpW[1][i] * L.Jp[1][j] +
                          L.JpW[2][i] * L.Jp[2][j];
      bp[i] -= L.JpW[0][i] * L.r[0] + L.JpW[1][i] * L.r[1] + L.JpW[2][i] * L.r[2];
    }
    if (c < F) {
      if (c != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int q = 0; q < 18; ++q) {
            e_out[((size_t)cur * 18 + q) * Np + p] = e[q];
            e[q] = 0.0f;
          }
        }
        cur = c;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          e[3 * i + j] += L.JcW[0][i] * L.Jp[0][j] + L.JcW[1][i] * L.Jp[1][j] +
                          L.JcW[2][i] * L.Jp[2][j];
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int q = 0; q < 18; ++q) e_out[((size_t)cur * 18 + q) * Np + p] = e[q];
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) pp_out[(size_t)q * Np + p] = hpp[q];
#pragma unroll
  for (int q = 0; q < 3; ++q) pp_out[(size_t)(9 + q) * Np + p] = bp[q];
}

}  // namespace

extern "C" int slam_prev_lba_build(const float* cam_T, const float* pts,
                              const float* uvr, const float* wbase,
                              const float* urmask, const int* obs_pt,
                              const int* cam_free, const int* perm,
                              const int* seg, float* cam_out, float* pp_out,
                              float* e_out, int Nc, int Np, int N_per, int F,
                              int robust, float fx, float fy, float cx,
                              float cy, float bf, void* stream) {
  const Cam k{fx, fy, cx, cy, bf};
  cudaStream_t s = (cudaStream_t)stream;
  lba_cam_kernel<<<Nc, NT_A, 0, s>>>(cam_T, pts, uvr, wbase, urmask, obs_pt,
                                     cam_free, cam_out, N_per, robust, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lba_point_kernel<<<(Np + NT_B - 1) / NT_B, NT_B, 0, s>>>(
      cam_T, pts, uvr, wbase, urmask, obs_pt, cam_free, perm, seg, pp_out,
      e_out, Np, N_per, F, robust, k);
  return (int)cudaGetLastError();
}
