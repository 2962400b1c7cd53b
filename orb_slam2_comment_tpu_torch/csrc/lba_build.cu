// K4: one local-BA linearization (normal-equation blocks of the window).
//
// Replaces orb_slam2_comment_tpu/ops/lba_pallas.py::_build_system_call
// (body _kernel; inputs prepared by prep_problem). Per observation: the
// (u, v, ur) residual, the analytic Jc (3x6) and Jp (3x3) of
// optim._edge_jacobians, the Huber weight, the robust cost and the chi2
// inlier flag. These reduce into Hcc [F,6,6], bc [F,6] (per camera),
// Hpp [9,Np], bp [3,Np] (per point), the coupling E [F,6,3,Np] (per
// camera-point pair) and the window's cost and inlier count. The weighted
// Jacobians are formed FIRST and then multiplied (lba_pallas.py:155-166):
// masked observations carry w = 0 next to raw Jacobian entries of up to
// ~1e21 from the depth clamp, and (w*J)*J is 0 where w*(J*J) would be
// 0*inf = NaN.
//
// Bound on the H100: ~32k observations x ~22 bytes and ~2.5 MB of output
// (E dominates) is about a microsecond of HBM time; the arithmetic is
// ~450 FLOPs per observation. What costs is latency: chains of dependent
// gathers (point id -> point, camera) and too few blocks to fill 132 SMs.
// The TPU kernel scattered along the point axis with a VMEM one-hot
// matmul; here the point side is a segmented reduction over observations
// sorted by point once per window (ops/lba_cuda.prep_problem), so no float
// atomics are used and every sum has a fixed order (reruns bit-identical).
//
// Design: ONE launch whose blocks take one of two roles.
//  - Camera blocks: each camera's observations are split over CHUNKS
//    blocks. A block reduces its 29 sums (Hcc lower triangle, bc, cost,
//    n_in) with a reduce-scatter butterfly per warp and one barrier, and
//    writes them to scratch. The last block to finish a camera (ticket
//    counter) adds the camera's chunks in chunk order and writes Hcc and
//    bc; the last camera to finish adds the cameras' cost and n_in in
//    camera order. Only the block doing a sum varies, never its order.
//    The last finisher resets the counters for the next call.
//  - Point blocks: PPB consecutive points per block, one warp per point at
//    a time, lanes over the point's sorted observations (strided past 32).
//    Hpp and bp are lane-local sums closed by one warp reduction. E's
//    columns come from a segmented inclusive scan over the camera key (a
//    camera's observations of one point are adjacent in the sorted order),
//    carried across 32-observation chunks; the segment's last lane writes
//    its column into a zero-filled shared tile [F*18][PPB], and the block
//    writes the tile, and its Hpp/bp rows, to global memory with coalesced
//    row stores. The zero fill of E is thus part of the same stores.
//  The kernel reads cam_T, the points and the observation ok flags as the
// caller holds them and forms the observation weights itself.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int PPB = 8;       // points per point block
constexpr int CHUNKS = 8;    // camera blocks per camera
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr float HUBER_MONO = 2.44765186f;    // float(sqrt(5.991))
constexpr float HUBER_STEREO = 2.79553223f;  // float(sqrt(7.815))

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Args {
  const float* cam_T;     // [Nc, 16]
  const float* pts;       // [Np, 3]
  const float* uvr;       // [O, 3]
  const float* inv_s2;    // [O] level weight
  const uint8_t* stereo;  // [O]
  const uint8_t* ok;      // [O]
  const int* obs_pt;      // [O] clipped to [0, Np)
  const uint8_t* cam_free;  // [Nc]
  const int* perm;        // [O] valid observations sorted by point
  const int* seg;         // [Np + 1]
  float* E;               // [F*18, Np]
  float* pp;              // [12, Np]: Hpp9 rows then bp3 rows
  float* Hcc;             // [F, 36]
  float* bc;              // [F, 6]
  float* cost;            // [1]
  int* n_in;              // [1]
  float* scratch;         // [Nc*CHUNKS*32] chunk sums, then [Nc*2] camera totals
  int* tickets;           // [Nc + 1], zero between calls
  int Nc, Np, N_per, F, robust;
  Cam k;
};

struct Lin {
  float r[3];
  float Jc[3][6];
  float Jp[3][3];
  float w[3];  // per-row weights (w0, w0, w0 * stereo)
  float cost, nin;
};

// Linearize observation o of camera c (only the residual, cost and inlier
// flag when jac is false).
__device__ __forceinline__ bool linearize(const Args& A, int o, int c, bool jac, Lin& L) {
  const float wb = A.ok[o] ? A.inv_s2[o] : 0.0f;
  if (wb == 0.0f) return false;  // inactive: every term is exactly zero
  const float* T = A.cam_T + 16 * c;
  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  const int p = A.obs_pt[o];
  const float px = A.pts[3 * p], py = A.pts[3 * p + 1], pz = A.pts[3 * p + 2];
  const float x = R00 * px + R01 * py + R02 * pz + t0;
  const float y = R10 * px + R11 * py + R12 * pz + t1;
  const float z = R20 * px + R21 * py + R22 * pz + t2;
  const float invz = 1.0f / fmaxf(z, 1e-9f);
  const float invz2 = invz * invz;
  const Cam& k = A.k;
  const float pred_u = k.fx * x * invz + k.cx;
  const float pred_v = k.fy * y * invz + k.cy;
  L.r[0] = A.uvr[3 * o] - pred_u;
  L.r[1] = A.uvr[3 * o + 1] - pred_v;
  L.r[2] = A.uvr[3 * o + 2] - (pred_u - k.bf * invz);
  const bool st = A.stereo[o] != 0;
  const float urm = st ? 1.0f : 0.0f;
  const float chi2 = wb * (L.r[0] * L.r[0] + L.r[1] * L.r[1] + urm * L.r[2] * L.r[2]);
  const float delta = st ? HUBER_STEREO : HUBER_MONO;
  const float d2 = delta * delta;
  const float rho = chi2 <= d2 ? chi2 : 2.0f * delta * sqrtf(fmaxf(chi2, 1e-12f)) - d2;
  L.cost = A.robust ? rho : chi2;
  L.nin = chi2 <= (st ? CHI2_STEREO : CHI2_MONO) ? 1.0f : 0.0f;
  if (!jac) return true;
  const float hw = (A.robust && chi2 > d2) ? delta * rsqrtf(fmaxf(chi2, 1e-12f)) : 1.0f;
  const float w0 = wb * hw;
  L.w[0] = w0;
  L.w[1] = w0;
  L.w[2] = w0 * urm;
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
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < 6; ++i) L.Jc[a][i] = Jc[a][i];
#pragma unroll
    for (int j = 0; j < 3; ++j) L.Jp[a][j] = Jp[a][j];
  }
  return true;
}

// One butterfly step of a reduce-scatter over N values: lanes with bit HALF
// set keep the upper half, the others the lower half, each adding its
// partner's copy of the half it keeps.
template <int HALF, int N>
__device__ __forceinline__ void rs_step(float (&v)[N], bool upper) {
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF];
    const float keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// 32 values per lane -> lane q returns the warp's sum of value q.
__device__ __forceinline__ float warp_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  rs_step<16>(v, lane & 16);
  rs_step<8>(v, lane & 8);
  rs_step<4>(v, lane & 4);
  rs_step<2>(v, lane & 2);
  rs_step<1>(v, lane & 1);
  return v[0];
}

// 16 values per lane -> lanes q and q + 16 return the warp's sum of value q.
__device__ __forceinline__ float warp_reduce_scatter16(float (&v)[16]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], 16);
  rs_step<8>(v, lane & 8);
  rs_step<4>(v, lane & 4);
  rs_step<2>(v, lane & 2);
  rs_step<1>(v, lane & 1);
  return v[0];
}

__device__ void camera_block(const Args& A, int blk) {
  __shared__ float s_part[NWARP][32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blk / CHUNKS, j = blk - c * CHUNKS;
  const int len = (A.N_per + CHUNKS - 1) / CHUNKS;
  const int n0 = j * len, n1 = min(n0 + len, A.N_per);
  const bool sys = c < A.F && A.cam_free[c];  // Hcc, bc needed and nonzero
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.0f;
  for (int n = n0 + threadIdx.x; n < n1; n += NT) {
    const int o = c * A.N_per + n;
    Lin L;
    if (!linearize(A, o, c, sys, L)) continue;
    acc[27] += L.cost;
    acc[28] += L.nin;
    if (!sys) continue;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float a0 = L.w[0] * L.Jc[0][i], a1 = L.w[1] * L.Jc[1][i], a2 = L.w[2] * L.Jc[2][i];
#pragma unroll
      for (int m = 0; m <= i; ++m)
        acc[i * (i + 1) / 2 + m] += a0 * L.Jc[0][m] + a1 * L.Jc[1][m] + a2 * L.Jc[2][m];
      acc[21 + i] -= a0 * L.r[0] + a1 * L.r[1] + a2 * L.r[2];
    }
  }
  s_part[wid][lane] = warp_reduce_scatter32(acc);
  __syncthreads();
  float* chunk_sums = A.scratch;
  float* cam_tot = A.scratch + (size_t)A.Nc * CHUNKS * 32;
  if (wid == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) t += s_part[w][lane];
    chunk_sums[(size_t)blk * 32 + lane] = t;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&A.tickets[c], 1) == CHUNKS - 1;
  __syncthreads();
  if (!s_last || wid != 0) return;
  // the last chunk of camera c to finish: its chunks in chunk order (all
  // loads issued before the first add)
  float part[CHUNKS];
#pragma unroll
  for (int jj = 0; jj < CHUNKS; ++jj)
    part[jj] = __ldcg(&chunk_sums[((size_t)c * CHUNKS + jj) * 32 + lane]);
  float t = 0.0f;
#pragma unroll
  for (int jj = 0; jj < CHUNKS; ++jj) t += part[jj];
  if (c < A.F) {
    // Hcc(i, m) from the lower triangle, mirrored: entries lane and lane + 32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = min(lane + 32 * h, 35);
      const int i = q / 6, m = q % 6;
      const int src = i >= m ? i * (i + 1) / 2 + m : m * (m + 1) / 2 + i;
      const float v = __shfl_sync(0xffffffffu, t, src);
      if (lane + 32 * h < 36) A.Hcc[c * 36 + q] = v;
    }
    const float bv = __shfl_sync(0xffffffffu, t, 21 + lane % 6);
    if (lane < 6) A.bc[c * 6 + lane] = bv;
  }
  if (lane == 27) cam_tot[2 * c] = t;
  if (lane == 28) cam_tot[2 * c + 1] = t;
  __threadfence();
  __syncwarp();
  int last_cam = 0;
  if (lane == 0) {
    A.tickets[c] = 0;
    last_cam = atomicAdd(&A.tickets[A.Nc], 1) == A.Nc - 1;
  }
  if (!__shfl_sync(0xffffffffu, last_cam, 0)) return;
  // the last camera to finish: the window's totals, lane l over cameras
  // l, l + 32, ... in order, then a fixed butterfly over the lanes
  float cost = 0.0f, nin = 0.0f;
  for (int cc = lane; cc < A.Nc; cc += 32) {
    cost += __ldcg(&cam_tot[2 * cc]);
    nin += __ldcg(&cam_tot[2 * cc + 1]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cost += __shfl_xor_sync(0xffffffffu, cost, o);
    nin += __shfl_xor_sync(0xffffffffu, nin, o);
  }
  if (lane == 0) {
    A.cost[0] = cost;
    A.n_in[0] = (int)nin;
    A.tickets[A.Nc] = 0;
  }
}

__device__ void point_block(const Args& A, int pblk, float* sE) {
  __shared__ float sPP[12][PPB];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int p0 = pblk * PPB;
  const int rows = A.F * 18;
  for (int q = threadIdx.x; q < rows * PPB; q += NT) sE[q] = 0.0f;
  __syncthreads();
  for (int lp = wid; lp < PPB; lp += NWARP) {
    const int p = p0 + lp;
    if (p >= A.Np) break;
    const int s0 = A.seg[p], s1 = A.seg[p + 1];
    float hp[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) hp[q] = 0.0f;
    int carry_key = -1;
    float carry[18];
#pragma unroll
    for (int q = 0; q < 18; ++q) carry[q] = 0.0f;
    for (int sb = s0; sb < s1; sb += 32) {
      const int s = sb + lane;
      const bool act = s < s1;
      int c = -1, c_next = -2;
      float e[18];
#pragma unroll
      for (int q = 0; q < 18; ++q) e[q] = 0.0f;
      if (act) {
        const int o = A.perm[s];
        c = o / A.N_per;
        if (s + 1 < s1) c_next = A.perm[s + 1] / A.N_per;
        Lin L;
        if (linearize(A, o, c, true, L)) {
          float JpW[3][3];
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) JpW[a][jj] = L.w[a] * L.Jp[a][jj];
          // Hpp lower triangle (00, 10, 11, 20, 21, 22), then bp
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int m = 0; m <= i; ++m)
              hp[i * (i + 1) / 2 + m] += JpW[0][i] * L.Jp[0][m] + JpW[1][i] * L.Jp[1][m] +
                                         JpW[2][i] * L.Jp[2][m];
            hp[6 + i] -= JpW[0][i] * L.r[0] + JpW[1][i] * L.r[1] + JpW[2][i] * L.r[2];
          }
          if (c < A.F && A.cam_free[c]) {
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const float a0 = L.w[0] * L.Jc[0][i], a1 = L.w[1] * L.Jc[1][i],
                          a2 = L.w[2] * L.Jc[2][i];
#pragma unroll
              for (int jj = 0; jj < 3; ++jj)
                e[3 * i + jj] = a0 * L.Jp[0][jj] + a1 * L.Jp[1][jj] + a2 * L.Jp[2][jj];
            }
          }
        }
      }
      // the previous chunk's open segment continues into this one
      if (lane == 0 && c == carry_key) {
#pragma unroll
        for (int q = 0; q < 18; ++q) e[q] += carry[q];
      }
      // segmented inclusive scan over the camera key
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ck = __shfl_up_sync(0xffffffffu, c, d);
#pragma unroll
        for (int q = 0; q < 18; ++q) {
          const float up = __shfl_up_sync(0xffffffffu, e[q], d);
          if (lane >= d && ck == c) e[q] += up;
        }
      }
      const bool seg_end = act && c_next != c;
      if (seg_end && c < A.F) {
#pragma unroll
        for (int q = 0; q < 18; ++q) sE[(c * 18 + q) * PPB + lp] = e[q];
      }
      carry_key = __shfl_sync(0xffffffffu, c, 31);
#pragma unroll
      for (int q = 0; q < 18; ++q) carry[q] = __shfl_sync(0xffffffffu, e[q], 31);
    }
    const float h = warp_reduce_scatter16(hp);  // lane q: Hpp-lower/bp value q
    // rows of pp: Hpp9 (row-major 3x3 from the lower triangle), then bp
    const int src = lane < 9 ? (lane / 3 >= lane % 3 ? (lane / 3) * (lane / 3 + 1) / 2 + lane % 3
                                                     : (lane % 3) * (lane % 3 + 1) / 2 + lane / 3)
                             : lane - 3;
    const float v = __shfl_sync(0xffffffffu, h, src & 15);
    if (lane < 12) sPP[lane][lp] = v;
  }
  __syncthreads();
  const int np = min(PPB, A.Np - p0);
  for (int q = threadIdx.x; q < rows * PPB; q += NT) {
    const int r = q / PPB, i = q - r * PPB;
    if (i < np) A.E[(size_t)r * A.Np + p0 + i] = sE[q];
  }
  for (int q = threadIdx.x; q < 12 * PPB; q += NT) {
    const int r = q / PPB, i = q - r * PPB;
    if (i < np) A.pp[(size_t)r * A.Np + p0 + i] = sPP[r][i];
  }
}

__global__ void __launch_bounds__(NT) lba_build_kernel(Args A) {
  extern __shared__ float sE[];
  const int n_cam_blocks = A.Nc * CHUNKS;
  if ((int)blockIdx.x < n_cam_blocks)
    camera_block(A, blockIdx.x);
  else
    point_block(A, blockIdx.x - n_cam_blocks, sE);
}

}  // namespace

extern "C" int slam_lba_build(const float* cam_T, const float* pts, const float* uvr,
                              const float* inv_s2, const uint8_t* stereo, const uint8_t* ok,
                              const int* obs_pt, const uint8_t* cam_free, const int* perm,
                              const int* seg, float* sys, int* n_in, float* scratch,
                              int* tickets, int Nc, int Np, int N_per, int F, int chunks,
                              int robust, float fx, float fy, float cx, float cy, float bf,
                              void* stream) {
  Args A;
  A.cam_T = cam_T;
  A.pts = pts;
  A.uvr = uvr;
  A.inv_s2 = inv_s2;
  A.stereo = stereo;
  A.ok = ok;
  A.obs_pt = obs_pt;
  A.cam_free = cam_free;
  A.perm = perm;
  A.seg = seg;
  // sys = [E (F*18*Np) | Hpp9, bp3 (12*Np) | Hcc (F*36) | bc (F*6) | cost]
  A.E = sys;
  A.pp = sys + (size_t)F * 18 * Np;
  A.Hcc = A.pp + (size_t)12 * Np;
  A.bc = A.Hcc + (size_t)F * 36;
  A.cost = A.bc + (size_t)F * 6;
  A.n_in = n_in;
  A.scratch = scratch;
  A.tickets = tickets;
  A.Nc = Nc;
  A.Np = Np;
  A.N_per = N_per;
  A.F = F;
  A.robust = robust;
  A.k = Cam{fx, fy, cx, cy, bf};
  if (chunks != CHUNKS) return (int)cudaErrorInvalidValue;  // scratch sized for CHUNKS
  const size_t smem = (size_t)F * 18 * PPB * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lba_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = Nc * CHUNKS + (Np + PPB - 1) / PPB;
  lba_build_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
