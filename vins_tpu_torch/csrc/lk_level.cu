// One Lucas-Kanade pyramid level for a batch of features, for sm_90a.
//
// Replaces the TPU kernel vins_tpu/frontend/klt_pallas.py::lk_level_pallas
// and holds the semantics of vins_tpu/frontend/klt.py::_lk_level, whose
// PyTorch twin is vins_tpu_torch/frontend/klt.py::_lk_level (the plain
// version this kernel is checked against).  For each feature:
//   1. a bilinear (win+2)^2 sample of img0 at p0 gives the template and its
//      central-difference gradients, and the 2x2 structure tensor G;
//   2. ok = OpenCV's min-eigenvalue gate, min_eig / win^2 > min_eig_thresh;
//   3. `iters` Gauss-Newton flow updates against bilinear img1 patches, each
//      clamped inside one WS x WS search window (WS = win + 1 + 2 search)
//      fixed around the initial guess, with an eps-freeze.
//
// Design: one block of 128 threads per feature.  The (win+3)^2 template
// patch and the WS^2 img1 window are staged in shared memory once; the
// template, its gradients and all iterations then run from shared memory,
// with a block reduction for G and for each iteration's right-hand side.
// Every index is floored and clamped as in _lk_level, so no position, not
// even NaN or junk in an invalid slot, reads outside the padded image.
//
// What bounds it: per level at most 150 x (24^2 + WS^2) x 4 B of patch
// reads, and never more than the two level images (1.4 MB at level 0,
// WS = 42: 0.42 us at 3.35 TB/s; 0.24 MB for the whole level-2 pair), and
// at most 150 x 10 x 441 x 12 flops (7.9 MFLOP, 0.12 us at 67 TFLOP/s f32).
// Features that freeze early need less; chip_smoke.lk_bound_ms counts what
// the inputs need.  All of it is under a microsecond on an H100, so the
// kernel measures at launch latency.  Making it fast (a CUDA graph over the
// whole front step, several features per block) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int floor_idx(float v) {
  // floor to an index; NaN -> 0 and junk clamped to +-1e9 first, as
  // klt.floor_index does
  if (!(v == v)) return 0;
  v = fminf(fmaxf(v, -1e9f), 1e9f);
  return static_cast<int>(floorf(v));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Sums K values over the block; every thread gets the totals.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with `red`
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
    v[k] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ img0, const float* __restrict__ img1,
                int Hp, int Wp, const float* __restrict__ p0,
                const float* __restrict__ g, const unsigned char* __restrict__ valid,
                int win, int search, int iters, float eps, float min_eig_thresh,
                float* __restrict__ g_out, unsigned char* __restrict__ ok_out) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kWarps];
  const int n = blockIdx.x;
  const int half = win / 2;
  const int pad = half + 2;
  const int P0 = win + 3;
  const int P1 = win + 1;
  const int SW = P0 - 1;
  const int WS = P1 + 2 * search;
  const int nwin = win * win;
  float* patch0 = smem;           // P0 x P0
  float* S = patch0 + P0 * P0;    // SW x SW
  float* tpl = S + SW * SW;       // win x win
  float* gxs = tpl + nwin;
  float* gys = gxs + nwin;
  float* window = gys + nwin;     // WS x WS

  const float px = p0[2 * n], py = p0[2 * n + 1];
  const int ix = floor_idx(px), iy = floor_idx(py);
  const float fx = px - static_cast<float>(ix);
  const float fy = py - static_cast<float>(iy);
  const int x0 = clampi(ix - half - 1 + pad, 0, Wp - P0);
  const int y0 = clampi(iy - half - 1 + pad, 0, Hp - P0);
  float gcx = g[2 * n], gcy = g[2 * n + 1];
  const int wx0 = clampi(floor_idx(gcx) - half - search + pad, 0, Wp - WS);
  const int wy0 = clampi(floor_idx(gcy) - half - search + pad, 0, Hp - WS);

  for (int i = threadIdx.x; i < P0 * P0; i += kThreads) {
    const int r = i / P0, c = i - r * P0;
    patch0[i] = img0[static_cast<size_t>(y0 + r) * Wp + x0 + c];
  }
  for (int i = threadIdx.x; i < WS * WS; i += kThreads) {
    const int r = i / WS, c = i - r * WS;
    window[i] = img1[static_cast<size_t>(wy0 + r) * Wp + wx0 + c];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < SW * SW; i += kThreads) {
    const int r = i / SW, c = i - r * SW;
    const float* q = patch0 + r * P0 + c;
    S[i] = q[0] * (1 - fx) * (1 - fy) + q[1] * fx * (1 - fy)
         + q[P0] * (1 - fx) * fy + q[P0 + 1] * fx * fy;
  }
  __syncthreads();

  float G[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nwin; i += kThreads) {
    const int r = i / win, c = i - r * win;
    const float* q = S + (r + 1) * SW + (c + 1);
    const float gx = 0.5f * (q[1] - q[-1]);
    const float gy = 0.5f * (q[SW] - q[-SW]);
    tpl[i] = q[0];
    gxs[i] = gx;
    gys[i] = gy;
    G[0] += gx * gx;
    G[1] += gx * gy;
    G[2] += gy * gy;
  }
  block_sum(G, red);  // its barriers also publish tpl/gxs/gys

  const float tr = G[0] + G[2];
  const float det = G[0] * G[2] - G[1] * G[1];
  const float disc = sqrtf(fmaxf(0.25f * tr * tr - det, 0.f));
  const float min_eig = (0.5f * tr - disc) / static_cast<float>(nwin);
  const bool ok = (min_eig > min_eig_thresh) && valid[n] != 0;
  // inv2x2(G + 1e-9 I), the formula of core/linalg.py
  const float a = G[0] + 1e-9f, b = G[1], c = G[1], d = G[2] + 1e-9f;
  const float inv_det = 1.f / (a * d - b * c);
  const float i00 = d * inv_det, i01 = -b * inv_det;
  const float i10 = -c * inv_det, i11 = a * inv_det;

  for (int it = 0; it < iters; ++it) {
    const float ux = gcx - half, uy = gcy - half;
    const int lx = clampi(floor_idx(ux) + pad - wx0, 0, WS - P1);
    const int ly = clampi(floor_idx(uy) + pad - wy0, 0, WS - P1);
    const float gfx = ux - floorf(ux), gfy = uy - floorf(uy);
    float B[2] = {0.f, 0.f};
    for (int i = threadIdx.x; i < nwin; i += kThreads) {
      const int r = i / win, cc = i - r * win;
      const float* q = window + (ly + r) * WS + lx + cc;
      const float v = q[0] * (1 - gfx) * (1 - gfy) + q[1] * gfx * (1 - gfy)
                    + q[WS] * (1 - gfx) * gfy + q[WS + 1] * gfx * gfy;
      const float dd = v - tpl[i];
      B[0] += dd * gxs[i];
      B[1] += dd * gys[i];
    }
    block_sum(B, red);
    const float sx = -(i00 * B[0] + i01 * B[1]);
    const float sy = -(i10 * B[0] + i11 * B[1]);
    // eps-freeze: converged features stop updating
    if (sqrtf(sx * sx + sy * sy) > eps && ok) {
      gcx += sx;
      gcy += sy;
    }
  }
  if (threadIdx.x == 0) {
    g_out[2 * n] = gcx;
    g_out[2 * n + 1] = gcy;
    ok_out[n] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" size_t lk_level_smem_bytes(int win, int search) {
  const int P0 = win + 3, SW = win + 2, WS = win + 1 + 2 * search;
  return sizeof(float) * static_cast<size_t>(P0 * P0 + SW * SW + 3 * win * win + WS * WS);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lk_level_launch(const float* img0, const float* img1, int Hp, int Wp,
                               const float* p0, const float* g,
                               const unsigned char* valid, int N, int win, int search,
                               int iters, float eps, float min_eig_thresh,
                               float* g_out, unsigned char* ok_out, void* stream) {
  if (N == 0) return 0;
  const size_t smem = lk_level_smem_bytes(win, search);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lk_level_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      img0, img1, Hp, Wp, p0, g, valid, win, search, iters, eps, min_eig_thresh,
      g_out, ok_out);
  return static_cast<int>(cudaGetLastError());
}
