// Pyramidal Lucas-Kanade for a batch of features of S streams, every level
// of every stream in one launch, for sm_90a.
//
// Replaces the TPU kernel vins_tpu/frontend/klt_pallas.py::lk_level_pallas
// and this package's first port of it, csrc/lk_level.cu (one launch per
// level, 128 threads per feature; kept as a timing baseline).  It holds the
// semantics of vins_tpu_torch/frontend/klt.py::_lk_pyramid, its plain
// version: klt._lk_level for the levels top -> 0, chained as
// klt.lk_pyramidal chains them (p0 = pts * 2^-l, the top guess
// pts * 2^-(levels-1) unless one is given, g * 2 between levels, ok ANDed
// over the levels, a search radius per level).  Per feature and level:
//   1. a bilinear (win+2)^2 sample of img0 at p0 gives the template, its
//      central-difference gradients and the 2x2 structure tensor G;
//   2. ok = valid and OpenCV's min-eigenvalue gate, min_eig / win^2 >
//      min_eig_thresh; G + 1e-9 I is inverted by the inv2x2 formula;
//   3. up to `iters` Gauss-Newton steps against bilinear img1 patches, each
//      clamped inside one WS x WS search window (WS = win + 1 + 2 search)
//      fixed around the level's initial guess, with an eps-freeze.
//
// What bounds it.  The work is small: per tracked frame (150 features, 3
// levels) the pixels it must read take about 0.3 us at 3.35 TB/s and its
// float32 operations less (chip_smoke.lk_bound counts both from the
// inputs).  What takes the time is latency: each Gauss-Newton step depends
// on the one before, and the slowest features run all 10 steps of every
// level.  On an H100 one step takes about 1,000 cycles: ~450 waiting for
// its patch (the loads miss L1 whenever the patch moves), ~250 for the
// samples and products, ~160 for the two shuffle sums and ~100 for the
// step itself (clock64 counts, PERF.md).  So the design shortens that
// dependent chain:
//   1. One launch per tracked frame.  The warp that owns a feature runs the
//      levels top -> 0 in turn.  Features are independent, so no grid-wide
//      sync is needed, and the host enqueues no glue between levels.
//   2. A warp per feature, `warps_per_block` features per block (1 by
//      default: the fastest of 1, 2, 4 and 8).  Lane c + 1 owns column c of
//      the window and keeps its template and gradients in registers.  G and
//      each step's right-hand side are summed with warp shuffles; there is
//      no barrier, and no shared memory in the step loop.
//   3. Exit at the freeze.  A warp leaves a level's loop after the first
//      step with |step| <= eps, and skips the loop when ok is false.  This
//      is exact: a frozen feature keeps its position, so every later step
//      would read the same patch, get the same step and stay frozen
//      (tests/test_torch_frontend.py::test_lk_freeze_is_absorbing).
//   4. The img0 template patches of every level depend only on pts, so each
//      lane issues its share of them with cp.async at entry, one commit
//      group per level; the lower levels' copies overlap the top level's
//      work.  TMA is not used: its out-of-bounds fill is zero, not the
//      replicate padding the patches need at the border, and a tensor map
//      per level image and frame would be host work on every call.
//   5. No staging of the search window.  Each step reads only its own
//      (win+1)^2 patch from the level image, through the read-only path, a
//      column per lane straight into registers; the neighbouring column
//      comes by shuffle.  The level images (2.8 MB for a 752x480 pair) stay
//      in the 50 MB L2.  Staging the window in shared memory with cp.async
//      made the steps' reads faster but cost more to issue than it saved.
//   6. The unpadded pyramid is read.  A coordinate i of klt._lk_level's
//      padded image reads unpadded clamp(i - pad, 0, H - 1), which is what
//      replicate padding stores there, so no padded copies are made.
// Every index is floored and clamped as in klt._lk_level (NaN -> 0), so no
// position, not even junk in an invalid slot, reads outside an image.
//
// The stream axis.  The multi-stream pipeline (parallel/multistream.py)
// tracks S independent camera streams in lock-step; the JAX package vmaps
// its Pallas kernel over them, which adds a batch axis to the kernel's grid.
// Here the stream is blockIdx.y: one launch runs every level of every
// stream.  Level images are [S, H, W] (stream s at img + s * stride), and
// pts, g_top, valid, g_out, ok_out and trace carry a leading [S] (feature f
// of stream s is row s * n + f).  A warp does exactly the arithmetic it does
// for one stream, so stream s of a batched launch is bitwise equal to a
// launch on stream s's inputs alone, and the single-stream call is S = 1.
// blockIdx.y and not a flattened index: the features of a stream stay
// contiguous in blockIdx.x, and no division splits the block index.  The
// work, and so the bound, is S times a stream's (S x the bytes and
// operations chip_smoke.lk_bound counts for one frame); the launch floor
// (~5 us, PERF.md) is paid once for all S streams.  A launch of one stream
// instantiates the kernel with the stream fixed at 0, where the stream
// arithmetic folds away: with it live, the level pointers become computed
// values, and one stream's launch took 25.28 us against 23.55 us without
// the axis (142 registers against 128; chip_smoke phase 4, both sources in
// turns on one H100, PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 21;                     // the window the kernel is built for
constexpr int kHalf = kWin / 2;
constexpr int kPad = kHalf + 2;              // the padding of klt._lk_level's images
constexpr int kP0 = kWin + 3;                // template patch: bilinear + gradient margin
constexpr int kP1 = kWin + 1;                // step patch: bilinear margin
constexpr int kNWin = kWin * kWin;
constexpr int kMaxLevels = 4;
constexpr int kMaxWarps = 8;

struct Level {
  const float* img0;  // [S, H, W] level of the previous frames, unpadded
  const float* img1;  // [S, H, W] level of the current frames
  long long stride;   // elements from one stream's image to the next
  int H, W;
  int search;         // search radius, capped as klt.lk_search_radius caps it
};

struct Params {
  Level lv[kMaxLevels];   // lv[l] is level l; level 0 is full resolution
  int levels;
  int streams;            // S
  const float* pts;       // [S, N, 2] positions in img0, level-0 pixels
  const float* g_top;     // [S, N, 2] guesses at the top level, or null: pts / 2^(levels-1)
  const unsigned char* valid;  // [S, N]
  int n, iters;           // n = N, the features of one stream
  float eps, min_eig_thresh;
  float* g_out;           // [S, N, 2] tracked positions, level-0 pixels
  unsigned char* ok_out;  // [S, N] ok at every level
  float* trace;           // [S, N, levels, 4] per level: g, ok, steps run; or null
};

// A level with its images moved to stream s.
__device__ __forceinline__ Level at_stream(Level L, int s) {
  L.img0 += s * L.stride;
  L.img1 += s * L.stride;
  return L;
}

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

// Offset in the unpadded H x W image of the padded coordinate (y, x).
__device__ __forceinline__ int padded_at(int y, int x, int H, int W) {
  return clampi(y - kPad, 0, H - 1) * W + clampi(x - kPad, 0, W - 1);
}

// klt._shift_bilinear at one pixel: q[0] is the top-left tap.
__device__ __forceinline__ float bilerp(const float* q, int stride, float fx, float fy) {
  return q[0] * (1.f - fx) * (1.f - fy) + q[1] * fx * (1.f - fy)
       + q[stride] * (1.f - fx) * fy + q[stride + 1] * fx * fy;
}

// Sum over the warp by an xor butterfly.  Every lane ends with the same bits
// (a + b == b + a at each stage), so a decision taken on the sum is
// warp-uniform.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

template <bool kStreams>
__global__ void __launch_bounds__(32 * kMaxWarps) lk_pyramid_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;  // the feature in its stream
  if (f >= p.n) return;  // the whole warp: nothing below needs the others
  const int s = kStreams ? static_cast<int>(blockIdx.y) : 0;  // the stream
  const int n = s * p.n + f;  // the feature's row in the [S, N] arrays
  float* tpl_patch = smem + warp * (p.levels * kP0 * kP0);  // levels x P0 x P0

  const float ptx = p.pts[2 * n], pty = p.pts[2 * n + 1];
  const bool valid = p.valid[n] != 0;
  // An invalid feature is never ok and never moves, so it needs no patches.
  if (valid) {
    for (int l = p.levels - 1; l >= 0; --l) {
      const Level L = at_stream(p.lv[l], s);
      const float s = static_cast<float>(1 << l);
      const int x0 = clampi(floor_idx(ptx / s) - kHalf - 1 + kPad, 0, L.W + 2 * kPad - kP0);
      const int y0 = clampi(floor_idx(pty / s) - kHalf - 1 + kPad, 0, L.H + 2 * kPad - kP0);
      float* dst = tpl_patch + l * kP0 * kP0;
#pragma unroll
      for (int k = 0; k < (kP0 * kP0 + 31) / 32; ++k) {
        const int i = lane + 32 * k;
        if (i < kP0 * kP0) {
          const int r = i / kP0, c = i - r * kP0;
          cp_async4(dst + i, L.img0 + padded_at(y0 + r, x0 + c, L.H, L.W));
        }
      }
      cp_async_commit();
    }
  }

  float gcx, gcy;
  if (p.g_top != nullptr) {
    gcx = p.g_top[2 * n];
    gcy = p.g_top[2 * n + 1];
  } else {
    const float s = static_cast<float>(1 << (p.levels - 1));
    gcx = ptx / s;
    gcy = pty / s;
  }
  bool ok_all = valid;
  for (int l = p.levels - 1; l >= 0; --l) {
    const Level L = at_stream(p.lv[l], s);
    int steps = 0;
    bool level_ok = false;
    if (valid) {
      const float s = static_cast<float>(1 << l);
      const float px = ptx / s, py = pty / s;
      const int ix = floor_idx(px), iy = floor_idx(py);
      const float fx = px - static_cast<float>(ix), fy = py - static_cast<float>(iy);
      cp_async_wait(l);  // this level's group has landed; lower levels' may not have
      __syncwarp();      // and so has every other lane's
      const float* T = tpl_patch + l * kP0 * kP0;

      // Lane i < win + 2 holds column i of S, the bilinear resample of the
      // template patch at (x + fx, y + fy): scol[j] = S[j][i].  Lanes past
      // it repeat the last column, which nothing reads.
      float scol[kP0 - 1];
      const int si = min(lane, kP0 - 2);
#pragma unroll
      for (int j = 0; j < kP0 - 1; ++j) scol[j] = bilerp(T + j * kP0 + si, kP0, fx, fy);
      // Lane c + 1 owns window column c: its template, central-difference
      // gradients and share of G.  Other lanes hold zeros.
      const bool owner = lane >= 1 && lane <= kWin;
      float tp[kWin], gxs[kWin], gys[kWin];
      float g00 = 0.f, g01 = 0.f, g11 = 0.f;
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        const float right = __shfl_down_sync(0xffffffffu, scol[r + 1], 1);
        const float left = __shfl_up_sync(0xffffffffu, scol[r + 1], 1);
        tp[r] = owner ? scol[r + 1] : 0.f;
        gxs[r] = owner ? 0.5f * (right - left) : 0.f;
        gys[r] = owner ? 0.5f * (scol[r + 2] - scol[r]) : 0.f;
        g00 += gxs[r] * gxs[r];
        g01 += gxs[r] * gys[r];
        g11 += gys[r] * gys[r];
      }
      g00 = warp_sum(g00);
      g01 = warp_sum(g01);
      g11 = warp_sum(g11);
      const float tr = g00 + g11;
      const float det = g00 * g11 - g01 * g01;
      const float disc = sqrtf(fmaxf(0.25f * tr * tr - det, 0.f));
      const float min_eig = (0.5f * tr - disc) / static_cast<float>(kNWin);
      level_ok = min_eig > p.min_eig_thresh;
      ok_all = ok_all && level_ok;

      if (level_ok) {
        // inv2x2(G + 1e-9 I), the formula of core/linalg.py
        const float a = g00 + 1e-9f, b = g01, c = g01, d = g11 + 1e-9f;
        const float inv_det = 1.f / (a * d - b * c);
        const float i00 = d * inv_det, i01 = -b * inv_det;
        const float i10 = -c * inv_det, i11 = a * inv_det;
        // the search window, in padded coordinates, fixed around the guess
        const int WS = kP1 + 2 * L.search;
        const int wx0 = clampi(floor_idx(gcx) - kHalf - L.search + kPad, 0,
                               L.W + 2 * kPad - WS);
        const int wy0 = clampi(floor_idx(gcy) - kHalf - L.search + kPad, 0,
                               L.H + 2 * kPad - WS);
        for (int it = 0; it < p.iters; ++it) {
          const float ux = gcx - kHalf, uy = gcy - kHalf;
          const int tx = wx0 + clampi(floor_idx(ux) + kPad - wx0, 0, WS - kP1);
          const int ty = wy0 + clampi(floor_idx(uy) + kPad - wy0, 0, WS - kP1);
          const float gfx = ux - floorf(ux), gfy = uy - floorf(uy);
          // Lane c + 1 reads column c of the step's (win+1)^2 patch straight
          // from the level image; the other lanes repeat an edge column.
          const int x = clampi(tx - kPad + clampi(lane - 1, 0, kP1 - 1), 0, L.W - 1);
          const int y0 = ty - kPad;
          float col[kP1];
#pragma unroll
          for (int r = 0; r < kP1; ++r)
            col[r] = __ldg(L.img1 + (clampi(y0 + r, 0, L.H - 1) * L.W + x));
          // bilinear weights, hoisted for the step
          const float w00 = (1.f - gfx) * (1.f - gfy), w01 = gfx * (1.f - gfy);
          const float w10 = (1.f - gfx) * gfy, w11 = gfx * gfy;
          float b0 = 0.f, b1 = 0.f;
          float top = col[0], top_r = __shfl_down_sync(0xffffffffu, col[0], 1);
#pragma unroll
          for (int r = 0; r < kWin; ++r) {
            const float bot = col[r + 1];
            const float bot_r = __shfl_down_sync(0xffffffffu, bot, 1);
            const float dd = top * w00 + top_r * w01 + bot * w10 + bot_r * w11 - tp[r];
            b0 += dd * gxs[r];
            b1 += dd * gys[r];
            top = bot;
            top_r = bot_r;
          }
          b0 = warp_sum(b0);
          b1 = warp_sum(b1);
          ++steps;
          const float sx = -(i00 * b0 + i01 * b1);
          const float sy = -(i10 * b0 + i11 * b1);
          // eps-freeze: a converged feature stops, and would stay where it is
          if (!(sqrtf(sx * sx + sy * sy) > p.eps)) break;
          gcx += sx;
          gcy += sy;
        }
      }
    }
    if (p.trace != nullptr && lane == 0) {
      float* t = p.trace + 4 * (n * p.levels + l);
      t[0] = gcx;
      t[1] = gcy;
      t[2] = (valid && level_ok) ? 1.f : 0.f;
      t[3] = static_cast<float>(steps);
    }
    if (l > 0) {
      gcx *= 2.f;
      gcy *= 2.f;
    }
  }
  if (lane == 0) {
    p.g_out[2 * n] = gcx;
    p.g_out[2 * n + 1] = gcy;
    p.ok_out[n] = ok_all ? 1 : 0;
  }
}

// The launch floor: an empty kernel of lk_pyramid_kernel's grid, block,
// shared memory and argument, for timing the launch alone.
__global__ void __launch_bounds__(32 * kMaxWarps) lk_pyramid_floor_kernel(const Params) {}

size_t smem_bytes(int levels, int warps_per_block) {
  return sizeof(float) * static_cast<size_t>(warps_per_block)
       * static_cast<size_t>(levels * kP0 * kP0);
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int warps_per_block, void* stream) {
  if (p.levels < 1 || p.levels > kMaxLevels || warps_per_block < 1
      || warps_per_block > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.streams < 1 || p.streams > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return 0;
  const size_t smem = smem_bytes(p.levels, warps_per_block);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks((p.n + warps_per_block - 1) / warps_per_block, p.streams);
  kernel<<<blocks, 32 * warps_per_block, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const float* const* img0, const float* const* img1,
                   const long long* stride, const int* H, const int* W, const int* search,
                   int levels, int streams, const float* pts, const float* g_top,
                   const unsigned char* valid, int n, int iters, float eps,
                   float min_eig_thresh, float* g_out, unsigned char* ok_out, float* trace) {
  Params p{};
  for (int l = 0; l < levels && l < kMaxLevels; ++l)
    p.lv[l] = Level{img0[l], img1[l], stride[l], H[l], W[l], search[l]};
  p.levels = levels;
  p.streams = streams;
  p.pts = pts;
  p.g_top = g_top;
  p.valid = valid;
  p.n = n;
  p.iters = iters;
  p.eps = eps;
  p.min_eig_thresh = min_eig_thresh;
  p.g_out = g_out;
  p.ok_out = ok_out;
  p.trace = trace;
  return p;
}

}  // namespace

extern "C" int lk_pyramid_win() { return kWin; }
extern "C" int lk_pyramid_max_levels() { return kMaxLevels; }
extern "C" int lk_pyramid_max_warps() { return kMaxWarps; }
extern "C" size_t lk_pyramid_smem_bytes(int levels, int warps_per_block) {
  return smem_bytes(levels, warps_per_block);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// img0/img1/stride/H/W/search hold one entry per level, level 0 first;
// `streams` image pairs per level, `n` features per stream.
extern "C" int lk_pyramid_launch(const float* const* img0, const float* const* img1,
                                 const long long* stride, const int* H, const int* W,
                                 const int* search, int levels, int streams, const float* pts,
                                 const float* g_top, const unsigned char* valid, int n,
                                 int iters, float eps, float min_eig_thresh, float* g_out,
                                 unsigned char* ok_out, float* trace, int warps_per_block,
                                 void* stream) {
  const Params p = make_params(img0, img1, stride, H, W, search, levels, streams, pts, g_top,
                               valid, n, iters, eps, min_eig_thresh, g_out, ok_out, trace);
  return p.streams == 1 ? launch(lk_pyramid_kernel<false>, p, warps_per_block, stream)
                         : launch(lk_pyramid_kernel<true>, p, warps_per_block, stream);
}

// The empty kernel, launched exactly as lk_pyramid_launch launches the real one.
extern "C" int lk_pyramid_floor_launch(const float* const* img0, const float* const* img1,
                                       const long long* stride, const int* H, const int* W,
                                       const int* search, int levels, int streams,
                                       const float* pts, const float* g_top,
                                       const unsigned char* valid, int n, int iters,
                                       float eps, float min_eig_thresh, float* g_out,
                                       unsigned char* ok_out, float* trace,
                                       int warps_per_block, void* stream) {
  const Params p = make_params(img0, img1, stride, H, W, search, levels, streams, pts, g_top,
                               valid, n, iters, eps, min_eig_thresh, g_out, ok_out, trace);
  return launch(lk_pyramid_floor_kernel, p, warps_per_block, stream);
}
