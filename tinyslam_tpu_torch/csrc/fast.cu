// Fused FAST stage over a whole image pyramid, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyslam_tpu/ops/fast_pallas.py:
// fast_score_map_fused (body _all_maps).  Per pixel of every (H, W) float32
// level it writes five float32 maps in one pass:
//   score_raw  FAST-16 margin score max(sum(d-t)+, sum(-d-t)+) where the
//              brighter or darker ring bitmask has a circular run of at
//              least `streak` bits, 0 elsewhere and within `border` px of
//              the edge;
//   score_nms  3x3 non-max suppression of score_raw (strict > against
//              raster-earlier neighbours, >= against later ones; pixels
//              outside the image count as -inf);
//   m10, m01   15x15 intensity-centroid moments (separable box + ramp);
//   blurred    separable 7-tap Gaussian (the level BRIEF samples).
//
// What bounds it on the H100: bytes, then the stencil arithmetic.  A
// 640x480 frame's four levels hold 408,000 pixels; each is read once and
// written five times (9.8 MB, 2.9 us at 3.35 TB/s) against a few hundred
// flops a pixel.  Design: ONE launch per batch of frames.  The grid's x is
// flat over the 32x32 tiles of every level (406 tiles at 640x480, about 3
// blocks of 256 threads per SM, one wave a frame), its y is the frame; a
// block finds its level and origin in a small table passed by value, and
// its frame's planes at frame * h * w past the level's first (levels come
// as (B, H_l, W_l), frames contiguous; B = 1 is the single-frame launch)
// and its threshold (one shared by the batch, or one a frame: B camera
// streams, each with its own adaptive threshold).
// It stages its tile with an 8-pixel halo (moments reach 7, the ring 3
// plus 1 for NMS) in shared memory: rows of a tile
// clear of the left and right edges arrive by 16-byte cp.async when the
// level's rows are 16-byte aligned; tiles at an edge or of an odd width
// (131) take a clamped scalar path inside the same kernel.  It then computes
// the scores of the tile plus a 1-pixel ring and the separable
// intermediates there (four neighbouring outputs a thread, from one run of
// staged values in registers), and each thread writes four neighbouring
// pixels of all five maps, as float4 where the level is aligned.
//
// Edges clamp (the staging clamps coordinates), as the plain PyTorch
// version tinyslam_tpu_torch/ops/fast.py:fast_maps does; the TPU kernel
// wraps.  Every sum runs in the plain version's order with explicitly
// rounded operations (__fadd_rn, __fmul_rn), so nvcc contracts nothing into
// an FMA and all five maps match the plain version bit for bit.
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;               // output tile width
constexpr int TH = 32;               // output tile height
constexpr int HALO = 8;              // staged halo on every side
constexpr int SW = TW + 2 * HALO;    // 48
constexpr int SH = TH + 2 * HALO;    // 48
constexpr int MR = 7;                // moment radius
constexpr int BR = 3;                // blur radius
constexpr int NT = 256;              // threads per block
constexpr int QW = 4;                // pixels a thread writes in stage 3
constexpr int MAX_LEVELS = 8;

static_assert(TH * TW == NT * QW && QW == 4, "stage 3 gives each thread one float4");

// The 16-point Bresenham circle of radius 3, clockwise from (0, -3).
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

struct Level {
  const float* img;
  float* out[5];        // score_raw, score_nms, m10, m01, blurred
  int h, w;
  int tiles_x;
  int tile0;            // first flat tile of this level
  int aligned;          // rows and all six maps 16-byte aligned
};

struct Pyramid {
  Level lv[MAX_LEVELS];
  int n;
  float taps[2 * BR + 1];
};

__device__ __forceinline__ int rot16(int x, int c) {
  return ((x >> c) | (x << (16 - c))) & 0xFFFF;
}

// Nonzero iff the 16-bit mask has a circular run of >= n set bits: runs of
// length 2^k by doubling, n composed from its binary digits, largest first.
__device__ __forceinline__ int runs16(int x, int n) {
  const int p1 = x & 0xFFFF;
  const int p2 = p1 & rot16(p1, 1);
  const int p4 = p2 & rot16(p2, 2);
  const int p8 = p4 & rot16(p4, 4);
  const int p16 = p8 & rot16(p8, 8);
  int run = 0xFFFF, len = 0;
  if (n & 16) { run &= rot16(p16, len); len += 16; }
  if (n & 8) { run &= rot16(p8, len); len += 8; }
  if (n & 4) { run &= rot16(p4, len); len += 4; }
  if (n & 2) { run &= rot16(p2, len); len += 2; }
  if (n & 1) { run &= rot16(p1, len); }
  return run;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(NT)
fast_pyramid_kernel(const Pyramid pyr, const float* __restrict__ thresh,
                    int thresh_stride, int border, int streak) {
  __shared__ __align__(16) float s_img[SH][SW];
  __shared__ float s_score[TH + 2][TW + 2];     // tile plus a 1-px ring
  __shared__ float s_boxy[TH][TW + 2 * MR];     // column sums of 15 rows
  __shared__ __align__(16) float s_boxx[TH + 2 * MR][TW];    // row sums of 15 columns
  __shared__ __align__(16) float s_blurx[TH + 2 * BR][TW];   // X pass of the blur

  // The level of this tile: the last one whose first tile is <= blockIdx.x
  // (selected with constant indices, so the table stays in parameter space).
  const int tile = blockIdx.x;
  Level L = pyr.lv[0];
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k < pyr.n && tile >= pyr.lv[k].tile0) L = pyr.lv[k];
  const int h = L.h, w = L.w;
  // This block's frame: every plane of the level is B frames of h * w.
  const size_t frame = (size_t)blockIdx.y * h * w;
  const float* __restrict__ img = L.img + frame;
  const int x0 = ((tile - L.tile0) % L.tiles_x) * TW;
  const int y0 = ((tile - L.tile0) / L.tiles_x) * TH;
  const int tid = threadIdx.x;
  const float t = thresh[blockIdx.y * thresh_stride];   // stride 0: one shared threshold

  // 1. Stage the tile and its halo, clamping to the edge.  Clear of the
  // left and right edges each staged row is 12 aligned 16-byte chunks.
  if (L.aligned && x0 - HALO >= 0 && x0 - HALO + SW <= w) {
    for (int k = tid; k < SH * (SW / 4); k += NT) {
      const int r = k / (SW / 4), q = k % (SW / 4);
      const int gy = min(max(y0 - HALO + r, 0), h - 1);
      cp_async16(&s_img[r][4 * q], img + (size_t)gy * w + (x0 - HALO) + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int k = tid; k < SH * SW; k += NT) {
      const int r = k / SW, c = k % SW;
      const int gy = min(max(y0 - HALO + r, 0), h - 1);
      const int gx = min(max(x0 - HALO + c, 0), w - 1);
      s_img[r][c] = img[(size_t)gy * w + gx];
    }
  }
  __syncthreads();

  // 2a. FAST scores of the tile plus a 1-pixel ring.  Region (i, j) is the
  // pixel (y0 - 1 + i, x0 - 1 + j), staged at (i + HALO - 1, j + HALO - 1).
  for (int k = tid; k < (TH + 2) * (TW + 2); k += NT) {
    const int i = k / (TW + 2), j = k % (TW + 2);
    const int gy = y0 - 1 + i, gx = x0 - 1 + j;
    float s;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
      s = -INFINITY;
    } else if (gy < border || gy >= h - border || gx < border || gx >= w - border) {
      s = 0.f;
    } else {
      const int sy = i + HALO - 1, sx = j + HALO - 1;
      const float c = s_img[sy][sx];
      int bo = 0, bu = 0;
      float mo = 0.f, mu = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float d = __fsub_rn(s_img[sy + RING_DY[q]][sx + RING_DX[q]], c);
        bo |= (d > t) << q;
        bu |= (d < -t) << q;
        mo = __fadd_rn(mo, fmaxf(__fsub_rn(d, t), 0.f));
        mu = __fadd_rn(mu, fmaxf(__fsub_rn(-d, t), 0.f));
      }
      const bool corner = (runs16(bo, streak) | runs16(bu, streak)) != 0;
      s = corner ? fmaxf(mo, mu) : 0.f;
    }
    s_score[i][j] = s;
  }

  // 2b-2d: each item is QW neighbouring outputs from one staged run of
  // values in registers; every output keeps its own sum in the plain order.
  // 2b. box_y: rows y0..y0+TH-1, columns x0-MR..x0+TW+MR-1 (staged col + 1),
  // QW rows an item.
  for (int k = tid; k < (TH / QW) * (TW + 2 * MR); k += NT) {
    const int r0 = (k / (TW + 2 * MR)) * QW, c = k % (TW + 2 * MR);
    float run[QW + 2 * MR];
#pragma unroll
    for (int i = 0; i < QW + 2 * MR; ++i) run[i] = s_img[r0 + HALO - MR + i][c + HALO - MR];
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      float acc = run[u];
#pragma unroll
      for (int q = 1; q <= 2 * MR; ++q) acc = __fadd_rn(acc, run[u + q]);
      s_boxy[r0 + u][c] = acc;
    }
  }
  // 2c. box_x: rows y0-MR..y0+TH+MR-1, columns x0..x0+TW-1, QW columns an item.
  for (int k = tid; k < (TH + 2 * MR) * (TW / QW); k += NT) {
    const int r = k / (TW / QW), c0 = (k % (TW / QW)) * QW;
    float run[QW + 2 * MR];
#pragma unroll
    for (int i = 0; i < QW + 2 * MR; ++i) run[i] = s_img[r + HALO - MR][c0 + HALO - MR + i];
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      float acc = run[u];
#pragma unroll
      for (int q = 1; q <= 2 * MR; ++q) acc = __fadd_rn(acc, run[u + q]);
      s_boxx[r][c0 + u] = acc;
    }
  }
  // 2d. Blur X pass: rows y0-BR..y0+TH+BR-1, columns x0..x0+TW-1, QW
  // columns an item.
  for (int k = tid; k < (TH + 2 * BR) * (TW / QW); k += NT) {
    const int r = k / (TW / QW), c0 = (k % (TW / QW)) * QW;
    float run[QW + 2 * BR];
#pragma unroll
    for (int i = 0; i < QW + 2 * BR; ++i) run[i] = s_img[r + HALO - BR][c0 + HALO - BR + i];
#pragma unroll
    for (int u = 0; u < QW; ++u) {
      float acc = __fmul_rn(run[u], pyr.taps[0]);
#pragma unroll
      for (int q = 1; q <= 2 * BR; ++q) acc = __fadd_rn(acc, __fmul_rn(run[u + q], pyr.taps[q]));
      s_blurx[r][c0 + u] = acc;
    }
  }
  __syncthreads();

  // 3. NMS, the ramp halves of the moments and the blur Y pass for QW
  // neighbouring pixels of one row; store them.
  const int r = tid / (TW / QW), c0 = (tid % (TW / QW)) * QW;
  const int gy = y0 + r, gx0 = x0 + c0;
  if (gy >= h || gx0 >= w) return;
  float v[5][QW];
  {
    float sw[3][QW + 2];                 // score rows r-1..r+1 (ring-shifted)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int i = 0; i < QW + 2; ++i) sw[dy][i] = s_score[r + dy][c0 + i];
    float by[QW + 2 * MR];
#pragma unroll
    for (int i = 0; i < QW + 2 * MR; ++i) by[i] = s_boxy[r][c0 + i];
#pragma unroll
    for (int p = 0; p < QW; ++p) {
      const float sc = sw[1][p + 1];
      bool keep = sc > 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const float nb = sw[1 + dy][p + 1 + dx];
          const bool earlier = dy < 0 || (dy == 0 && dx < 0);
          keep = keep && (earlier ? sc > nb : sc >= nb);
        }
      }
      float a10 = __fmul_rn(by[p], -(float)MR);
#pragma unroll
      for (int q = 1; q <= 2 * MR; ++q) {
        if (q == MR) continue;
        a10 = __fadd_rn(a10, __fmul_rn(by[p + q], (float)(q - MR)));
      }
      v[0][p] = sc;
      v[1][p] = keep ? sc : 0.f;
      v[2][p] = a10;
    }
  }
  {  // m01 and the blur Y pass: QW columns a row as one float4
    const float4 b0 = *reinterpret_cast<const float4*>(&s_boxx[r][c0]);
    float a01[QW] = {__fmul_rn(b0.x, -(float)MR), __fmul_rn(b0.y, -(float)MR),
                     __fmul_rn(b0.z, -(float)MR), __fmul_rn(b0.w, -(float)MR)};
#pragma unroll
    for (int q = 1; q <= 2 * MR; ++q) {
      if (q == MR) continue;
      const float coef = (float)(q - MR);
      const float4 b = *reinterpret_cast<const float4*>(&s_boxx[r + q][c0]);
      a01[0] = __fadd_rn(a01[0], __fmul_rn(b.x, coef));
      a01[1] = __fadd_rn(a01[1], __fmul_rn(b.y, coef));
      a01[2] = __fadd_rn(a01[2], __fmul_rn(b.z, coef));
      a01[3] = __fadd_rn(a01[3], __fmul_rn(b.w, coef));
    }
    const float4 g0 = *reinterpret_cast<const float4*>(&s_blurx[r][c0]);
    float ab[QW] = {__fmul_rn(g0.x, pyr.taps[0]), __fmul_rn(g0.y, pyr.taps[0]),
                    __fmul_rn(g0.z, pyr.taps[0]), __fmul_rn(g0.w, pyr.taps[0])};
#pragma unroll
    for (int q = 1; q <= 2 * BR; ++q) {
      const float4 g = *reinterpret_cast<const float4*>(&s_blurx[r + q][c0]);
      ab[0] = __fadd_rn(ab[0], __fmul_rn(g.x, pyr.taps[q]));
      ab[1] = __fadd_rn(ab[1], __fmul_rn(g.y, pyr.taps[q]));
      ab[2] = __fadd_rn(ab[2], __fmul_rn(g.z, pyr.taps[q]));
      ab[3] = __fadd_rn(ab[3], __fmul_rn(g.w, pyr.taps[q]));
    }
#pragma unroll
    for (int p = 0; p < QW; ++p) {
      v[3][p] = a01[p];
      v[4][p] = ab[p];
    }
  }
  const size_t o = frame + (size_t)gy * w + gx0;
  if (L.aligned) {        // w % 4 == 0, so the quad lies wholly inside
#pragma unroll
    for (int mp = 0; mp < 5; ++mp)
      *reinterpret_cast<float4*>(L.out[mp] + o) = make_float4(v[mp][0], v[mp][1], v[mp][2], v[mp][3]);
  } else {
#pragma unroll
    for (int p = 0; p < QW; ++p) {
      if (gx0 + p >= w) break;
#pragma unroll
      for (int mp = 0; mp < 5; ++mp) L.out[mp][o + p] = v[mp][p];
    }
  }
}

}  // namespace

// One launch over n_levels levels of `batch` frames.  `ptrs` holds six
// device pointers a level (the image, then score_raw, score_nms, m10, m01,
// blurred), each to `batch` contiguous (h, w) planes, `dims` its (h, w),
// `taps` the seven blur taps; both arrays are on the host.  Frame b's
// threshold is thresh[b * thresh_stride] on the device: stride 0 shares
// one, stride 1 gives each frame its own.
extern "C" int tinyslam_fast_pyramid(const void* const* ptrs, const int* dims, int n_levels,
                                     int batch, const float* thresh, int thresh_stride,
                                     int border, int streak, const float* taps,
                                     cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || batch < 1 || batch > 65535 ||
      thresh_stride < 0 || thresh_stride > 1)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr = {};
  pyr.n = n_levels;
  for (int q = 0; q < 2 * BR + 1; ++q) pyr.taps[q] = taps[q];
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = pyr.lv[l];
    L.img = static_cast<const float*>(ptrs[6 * l]);
    for (int mp = 0; mp < 5; ++mp) L.out[mp] = static_cast<float*>(const_cast<void*>(ptrs[6 * l + 1 + mp]));
    L.h = dims[2 * l];
    L.w = dims[2 * l + 1];
    if (L.h < 1 || L.w < 1) return (int)cudaErrorInvalidValue;
    L.tiles_x = (L.w + TW - 1) / TW;
    L.tile0 = tiles;
    bool aligned = L.w % 4 == 0;   // then every frame's plane is 16-byte aligned too
    for (int mp = 0; mp < 6; ++mp)
      aligned = aligned && reinterpret_cast<size_t>(ptrs[6 * l + mp]) % 16 == 0;
    L.aligned = aligned;
    tiles += L.tiles_x * ((L.h + TH - 1) / TH);
  }
  fast_pyramid_kernel<<<dim3(tiles, batch), NT, 0, stream>>>(pyr, thresh, thresh_stride, border,
                                                                streak);
  return (int)cudaGetLastError();
}

extern "C" const char* tinyslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
