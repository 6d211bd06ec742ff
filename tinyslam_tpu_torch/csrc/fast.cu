// Fused FAST stage for one pyramid level, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyslam_tpu/ops/fast_pallas.py:
// fast_score_map_fused (body _all_maps).  Per pixel of an (H, W) float32
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
// What bounds it on the H100: bytes.  At 640x480 it reads one map and
// writes five (about 7.4 MB), against a few hundred flops per pixel.  Each
// 256-thread block owns a 32x32 output tile, loads it once with an 8-pixel
// halo (moments reach 7, the ring 3 plus 1 for NMS) into shared memory,
// computes the scores of the tile plus a 1-pixel ring and the separable
// intermediates there, and writes all five maps with coalesced stores.
// The TPU kernel's lane-shift hoisting has no counterpart: shared-memory
// reads at any offset cost the same.
//
// Edges clamp (the load clamps coordinates), as the plain PyTorch version
// tinyslam_tpu_torch/ops/fast.py:fast_maps does; the TPU kernel wraps.
// Every sum runs in the plain version's order with explicitly rounded
// operations (__fadd_rn, __fmul_rn), so nvcc contracts nothing into an FMA
// and all five maps match the plain version bit for bit.
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

// The 16-point Bresenham circle of radius 3, clockwise from (0, -3).
__constant__ int RING_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

struct Taps {
  float t[2 * BR + 1];
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

__global__ void __launch_bounds__(NT)
fast_maps_kernel(const float* __restrict__ img, const float* __restrict__ thresh,
                 float* __restrict__ score_raw, float* __restrict__ score_nms,
                 float* __restrict__ m10, float* __restrict__ m01,
                 float* __restrict__ blurred, int h, int w, int border,
                 int streak, Taps taps) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[TH + 2][TW + 2];     // tile plus a 1-px ring
  __shared__ float s_boxy[TH][TW + 2 * MR];     // column sums of 15 rows
  __shared__ float s_boxx[TH + 2 * MR][TW];     // row sums of 15 columns
  __shared__ float s_blurx[TH + 2 * BR][TW];    // X pass of the blur

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const float t = *thresh;

  // 1. Stage the tile and its halo, clamping to the edge.
  for (int k = tid; k < SH * SW; k += NT) {
    const int r = k / SW, c = k % SW;
    const int gy = min(max(y0 - HALO + r, 0), h - 1);
    const int gx = min(max(x0 - HALO + c, 0), w - 1);
    s_img[r][c] = img[gy * w + gx];
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

  // 2b. box_y: rows y0..y0+TH-1, columns x0-MR..x0+TW+MR-1 (staged col + 1).
  for (int k = tid; k < TH * (TW + 2 * MR); k += NT) {
    const int r = k / (TW + 2 * MR), c = k % (TW + 2 * MR);
    float acc = s_img[r + HALO - MR][c + HALO - MR];
#pragma unroll
    for (int q = 1; q <= 2 * MR; ++q)
      acc = __fadd_rn(acc, s_img[r + HALO - MR + q][c + HALO - MR]);
    s_boxy[r][c] = acc;
  }
  // 2c. box_x: rows y0-MR..y0+TH+MR-1, columns x0..x0+TW-1.
  for (int k = tid; k < (TH + 2 * MR) * TW; k += NT) {
    const int r = k / TW, c = k % TW;
    float acc = s_img[r + HALO - MR][c + HALO - MR];
#pragma unroll
    for (int q = 1; q <= 2 * MR; ++q)
      acc = __fadd_rn(acc, s_img[r + HALO - MR][c + HALO - MR + q]);
    s_boxx[r][c] = acc;
  }
  // 2d. Blur X pass: rows y0-BR..y0+TH+BR-1, columns x0..x0+TW-1.
  for (int k = tid; k < (TH + 2 * BR) * TW; k += NT) {
    const int r = k / TW, c = k % TW;
    float acc = __fmul_rn(s_img[r + HALO - BR][c + HALO - BR], taps.t[0]);
#pragma unroll
    for (int q = 1; q <= 2 * BR; ++q)
      acc = __fadd_rn(acc, __fmul_rn(s_img[r + HALO - BR][c + HALO - BR + q], taps.t[q]));
    s_blurx[r][c] = acc;
  }
  __syncthreads();

  // 3. NMS, the ramp halves of the moments and the blur Y pass; store.
  for (int k = tid; k < TH * TW; k += NT) {
    const int r = k / TW, c = k % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const float s = s_score[r + 1][c + 1];
    bool keep = s > 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float nb = s_score[r + 1 + dy][c + 1 + dx];
        const bool earlier = dy < 0 || (dy == 0 && dx < 0);
        keep = keep && (earlier ? s > nb : s >= nb);
      }
    }
    float a10 = __fmul_rn(s_boxy[r][c], -(float)MR);
    float a01 = __fmul_rn(s_boxx[r][c], -(float)MR);
#pragma unroll
    for (int q = 1; q <= 2 * MR; ++q) {
      if (q == MR) continue;
      const float coef = (float)(q - MR);
      a10 = __fadd_rn(a10, __fmul_rn(s_boxy[r][c + q], coef));
      a01 = __fadd_rn(a01, __fmul_rn(s_boxx[r + q][c], coef));
    }
    float ab = __fmul_rn(s_blurx[r][c], taps.t[0]);
#pragma unroll
    for (int q = 1; q <= 2 * BR; ++q)
      ab = __fadd_rn(ab, __fmul_rn(s_blurx[r + q][c], taps.t[q]));
    const int o = gy * w + gx;
    score_raw[o] = s;
    score_nms[o] = keep ? s : 0.f;
    m10[o] = a10;
    m01[o] = a01;
    blurred[o] = ab;
  }
}

}  // namespace

extern "C" int tinyslam_fast_maps(const float* img, const float* thresh,
                                  float* score_raw, float* score_nms,
                                  float* m10, float* m01, float* blurred,
                                  int h, int w, int border, int streak,
                                  float t0, float t1, float t2, float t3,
                                  float t4, float t5, float t6,
                                  cudaStream_t stream) {
  const Taps taps = {{t0, t1, t2, t3, t4, t5, t6}};
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_maps_kernel<<<grid, NT, 0, stream>>>(img, thresh, score_raw, score_nms,
                                            m10, m01, blurred, h, w, border,
                                            streak, taps);
  return (int)cudaGetLastError();
}

extern "C" const char* tinyslam_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
