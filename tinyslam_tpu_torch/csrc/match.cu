// Streaming Hamming matcher, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel tinyslam_tpu/ops/match_pallas.py:
// match_reduce_streaming (body _kernel).  For N packed 256-bit descriptors
// (rows) against M (columns) it computes, without storing the (N, M)
// distance matrix:
//   best[i], idx[i]   the smallest distance of row i and its column (the
//                     lowest column on ties);
//   second[i]         the smallest distance of row i over every column but
//                     exactly idx[i] (BIG when there is none);
//   colcode[j]        min over rows of (dist << nshift | row): the argmin
//                     over rows of column j (lowest row on ties) for the
//                     cross-check.  The wrapper fills it with INT_MAX.
// A distance is sum_w __popc(a_w ^ b_w).  An invalid row or column, or (if
// guided) a pair with (xa-pu)^2 + (ya-pv)^2 >= r2, is replaced by BIG = 2^14.
// That is the semantics of the plain version
// tinyslam_tpu_torch/ops/hamming.py:match_reduce_plain, exactly.
//
// What bounds it on the H100: integer throughput.  At N=2048, M=8192 the
// work is 16.8 M pairs x 8 words of XOR + popcount + add; the bytes (0.33 MB
// of descriptors, read once per block from L2) are small.  Design: each
// 256-thread block owns ROWS=16 rows, staged in shared memory and read as
// broadcasts; thread k streams columns k, k+256, ... through registers and
// keeps best/argmin/second of all 16 rows in registers (the loop replaces
// the TPU's sequential column grid axis).  Per column, the thread reduces
// the block's 16 rows itself and merges across blocks with one atomicMin
// on the packed code; min does not depend on order, so the result is
// deterministic.  At the end the 256 per-thread row states are merged by
// warp shuffles and shared memory.  N=2048 gives 128 blocks on 132 SMs.
// The guided gate rounds like the reference: __fmul_rn/__fadd_rn keep nvcc
// from contracting it into an FMA, and r2 arrives rounded to float32.
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BIG = 1 << 14;

struct RowState {
  int best, idx, second;
};

// Merge two partial (best, argmin, second) states over disjoint column sets.
__device__ __forceinline__ RowState merge(RowState a, RowState b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.idx < b.idx);
  const RowState win = a_wins ? a : b;
  const RowState lose = a_wins ? b : a;
  return {win.best, win.idx, min(win.second, lose.best)};
}

__global__ void __launch_bounds__(NT)
match_reduce_kernel(const int4* __restrict__ desc_a,
                    const unsigned char* __restrict__ valid_a,
                    const float2* __restrict__ xy_a,
                    const int4* __restrict__ desc_b,
                    const unsigned char* __restrict__ valid_b,
                    const float2* __restrict__ proj_b, int n, int m,
                    int guided, float r2, int nshift, int* __restrict__ best_out,
                    int* __restrict__ second_out, int* __restrict__ idx_out,
                    int* __restrict__ colcode) {
  __shared__ int4 s_a[ROWS][2];
  __shared__ int s_va[ROWS];
  __shared__ float2 s_xy[ROWS];
  __shared__ RowState s_red[NWARP][ROWS];

  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, n - row0);
  const int tid = threadIdx.x;
  if (tid < ROWS * 2) {
    const int r = tid / 2;
    s_a[r][tid % 2] = r < nrows ? desc_a[(row0 + r) * 2 + tid % 2] : make_int4(0, 0, 0, 0);
  }
  if (tid < ROWS) {
    s_va[tid] = tid < nrows ? valid_a[row0 + tid] : 0;
    s_xy[tid] = (guided && tid < nrows) ? xy_a[row0 + tid] : make_float2(0.f, 0.f);
  }
  __syncthreads();

  int best[ROWS], idx[ROWS], second[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    best[r] = INT_MAX;
    idx[r] = -1;
    second[r] = BIG;
  }

  for (int j = tid; j < m; j += NT) {
    const int4 b0 = desc_b[2 * j];
    const int4 b1 = desc_b[2 * j + 1];
    const bool vb = valid_b[j] != 0;
    const float2 pb = guided ? proj_b[j] : make_float2(0.f, 0.f);
    int ccode = INT_MAX;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int4 a0 = s_a[r][0];
      const int4 a1 = s_a[r][1];
      int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
              __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
              __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
      bool ok = vb && s_va[r] != 0;
      if (guided) {
        const float du = __fsub_rn(s_xy[r].x, pb.x);
        const float dv = __fsub_rn(s_xy[r].y, pb.y);
        ok = ok && __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < r2;
      }
      d = ok ? d : BIG;
      if (d < best[r]) {
        second[r] = min(second[r], best[r]);
        best[r] = d;
        idx[r] = j;
      } else {
        second[r] = min(second[r], d);
      }
      if (r < nrows) ccode = min(ccode, (d << nshift) | (row0 + r));
    }
    atomicMin(&colcode[j], ccode);
  }

  // Merge the per-thread row states: within each warp, then across warps.
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    RowState st = {best[r], idx[r], second[r]};
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const RowState o = {__shfl_xor_sync(0xffffffffu, st.best, off),
                          __shfl_xor_sync(0xffffffffu, st.idx, off),
                          __shfl_xor_sync(0xffffffffu, st.second, off)};
      st = merge(st, o);
    }
    if (lane == 0) s_red[warp][r] = st;
  }
  __syncthreads();
  if (tid < nrows) {
    RowState st = s_red[0][tid];
    for (int k = 1; k < NWARP; ++k) st = merge(st, s_red[k][tid]);
    best_out[row0 + tid] = st.best;
    second_out[row0 + tid] = st.second;
    idx_out[row0 + tid] = st.idx;
  }
}

}  // namespace

extern "C" int tinyslam_match_reduce(const void* desc_a, const void* valid_a,
                                     const void* xy_a, const void* desc_b,
                                     const void* valid_b, const void* proj_b,
                                     int n, int m, int guided, float r2, int nshift,
                                     int* best, int* second, int* idx, int* colcode,
                                     cudaStream_t stream) {
  const int blocks = (n + ROWS - 1) / ROWS;
  match_reduce_kernel<<<blocks, NT, 0, stream>>>(
      static_cast<const int4*>(desc_a), static_cast<const unsigned char*>(valid_a),
      static_cast<const float2*>(xy_a), static_cast<const int4*>(desc_b),
      static_cast<const unsigned char*>(valid_b), static_cast<const float2*>(proj_b),
      n, m, guided, r2, nshift, best, second, idx, colcode);
  return (int)cudaGetLastError();
}
