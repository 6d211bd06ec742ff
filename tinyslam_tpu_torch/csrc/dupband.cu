// The keyframe triangulation's duplicate test and local depth band, CUDA
// C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this block to XLA
// (tinyslam_tpu/models/vo.py:204-225), and the port's plain version
// (tinyslam_tpu_torch/ops/dupband_cuda.py:dup_band_plain) builds full
// (N, M) matrices for it: Hamming distances, squared pixel distances, the
// masks, and a sort of every row's neighbour depths for their median.  For
// N features (rows) against M map points (columns) this kernel computes,
// without any (N, M) array:
//   dup[i]      any j with hamming(i, j) <= 40 and valid[j] and, where
//               gate != 0, d2(i, j) < r2 and in_view[j];
//   n_neigh[i]  #{j : d2(i, j) < 1600 and in_view[j]} (within 40 px);
//   z_local[i]  the median of z[j] over those j, NaN ignored: the mean of
//               the lo-th and hi-th smallest (lo = (n - 1) / 2, hi = n / 2,
//               n the count that is not NaN), NaN where n = 0;
// with d2 = (x_i - u_j)^2 + (y_i - v_j)^2, each step rounded in fp32 in the
// plain version's order (__fsub_rn, __fmul_rn, __fadd_rn: no FMA), and the
// median (a + b) * 0.5 in fp32.  Hamming is popc of the XOR of the packed
// bits, exact as the plain version's +-1 product is.  Every output is an
// integer, a comparison or a median of unchanged values, so the kernel is
// bit-equal to the plain version.
//
// What bounds it on the H100: the launch, and the map's reads from L2.
// At the keyframe's shape (2048 x 8192) the inputs are ~0.5 MB (0.15 us at
// 3.35 TB/s) and the 16.7 M pair tests ~84 M fp32 operations (1.25 us at 67
// TFLOP/s), while a feature has a few dozen map points within 40 px.  The
// plain version moved ~1.7 GB through device memory and sorted 16.7 M
// depths for that.  So the design does the whole block in one launch, with
// nothing to fill beforehand and no second launch:
//   * A CTA (8 warps) owns ROWS = 8 rows; 2048 rows are 256 CTAs, two an SM,
//     all resident.  The rows' pixels sit in registers and their
//     descriptors in shared memory; the CTA streams the map once, a point a
//     thread a tile, each tile's points (u, v, z, flags and the 32-byte
//     descriptor) loaded into registers while the previous tile is tested
//     (double buffered in registers: a point is used by its own thread
//     only, so shared memory would add a copy and gain nothing).  Each CTA
//     reads the map from L2 once (256 x 0.37 MB over a launch): more rows a
//     CTA read less, but leave fewer warps an SM to hide the reads (on an
//     H100 at 2048 x 8192, 16 rows took 1.4x as long, 4 rows 1.1x).
//   * A thread tests its point against every row of the CTA without a
//     branch, into two bit masks: the rows it is a neighbour of (within 40
//     px, in view) and the rows whose duplicate gate it passes.  The
//     Hamming distance runs only for the second (every valid point where
//     gate == 0), and not for a row already known to be a duplicate.
//   * The neighbours' depths go onto their rows' lists in shared memory
//     (CAP = 512 a row): one ballot a row, then one atomicAdd for all the
//     rows (lane r adds row r's count), each lane's slot from its rank.
//     Every neighbour is counted whether or not it fits.
//   * Then a warp a row selects the lo-th smallest depth by a radix select
//     (four passes of 8 bits over order-preserving keys of the floats, a
//     256-bin histogram a warp, lanes of one bin adding once together), and
//     the hi-th from one more pass (the lo-th value itself where enough keys
//     equal it, else the smallest key above it).  A row with more than CAP
//     neighbours takes the same selection over its neighbours recomputed
//     from global memory (the overflow pass, exact; each such row adds one
//     to `overflow`).
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads of a CTA
constexpr int NW = NT / 32;              // warps
constexpr int ROWS = 8;                  // rows (features) of a CTA; <= 32 (bit masks)
constexpr int CAP = 512;                 // neighbour depths a row's list holds
constexpr float LOCAL_D2 = 1600.0f;      // (40 px)^2, the local band's radius
constexpr int MAX_HAMMING = 40;          // a similar descriptor
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NAN_KEY = 0xffffffffu;  // above every number's key

// An order-preserving key of a float (its bits, the sign's order made
// unsigned); NaN above everything.
__device__ __forceinline__ unsigned key_of(float z) {
  if (z != z) return NAN_KEY;
  const unsigned u = __float_as_uint(z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float dist2(float x, float y, float u, float v) {
  const float du = __fsub_rn(x, u), dv = __fsub_rn(y, v);
  return __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
}

struct Point {          // one map point, as a thread holds it
  float u, v, z;
  bool valid, in_view;
  uint4 d0, d1;         // the packed descriptor
};

struct Args {
  const float2* xy;     // (n,) the rows' pixels
  const uint4* desc;    // (n, 2) the rows' descriptors
  const float* u;       // (m,) the map's projections and depths
  const float* v;
  const float* z;
  const uint4* mdesc;   // (m, 2)
  const unsigned char* valid;
  const unsigned char* in_view;
  int n, m, gate;
  float r2;
  unsigned char* dup;   // (n,) bool
  float* z_local;       // (n,)
  int* n_neigh;         // (n,)
  unsigned long long* overflow;
};

__device__ __forceinline__ Point load_point(const Args& a, int j) {
  Point p;
  if (j < a.m) {
    p.u = __ldg(a.u + j);
    p.v = __ldg(a.v + j);
    p.z = __ldg(a.z + j);
    p.valid = __ldg(a.valid + j) != 0;
    p.in_view = __ldg(a.in_view + j) != 0;
    p.d0 = __ldg(a.mdesc + 2 * j);
    p.d1 = __ldg(a.mdesc + 2 * j + 1);
  } else {              // past the map: no test passes
    p.u = p.v = p.z = 0.0f;
    p.valid = p.in_view = false;
    p.d0 = p.d1 = make_uint4(0, 0, 0, 0);
  }
  return p;
}

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4& b0,
                                       const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// The k-th smallest (from 0) of the keys a warp visits: a radix select, 8
// bits a pass, in `hist` (256 words of this warp, 16-byte aligned).
// `keys(f)` calls f(has, key) in warp-uniform rounds, `has` where the lane
// holds a key this round; k must be below their number.  Lanes that add to
// the same bin add once, together (__match_any_sync): the keys of nearby
// depths share their high bits.
template <class Keys>
__device__ unsigned select_kth(const Keys& keys, unsigned k, unsigned* hist, int lane) {
  unsigned prefix = 0, mask = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    reinterpret_cast<uint4*>(hist)[lane * 2] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(hist)[lane * 2 + 1] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    keys([&](bool has, unsigned key) {
      const bool take = has && (key & mask) == prefix;
      const unsigned bin = take ? (key >> shift) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(FULL, bin);
      if (take && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], (unsigned)__popc(peers));
    });
    __syncwarp();
    const uint4 h0 = reinterpret_cast<const uint4*>(hist)[lane * 2];
    const uint4 h1 = reinterpret_cast<const uint4*>(hist)[lane * 2 + 1];
    const unsigned c[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += c[i];
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned excl = incl - sum;
    const int owner = __ffs(__ballot_sync(FULL, excl <= k && k < incl)) - 1;
    unsigned rest = k - excl;
    int bin = -1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (bin < 0) {
        if (rest < c[i]) bin = i;
        else rest -= c[i];
      }
    }
    const unsigned digit = __shfl_sync(FULL, (unsigned)(lane * 8 + bin), owner);
    k = __shfl_sync(FULL, rest, owner);
    prefix |= digit << shift;
    mask |= 0xffu << shift;
    __syncwarp();                        // the histogram is cleared next pass
  }
  return prefix;
}

// The hi-th smallest key given the lo-th, `a`, and hi = lo + 1: `a` where
// more than hi keys are <= a, else the smallest key above a.
template <class Keys>
__device__ unsigned next_kth(const Keys& keys, unsigned a, unsigned hi) {
  unsigned le = 0, above = NAN_KEY;
  keys([&](bool has, unsigned key) {
    if (has && key <= a) ++le;
    else if (has) above = min(above, key);
  });
  le = __reduce_add_sync(FULL, le);
  above = __reduce_min_sync(FULL, above);
  return le > hi ? a : above;
}

__global__ void __launch_bounds__(NT) dupband_kernel(Args a) {
  __shared__ uint4 row_desc[ROWS][2];
  __shared__ unsigned count[ROWS], nans[ROWS];
  __shared__ volatile int dup[ROWS];
  __shared__ unsigned list[ROWS][CAP];
  __shared__ __align__(16) unsigned hist[NW][256];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  if (tid < ROWS) {
    const int i = row0 + tid;
    row_desc[tid][0] = i < a.n ? a.desc[2 * i] : make_uint4(0, 0, 0, 0);
    row_desc[tid][1] = i < a.n ? a.desc[2 * i + 1] : make_uint4(0, 0, 0, 0);
    count[tid] = nans[tid] = 0;
    dup[tid] = 0;
  }
  // The rows' pixels, in every thread's registers; a row past n is NaN,
  // which passes no test.
  float rx[ROWS], ry[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float nan = __int_as_float(0x7fc00000);
    const float2 p = row0 + r < a.n ? __ldg(a.xy + row0 + r) : make_float2(nan, nan);
    rx[r] = p.x;
    ry[r] = p.y;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;     // the lanes under this one

  Point cur = load_point(a, tid);
  for (int base = 0; base < a.m; base += NT) {
    const Point p = cur;
    cur = load_point(a, base + NT + tid);       // the next tile, in flight
    // Every row's tests of this thread's point, as bit masks: no branch.
    unsigned nbr = 0, cand = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float d2 = dist2(rx[r], ry[r], p.u, p.v);
      nbr |= (unsigned)(p.in_view && d2 < LOCAL_D2) << r;
      cand |= (unsigned)(p.valid && (!a.gate || (p.in_view && d2 < a.r2))) << r;
    }
    // The Hamming test of the rows whose gate the point passes (few where
    // gated) and that are not yet known duplicates.
    while (cand) {
      const int r = __ffs(cand) - 1;
      cand &= cand - 1;
      if (!dup[r] && hamming(p.d0, p.d1, row_desc[r][0], row_desc[r][1]) <= MAX_HAMMING)
        dup[r] = 1;
    }
    // The neighbours' depths onto their rows' lists: one ballot a row, one
    // atomic for all rows (lane r adds row r's count), the lanes' slots from
    // their ranks.
    if (__any_sync(FULL, nbr)) {
      unsigned ball[ROWS], mine = 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        ball[r] = __ballot_sync(FULL, (nbr >> r) & 1u);
        if (lane == r) mine = ball[r];
      }
      unsigned at = 0;
      if (mine) at = atomicAdd(&count[lane], (unsigned)__popc(mine));
      const unsigned zkey = key_of(p.z);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const unsigned slot = __shfl_sync(FULL, at, r) + __popc(ball[r] & below);
        if (((nbr >> r) & 1u) && slot < CAP) list[r][slot] = zkey;
      }
      if (zkey == NAN_KEY) {
        for (unsigned b = nbr; b; b &= b - 1) atomicAdd(&nans[__ffs(b) - 1], 1u);
      }
    }
  }
  __syncthreads();

  for (int r = warp; r < ROWS; r += NW) {
    const int i = row0 + r;
    if (i >= a.n) break;                         // warp-uniform
    const unsigned n_all = count[r], n = n_all - nans[r];
    float zl = __int_as_float(0x7fc00000);       // NaN: no neighbour
    if (n > 0) {
      const unsigned lo = (n - 1) / 2, hi = n / 2;
      unsigned ka, kb;
      if (n_all <= CAP) {
        const unsigned* own = list[r];
        auto keys = [&](auto f) {
          for (unsigned q0 = 0; q0 < n_all; q0 += 32) {
            const unsigned q = q0 + lane;
            f(q < n_all, q < n_all ? own[q] : 0u);
          }
        };
        ka = select_kth(keys, lo, hist[warp], lane);
        kb = hi == lo ? ka : next_kth(keys, ka, hi);
      } else {
        // The overflow pass: the row's neighbours again, from the map in
        // global memory, by the same tests; NaN depths left out.  A lane
        // loads four points a round, all in flight at once.
        const float2 at = __ldg(a.xy + i);
        auto keys = [&](auto f) {
          for (int j0 = 0; j0 < a.m; j0 += 128) {
            bool has[4];
            unsigned key[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = j0 + 32 * q + lane;
              has[q] = false;
              key[q] = 0;
              if (j < a.m) {
                const float zj = __ldg(a.z + j);
                has[q] = __ldg(a.in_view + j) && zj == zj &&
                         dist2(at.x, at.y, __ldg(a.u + j), __ldg(a.v + j)) < LOCAL_D2;
                key[q] = key_of(zj);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) f(has[q], key[q]);
          }
        };
        ka = select_kth(keys, lo, hist[warp], lane);
        kb = hi == lo ? ka : next_kth(keys, ka, hi);
        if (lane == 0) atomicAdd(a.overflow, 1ull);
      }
      zl = __fmul_rn(__fadd_rn(float_of(ka), float_of(kb)), 0.5f);
    }
    if (lane == 0) {
      a.dup[i] = dup[r] != 0;
      a.z_local[i] = zl;
      a.n_neigh[i] = (int)n_all;
    }
  }
}

}  // namespace

// n rows (xy (n, 2) float32, desc (n, 8) int32, 16-byte aligned) against m
// map points (u, v, z (m,) float32, mdesc (m, 8) int32 16-byte aligned,
// valid and in_view (m,) bool); gate != 0 puts the pixel gate d2 < r2 (r2
// rounded to float32) and in_view on the duplicate test.  Writes dup (n,)
// bool, z_local (n,) float32 and n_neigh (n,) int32, and adds to
// *overflow the rows that took the overflow pass.
extern "C" int tinyslam_dupband(const void* xy, const void* desc, const void* u, const void* v,
                                const void* z, const void* mdesc, const void* valid,
                                const void* in_view, int n, int m, int gate, float r2,
                                void* dup, void* z_local, void* n_neigh, void* overflow,
                                cudaStream_t stream) {
  if (n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.xy = static_cast<const float2*>(xy);
  a.desc = static_cast<const uint4*>(desc);
  a.u = static_cast<const float*>(u);
  a.v = static_cast<const float*>(v);
  a.z = static_cast<const float*>(z);
  a.mdesc = static_cast<const uint4*>(mdesc);
  a.valid = static_cast<const unsigned char*>(valid);
  a.in_view = static_cast<const unsigned char*>(in_view);
  a.n = n;
  a.m = m;
  a.gate = gate;
  a.r2 = r2;
  a.dup = static_cast<unsigned char*>(dup);
  a.z_local = static_cast<float*>(z_local);
  a.n_neigh = static_cast<int*>(n_neigh);
  a.overflow = static_cast<unsigned long long*>(overflow);
  dupband_kernel<<<(unsigned)((n + ROWS - 1) / ROWS), NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The neighbour depths a row's list holds: a row with more takes the
// overflow pass.
extern "C" int tinyslam_dupband_cap() { return CAP; }
