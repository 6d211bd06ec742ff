// Streaming Hamming matcher on the int8 tensor cores, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tinyslam_tpu/ops/match_pallas.py:
// match_reduce_streaming (body _kernel).  For N packed 256-bit descriptors
// (rows) against M (columns) it computes, without storing the (N, M)
// distance matrix:
//   best[i], idx[i]   the smallest distance of row i and its column (the
//                     lowest column on ties);
//   second[i]         the smallest distance of row i over every column but
//                     exactly idx[i] (BIG when there is none);
//   col_idx[j]        the argmin over rows of column j (lowest row on ties),
//                     for the cross-check.
// An invalid row or column, or (if guided) a pair with
// (xa-pu)^2 + (ya-pv)^2 >= r2, or (if masked) a pair whose bit of an
// explicit (N, M) pair mask is clear, has distance BIG = 2^14.  That is the
// semantics of the plain version
// tinyslam_tpu_torch/ops/hamming.py:match_reduce_plain, exactly.
//
// What bounds it on the H100: operations.  At N=2048, M=8192 the product
// is 2*N*M*256 = 8.6 G int8 operations (4.3 us at 1,979 TOP/s); the bytes
// (0.5 MB) are nothing.  Design:
//   * Hamming = (256 - sa.sb) / 2 with s in {-1, +1}: the distances come
//     from the int8 tensor cores, wgmma.mma_async m64n64k32 .s32.s8.s8,
//     exact in the int32 accumulator.
//   * A CTA is one warpgroup (128 threads).  It unpacks the 32-byte
//     descriptors of its 128 rows once into +-1 int8 in shared memory
//     (K-major, 128-byte swizzle, as wgmma reads it), then walks its slice
//     of the columns in tiles of 64.  Each tile arrives packed by cp.async,
//     two tiles ahead, into one of two packed buffers, and is unpacked into
//     one of two shared B buffers; no int8 copy is ever written to device
//     memory.  A tile is 2 x 8 wgmma k-steps (128 rows, K = 256), the two
//     row blocks' accumulator chains interleaved; they run while the
//     warps unpack the next tile.
//   * The grid splits the columns into slices as well as the rows into
//     tiles of 128.  The wrapper picks the split whose busiest SM walks the
//     fewest tiles with every CTA resident (MIN_CTAS an SM fit): at
//     2048x8192, 16 x 16 CTAs of 8 tiles, 2 an SM; at 2048x2048, 16 x 16
//     of 2 tiles.
//   * The epilogue runs on the accumulator fragments in registers, where
//     the integer pipe (16 lanes a clock per SM partition) is the limit:
//     so it works on 16-bit codes, two columns of a row in one register,
//     with Hopper's u16x2 min/max.  Per pair, (d << 7 | slot) orders a
//     row's columns and (d << 7 | row in the CTA) a column's rows, d the
//     distance; one IMAD gives both halves of a code register.  A failing
//     pair (invalid, or outside the gate) gets d = 511, decoded as BIG.
//     Per row the two smallest row codes (min/max): the smallest gives best
//     and the lowest-column argmin, the second's distance is `second`
//     (codes are unique, so this excludes exactly the argmin column).  Per
//     column the smallest column code: over a thread's rows in registers,
//     over the warp's 8 lanes of a column by a reduce-scatter (7 shuffles),
//     over the CTA's warps in shared memory (double buffered, so a tile
//     costs two barriers), over the row tiles by atomicMin into `colcode`.
//   * Merge: the codes widen to 32 bits (d << cbits | col, d << nshift |
//     row).  Each CTA writes its rows' two codes per slice to a scratch and
//     arrives at two device counters with one acquire-release atomic
//     (cheaper than a fence in every thread); the last CTA of a row tile
//     (of a slice) merges the rows (reads the columns' codes) and writes
//     the outputs, then returns its counter (its columns' codes) to 0
//     (INT_MAX).  Nothing needs a fill before the launch, and min does not
//     depend on order, so the result is deterministic.
//   * Sequences: B independent matchings (B camera streams, each its own
//     features, map and gate) run as one launch, the sequence the grid's
//     z.  A CTA offsets every array by its sequence (rows by z * n,
//     columns by z * m, its partials, counters and column codes by the
//     sequence's share of each); B = 1 is the single launch.
//   * An explicit pair mask (the third mode, beside unguided and guided)
//     arrives bit-packed, ceil(M / 64) pairs of 32-bit words a row
//     (tinyslam_pack_mask, one launch before the matcher): a thread loads
//     its four rows' two words of a tile while the tile's product runs,
//     and a clear bit turns the pair's dot into the failing one, as the
//     guided gate does.  Validity is handled as unguided.
// The guided gate rounds like the reference: __fmul_rn/__fadd_rn keep nvcc
// from contracting it into an FMA, and r2 arrives rounded to float32.
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // one warpgroup
constexpr int BM = 128;          // rows a CTA (two m64 blocks)
constexpr int BN = 64;           // columns a tile
constexpr int KB = 256;          // descriptor bits = int8 elements
constexpr int BIG = 1 << 14;
constexpr int MAX_TPS = 16;      // tiles a slice: a thread's 8 j a tile x 16 in 7 bits
// 16-bit codes, two columns to a register (u16x2).  For a pair of dot
// `dot`, (256 - dot) * 64 = d << 7 with d = (256 - dot) / 2 in 0..256:
//   row code    d << 7 | k    k = 8 (tile - first tile) + j, the pair's slot
//                             among this thread's columns of one parity;
//   column code d << 7 | rl   rl = the row within the CTA's 128.
// A failing pair takes the dot FAIL16, whose d is 511 (decoded as BIG):
// its codes 65408 | k, 65408 | rl lie above every real code.
constexpr int FAIL16 = -766;     // (256 - FAIL16) / 2 == 511
constexpr unsigned FAIL_CODE = 65408u;
constexpr int MIN_CTAS = 3;      // CTAs an SM, as shared memory allows

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes).
constexpr int PK_PROJ = BN * 32;                  // packed tile: desc, proj, valid
constexpr int PK_VALID = PK_PROJ + BN * 8;
constexpr int PK_BYTES = PK_VALID + BN;
constexpr int OFF_A = 0;                          // 2 x BM x 128 B of +-1
constexpr int OFF_B = OFF_A + BM * KB;            // [2 tiles] 2 x BN x 128 B of +-1
constexpr int OFF_PK = OFF_B + 2 * BN * KB;       // [2 tiles] packed
constexpr int OFF_CXY = OFF_PK + 2 * PK_BYTES;    // float2 [2 tiles][BN]
constexpr int OFF_CM = OFF_CXY + 2 * BN * 8;      // u16 [2 tiles][BN]: 0xFFFF if invalid
constexpr int OFF_COL = OFF_CM + 2 * BN * 2;      // int [2 tiles][4 warps][BN]
constexpr int OFF_FLAG = OFF_COL + 2 * 4 * BN * 4;  // int [2]
constexpr int SMEM_BYTES = OFF_FLAG + 16 + 1024;  // + alignment slack

static_assert(PK_BYTES % 16 == 0 && OFF_PK % 16 == 0 && OFF_CXY % 16 == 0,
              "16-byte cp.async targets");
static_assert(OFF_B % 1024 == 0 && (OFF_B + BN * KB) % 1024 == 0, "swizzle atoms");

struct Args {
  const unsigned* desc_a;        // (n, 8) words
  const unsigned char* valid_a;  // (n,)
  const float2* xy_a;            // (n,) guided only
  const unsigned* desc_b;        // (m, 8)
  const unsigned char* valid_b;  // (m,)
  const float2* proj_b;          // (m,) guided only
  const unsigned* mask;          // (n, mask_words) masked only: pair (i, j) at bit
  int mask_words;                // j % 32 of word j / 32 of row i
  int n, m, nshift, cbits, tps;
  float r2;
  int* best;
  int* second;
  int* idx;
  int* col_idx;
  int2* row_part;                // (slices, n) two smallest row codes
  int* colcode;                  // (m,) smallest column code; INT_MAX between launches
  int* counters;                 // row tiles, then slices; 0 between launches
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// 4 bits -> 4 bytes: +1 where the bit is clear, -1 where it is set.
__device__ __forceinline__ unsigned expand4(unsigned b) {
  const unsigned spread = (b * 0x00204081u) & 0x01010101u;   // bit i -> byte i
  return spread * 0xFEu + 0x01010101u;                         // no carries: one IMAD
}

// Half `hh` of descriptor word `w` of row `row` (of a matrix of `rows` rows
// at shared offset `region`), as 16 bytes of +-1 at their swizzled place:
// K-major, two 128-byte atoms along K, chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ void store_signs(unsigned char* smem, int region, int rows,
                                            int row, int w, int hh, unsigned word) {
  const unsigned h = word >> (16 * hh);
  const uint4 v = make_uint4(expand4(h & 0xF), expand4((h >> 4) & 0xF),
                             expand4((h >> 8) & 0xF), expand4((h >> 12) & 0xF));
  const int c = (w & 3) * 2 + hh;
  const int off = region + (w >> 2) * rows * 128 + row * 128 + ((c ^ (row & 7)) << 4);
  *reinterpret_cast<uint4*>(smem + off) = v;
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[2][32]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 32; ++k) asm volatile("" : "+r"(d[i][k])::"memory");
}

// A CTA's arrival at a merge counter: after a CTA barrier, one thread's
// release makes the CTA's earlier writes visible with it (release is
// cumulative), and its acquire orders the merge's reads after the others'
// arrivals.  Returns the count before.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// Two smallest of the union of two disjoint sets, each given by its two
// smallest codes (lo <= hi).
__device__ __forceinline__ void merge2(int& lo, int& hi, int olo, int ohi) {
  hi = min(max(lo, olo), min(hi, ohi));
  lo = min(lo, olo);
}

// Issue the cp.async of column tile `t` in packed form into packed buffer
// `p`, as one commit group (empty past the slice).  Columns past M arrive
// as zeros (invalid).
template <bool GUIDED>
__device__ __forceinline__ void issue_tile(const Args& a, unsigned char* smem, int t, int t_end,
                                           int p, int tid) {
  if (t < t_end) {
    const int col0 = t * BN;
    const uint32_t pk = smem_u32(smem + OFF_PK + p * PK_BYTES);
    {  // descriptors: BN x 32 B = 128 chunks, one a thread
      const long off = (long)col0 * 32 + tid * 16;
      const int bytes = off < (long)a.m * 32 ? 16 : 0;
      cp_async16(pk + tid * 16,
                 reinterpret_cast<const unsigned char*>(a.desc_b) + (bytes ? off : 0), bytes);
    }
    if (GUIDED && tid < BN * 8 / 16) {  // projections: 32 chunks
      const long off = (long)col0 * 8 + tid * 16;
      const long rest = (long)a.m * 8 - off;
      const int bytes = rest >= 16 ? 16 : (rest > 0 ? (int)rest : 0);
      cp_async16(pk + PK_PROJ + tid * 16,
                 reinterpret_cast<const unsigned char*>(a.proj_b) + (bytes ? off : 0), bytes);
    }
    if (tid >= 32 && tid < 32 + BN / 16) {  // valid bytes: 4 chunks
      const int q = tid - 32;
      const long off = (long)col0 + q * 16;
      const long rest = (long)a.m - off;
      const int bytes = rest >= 16 ? 16 : (rest > 0 ? (int)rest : 0);
      cp_async16(pk + PK_VALID + q * 16, a.valid_b + (bytes ? off : 0), bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Unpack packed buffer `p` into B buffer `buf` and its columns' gate data,
// then make the stores visible to wgmma (the async proxy).
template <bool GUIDED>
__device__ __forceinline__ void unpack_tile(unsigned char* smem, int p, int buf, int tid) {
  const unsigned char* pk = smem + OFF_PK + p * PK_BYTES;
#pragma unroll
  for (int k = 0; k < BN * 8 / NT; ++k) {   // 512 words, 4 a thread
    const int i = tid + k * NT, col = i >> 3, w = i & 7;
    const unsigned word = reinterpret_cast<const unsigned*>(pk)[i];
    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, (w >> 2), word);
    store_signs(smem, OFF_B + buf * BN * KB, BN, col, w, 1 - (w >> 2), word);
  }
  if (tid < BN) {
    const bool vb = pk[PK_VALID + tid] != 0;
    if (GUIDED) {
      const float2 v = reinterpret_cast<const float2*>(pk + PK_PROJ)[tid];
      const float nan = __int_as_float(0x7fc00000);
      reinterpret_cast<float2*>(smem + OFF_CXY)[buf * BN + tid] = vb ? v : make_float2(nan, nan);
    } else {
      reinterpret_cast<unsigned short*>(smem + OFF_CM)[buf * BN + tid] = vb ? 0 : 0xFFFF;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The column minima of a tile over the CTA's four warps, merged into
// colcode.
__device__ __forceinline__ void publish_columns(const Args& a, const int* s_col, int col0,
                                                int tid) {
  if (tid < BN && col0 + tid < a.m) {
    const int* p = s_col + tid;
    atomicMin(&a.colcode[col0 + tid], min(min(p[0], p[BN]), min(p[2 * BN], p[3 * BN])));
  }
}

// 16-bit codes back to the 32-bit codes of the merge.
__device__ __forceinline__ int row_code32(unsigned c16, int t_begin, int lr, int e, int cb) {
  const int d = c16 >> 7, k = c16 & 127;
  const int col = (t_begin + (k >> 3)) * BN + 8 * (k & 7) + 2 * lr + e;
  return ((d == 511 ? BIG : d) << cb) | col;
}

__device__ __forceinline__ int col_code32(unsigned c16, int row0, int ns) {
  const int d = c16 >> 7;
  return ((d == 511 ? BIG : d) << ns) | (row0 + (int)(c16 & 127));
}

// One step of the column reduce-scatter over lanes `lanes` apart: of the
// 2h values v[0..2h), a lane keeps the half its lane bit selects, takes the
// other half of its partner's, and leaves the h minima in v[0..h).
template <int H>
__device__ __forceinline__ void reduce_scatter(unsigned (&v)[BN / 8], int lane, int lanes) {
  const bool upper = (lane & lanes) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const unsigned keep = upper ? v[H + i] : v[i];
    const unsigned send = upper ? v[i] : v[H + i];
    v[i] = __vminu2(keep, __shfl_xor_sync(0xffffffffu, send, lanes));
  }
}

template <bool GUIDED, bool MASKED>
__global__ void __launch_bounds__(NT, MIN_CTAS) match_reduce_kernel(const Args args) {
  // This CTA's sequence, blockIdx.z: every array at the sequence's offset.
  Args a = args;
  {
    const size_t z = blockIdx.z, zn = z * (size_t)args.n, zm = z * (size_t)args.m;
    a.desc_a += zn * 8;
    a.valid_a += zn;
    a.desc_b += zm * 8;
    a.valid_b += zm;
    if (GUIDED) {
      a.xy_a += zn;
      a.proj_b += zm;
    }
    if (MASKED) a.mask += zn * a.mask_words;
    a.best += zn;
    a.second += zn;
    a.idx += zn;
    a.col_idx += zm;
    a.colcode += zm;
    a.row_part += zn * gridDim.x;
    a.counters += z * (gridDim.x + gridDim.y);
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  int* s_col = reinterpret_cast<int*>(smem + OFF_COL);
  int* s_flag = reinterpret_cast<int*>(smem + OFF_FLAG);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lq = lane >> 2, lr = lane & 3;
  const int n = a.n, m = a.m, cb = a.cbits, ns = a.nshift;
  const int q = blockIdx.y, n_rt = gridDim.y;
  const int s = blockIdx.x, slices = gridDim.x;
  const int row0 = q * BM;
  const int t_begin = s * a.tps;
  const int t_end = min(t_begin + a.tps, (m + BN - 1) / BN);

  // Two packed tiles in flight from the start.
  issue_tile<GUIDED>(a, smem, t_begin, t_end, 0, tid);
  issue_tile<GUIDED>(a, smem, t_begin + 1, t_end, 1, tid);

  // This thread's four rows of the accumulator fragments: row
  // 64 * mb + 16 * warp + lq + 8 * half of the CTA, for ri = 2 * mb + half.
  // Per row, lo2/hi2 hold the two smallest row codes of the thread's
  // columns, even ones in the low half, odd ones in the high half.  Guided,
  // a failing pair's dot becomes FAIL16 (an invalid row or column is NaN and
  // fails every gate); unguided, each code is raised to its floor instead:
  // the failing code where the column (for the row code) or the row (for
  // the column code) is invalid, and an invalid row's or column's own
  // output is set in the merge.
  unsigned kcol[4], rfloor[4], lo2[4], hi2[4];
  float rx[4], ry[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int rl = (ri >> 1) * 64 + warp * 16 + lq + (ri & 1) * 8;
    const bool valid = row0 + rl < n && a.valid_a[row0 + rl] != 0;
    kcol[ri] = (16384u + rl) * 0x10001u;
    rfloor[ri] = valid ? 0u : (FAIL_CODE + rl) * 0x10001u;
    rx[ri] = ry[ri] = __int_as_float(0x7fc00000);   // NaN fails every gate
    if (GUIDED && valid) {
      const float2 p = a.xy_a[row0 + rl];
      rx[ri] = p.x;
      ry[ri] = p.y;
    }
    lo2[ri] = hi2[ri] = 0xFFFFFFFFu;
  }

  // The CTA's rows, unpacked once (rows past N are zeros): all loads first.
  {
    unsigned words[BM * 8 / NT];
#pragma unroll
    for (int k = 0; k < BM * 8 / NT; ++k) {
      const int gr = row0 + ((tid + k * NT) >> 3);
      words[k] = gr < n ? a.desc_a[(size_t)gr * 8 + (tid & 7)] : 0u;
    }
#pragma unroll
    for (int k = 0; k < BM * 8 / NT; ++k) {
      const int row = (tid + k * NT) >> 3, w = tid & 7;
      store_signs(smem, OFF_A, BM, row, w, (w >> 2), words[k]);
      store_signs(smem, OFF_A, BM, row, w, 1 - (w >> 2), words[k]);
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // the first tile
  __syncthreads();
  unpack_tile<GUIDED>(smem, 0, 0, tid);
  __syncthreads();
  issue_tile<GUIDED>(a, smem, t_begin + 2, t_end, 0, tid);

  int acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[i][k] = 0;
  for (int t = t_begin; t < t_end; ++t) {
    // Tile t sits unpacked in B buffer `buf`; tile t+1 packed in buffer
    // `buf ^ 1`, tile t+2 on its way to packed buffer `buf`.
    const int buf = (t - t_begin) & 1, col0 = t * BN;
    // The product of tile t, asynchronous: the two row blocks' chains
    // interleaved, 2 x 8 k-steps.
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) {
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const uint32_t aa = sbase + OFF_A + (ks >> 2) * BM * 128 + mb * 64 * 128 + (ks & 3) * 32;
        const uint32_t ba = sbase + OFF_B + buf * BN * KB + (ks >> 2) * BN * 128 + (ks & 3) * 32;
        wgmma_m64n64k32(acc[mb], desc_sw128(aa), desc_sw128(ba), ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

    // Masked: this thread's rows' two mask words of tile t (columns col0 ..
    // col0 + 63), loaded while the product runs.
    unsigned mw[4][2];
    if (MASKED) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = row0 + (ri >> 1) * 64 + warp * 16 + lq + (ri & 1) * 8;
        const unsigned* p = a.mask + (size_t)min(r, n - 1) * a.mask_words + (col0 >> 5);
        mw[ri][0] = __ldg(p);
        mw[ri][1] = __ldg(p + 1);
      }
    }

    // Meanwhile: publish tile t-1's columns, unpack tile t+1 into the other
    // B buffer, and prefetch tile t+3 into the packed buffer it frees.
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // tile t+1
    __syncthreads();
    if (t > t_begin) publish_columns(a, s_col + (buf ^ 1) * 4 * BN, col0 - BN, tid);
    if (t + 1 < t_end) {
      unpack_tile<GUIDED>(smem, buf ^ 1, buf ^ 1, tid);
      __syncthreads();
    }
    issue_tile<GUIDED>(a, smem, t + 3, t_end, buf ^ 1, tid);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // Epilogue on the fragments: register 4 j + 2 half + e of block mb is
    // (row 64 mb + 16 warp + lq + 8 half, column 8 j + 2 lr + e).  The two
    // columns e = 0, 1 of a row share one u16x2 register of codes.
    const float4* s_cxy = reinterpret_cast<const float4*>(smem + OFF_CXY + buf * BN * 8);
    const unsigned* s_cm = reinterpret_cast<const unsigned*>(smem + OFF_CM + buf * BN * 2);
    unsigned cm2[BN / 8];   // per j, the column codes' minima over this thread's rows
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const unsigned krow = (16384u + 8 * (t - t_begin) + j) * 0x10001u;
      float4 cxy = make_float4(0.f, 0.f, 0.f, 0.f);   // columns e = 0, 1
      unsigned cfloor = 0;
      if (GUIDED)
        cxy = s_cxy[4 * j + lr];
      else
        cfloor = s_cm[4 * j + lr] & (krow + (FAIL_CODE - 16384u) * 0x10001u);
      unsigned cc[4];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        int d0 = acc[ri >> 1][j * 4 + (ri & 1) * 2];
        int d1 = acc[ri >> 1][j * 4 + (ri & 1) * 2 + 1];
        if (GUIDED) {
          float du = __fsub_rn(rx[ri], cxy.x), dv = __fsub_rn(ry[ri], cxy.y);
          d0 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < a.r2 ? d0 : FAIL16;
          du = __fsub_rn(rx[ri], cxy.z);
          dv = __fsub_rn(ry[ri], cxy.w);
          d1 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < a.r2 ? d1 : FAIL16;
        }
        if (MASKED) {   // columns 8 j + 2 lr + e: word j / 4, bit 8 (j % 4) + 2 lr + e
          const unsigned bits = mw[ri][j >> 2] >> (8 * (j & 3) + 2 * lr);
          d0 = (bits & 1u) ? d0 : FAIL16;
          d1 = (bits & 2u) ? d1 : FAIL16;
        }
        // K - 64 * (d0 + 65536 d1): each half stays in 0..65535, no borrow.
        const unsigned pd = (unsigned)d0 + ((unsigned)d1 << 16);
        unsigned rc = krow - 64u * pd, c = kcol[ri] - 64u * pd;
        if (!GUIDED) {
          rc = __vmaxu2(rc, cfloor);
          c = __vmaxu2(c, rfloor[ri]);
        }
        hi2[ri] = __vminu2(hi2[ri], __vmaxu2(lo2[ri], rc));
        lo2[ri] = __vminu2(lo2[ri], rc);
        cc[ri] = c;
      }
      cm2[j] = __vminu2(__vimin3_u16x2(cc[0], cc[1], cc[2]), cc[3]);
    }
    // Over the warp's 8 lanes of a column (lane bits 2-4): a reduce-scatter
    // in 7 shuffles leaves this lane the minima of columns 8 lq + 2 lr + e.
    reduce_scatter<4>(cm2, lane, 16);
    reduce_scatter<2>(cm2, lane, 8);
    reduce_scatter<1>(cm2, lane, 4);
    *reinterpret_cast<int2*>(s_col + buf * 4 * BN + warp * BN + lq * 8 + lr * 2) =
        make_int2(col_code32(cm2[0] & 0xFFFFu, row0, ns), col_code32(cm2[0] >> 16, row0, ns));
  }
  __syncthreads();
  publish_columns(a, s_col + ((t_end - 1 - t_begin) & 1) * 4 * BN, (t_end - 1) * BN, tid);

  // Per row: the even and odd columns' codes, then the four lanes of a row
  // (disjoint columns) merged; publish.
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    int lo = row_code32(lo2[ri] & 0xFFFFu, t_begin, lr, 0, cb);
    int hi = row_code32(hi2[ri] & 0xFFFFu, t_begin, lr, 0, cb);
    merge2(lo, hi, row_code32(lo2[ri] >> 16, t_begin, lr, 1, cb),
           row_code32(hi2[ri] >> 16, t_begin, lr, 1, cb));
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      const int olo = __shfl_xor_sync(0xffffffffu, lo, off);
      const int ohi = __shfl_xor_sync(0xffffffffu, hi, off);
      merge2(lo, hi, olo, ohi);
    }
    const int r = row0 + (ri >> 1) * 64 + warp * 16 + lq + (ri & 1) * 8;
    if (lr == 0 && r < n) a.row_part[(size_t)s * n + r] = make_int2(lo, hi);
  }
  __syncthreads();
  if (tid == 0) s_flag[0] = arrive(&a.counters[q]) == slices - 1;
  if (tid == 32) s_flag[1] = arrive(&a.counters[n_rt + s]) == n_rt - 1;
  __syncthreads();
  const bool last_rows = s_flag[0], last_cols = s_flag[1];
  if (!last_rows && !last_cols) return;
  // The last CTA of this row tile merges its rows; the last CTA of this
  // slice reads its columns' codes and resets them.  All loads first.
  constexpr int BATCH = 32;                 // slices a round
  constexpr int PER = MAX_TPS * BN / NT;    // columns a thread at most
  const int r = row0 + tid;
  const bool row_here = last_rows && r < n;
  const int c_end = min(t_end * BN, m);
  int2 part[BATCH];
  int code[PER];
#pragma unroll
  for (int k = 0; k < BATCH; ++k)
    part[k] = row_here && k < slices ? __ldcg(&a.row_part[(size_t)k * n + r])
                                     : make_int2(INT_MAX, INT_MAX);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = t_begin * BN + tid + k * NT;
    code[k] = last_cols && c < c_end ? __ldcg(&a.colcode[c]) : 0;
  }
  if (row_here) {
    const int init = (BIG << cb) | ((1 << cb) - 1);
    int l = init, h = init;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) merge2(l, h, part[k].x, part[k].y);
    for (int s0 = BATCH; s0 < slices; ++s0) {
      const int2 v = __ldcg(&a.row_part[(size_t)s0 * n + r]);
      merge2(l, h, v.x, v.y);
    }
    const bool valid = a.valid_a[r] != 0;
    a.best[r] = valid ? l >> cb : BIG;      // an invalid row: every pair BIG
    a.second[r] = valid ? h >> cb : BIG;
    a.idx[r] = valid ? l & ((1 << cb) - 1) : 0;
  }
  if (last_rows && tid == 0) a.counters[q] = 0;
  if (last_cols) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = t_begin * BN + tid + k * NT;
      if (c < c_end) {
        a.col_idx[c] = a.valid_b[c] != 0 ? code[k] & ((1 << ns) - 1) : 0;  // invalid: row 0
        a.colcode[c] = INT_MAX;
      }
    }
    if (tid == 0) a.counters[n_rt + s] = 0;
  }
}

template <bool GUIDED, bool MASKED>
cudaError_t set_attributes() {
  auto kernel = match_reduce_kernel<GUIDED, MASKED>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <bool GUIDED, bool MASKED>
int launch(const Args& a, int slices, int row_tiles, int batch, cudaStream_t stream) {
  const cudaError_t e = set_attributes<GUIDED, MASKED>();
  if (e != cudaSuccess) return (int)e;
  match_reduce_kernel<GUIDED, MASKED>
      <<<dim3(slices, row_tiles, batch), NT, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool GUIDED, bool MASKED>
int ctas_per_sm() {
  int ctas = 0;
  if (set_attributes<GUIDED, MASKED>() != cudaSuccess) return 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, match_reduce_kernel<GUIDED, MASKED>, NT,
                                                SMEM_BYTES);
  return ctas;
}

// A bool (rows, m) mask to (rows, words) 32-bit words, column c at bit c % 32
// of word c / 32, columns past m clear; one thread a word, reading its 32
// bytes as two 16-byte vectors where the row's bytes allow it.
__global__ void __launch_bounds__(256) pack_mask_kernel(const unsigned char* __restrict__ mask,
                                                       int rows, int m, int words,
                                                       unsigned* __restrict__ out) {
  const long i = blockIdx.x * 256L + threadIdx.x;
  if (i >= (long)rows * words) return;
  const long r = i / words;
  const int c0 = (int)(i % words) * 32;
  const unsigned char* p = mask + r * m + c0;
  unsigned w = 0;
  if (c0 + 32 <= m && (reinterpret_cast<size_t>(p) & 15) == 0) {
    const uint4 v[2] = {reinterpret_cast<const uint4*>(p)[0],
                        reinterpret_cast<const uint4*>(p)[1]};
    const unsigned* b = reinterpret_cast<const unsigned*>(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {   // bytes 0/1 -> bits 4k .. 4k + 3
      const unsigned x = b[k];
      w |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << (4 * k);
    }
  } else {
    for (int k = 0; k < 32 && c0 + k < m; ++k) w |= (p[k] != 0 ? 1u : 0u) << k;
  }
  out[i] = w;
}

}  // namespace

// CTAs of the kernel that fit on one SM at once (registers and shared
// memory), for the wrapper's grid, by mode (0 unguided, 1 guided, 2
// masked); 0 on an error.
extern "C" int tinyslam_match_ctas_per_sm(int mode) {
  return mode == 1 ? ctas_per_sm<true, false>()
                   : mode == 2 ? ctas_per_sm<false, true>() : ctas_per_sm<false, false>();
}

// The pair mask of `rows` rows (all sequences' back to back) of m bool
// bytes, packed into `words` 32-bit words a row for the masked mode.
extern "C" int tinyslam_pack_mask(const void* mask, int rows, int m, int words, void* out,
                                  cudaStream_t stream) {
  if (rows < 1 || m < 1 || words * 32L < m) return (int)cudaErrorInvalidValue;
  const long total = (long)rows * words;
  pack_mask_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const unsigned char*>(mask), rows, m, words, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

// `batch` sequences of n rows against m columns each, every array the
// sequences' slices back to back (rows of a sequence n apart, columns m
// apart; m a multiple of 16 when batch > 1, so each sequence's valid bytes
// and projections stay 16-byte aligned); the grid is `slices` column
// slices of `tps` (at most MAX_TPS) tiles of 64 by ceil(n / 128) row tiles
// by `batch`.  row_part holds batch * slices * n int2; colcode batch * m
// ints, INT_MAX before the first launch, and counters batch * (ceil(n /
// 128) + slices) ints, 0 before the first launch (each launch leaves both
// so).  `mode` 0 is unguided, 1 guided (xy_a, proj_b, r2), 2 masked (mask:
// batch * n rows of mask_words >= 2 * ceil(m / 64) words, from
// tinyslam_pack_mask).
extern "C" int tinyslam_match_reduce(const void* desc_a, const void* valid_a,
                                     const void* xy_a, const void* desc_b,
                                     const void* valid_b, const void* proj_b,
                                     const void* mask, int mask_words,
                                     int batch, int n, int m, int mode, float r2,
                                     int nshift, int cbits, int slices, int tps, int* best,
                                     int* second, int* idx, int* col_idx, void* row_part,
                                     int* colcode, int* counters, cudaStream_t stream) {
  Args a;
  a.desc_a = static_cast<const unsigned*>(desc_a);
  a.valid_a = static_cast<const unsigned char*>(valid_a);
  a.xy_a = static_cast<const float2*>(xy_a);
  a.desc_b = static_cast<const unsigned*>(desc_b);
  a.valid_b = static_cast<const unsigned char*>(valid_b);
  a.proj_b = static_cast<const float2*>(proj_b);
  a.mask = static_cast<const unsigned*>(mask);
  a.mask_words = mask_words;
  a.n = n;
  a.m = m;
  a.nshift = nshift;
  a.cbits = cbits;
  a.tps = tps;
  a.r2 = r2;
  a.best = best;
  a.second = second;
  a.idx = idx;
  a.col_idx = col_idx;
  a.row_part = static_cast<int2*>(row_part);
  a.colcode = colcode;
  a.counters = counters;
  const int row_tiles = (n + BM - 1) / BM;
  if (batch < 1 || batch > 65535 || (batch > 1 && m % 16 != 0) || mode < 0 || mode > 2 ||
      (mode == 2 && (mask == nullptr || mask_words < 2 * ((m + BN - 1) / BN))))
    return (int)cudaErrorInvalidValue;
  return mode == 1 ? launch<true, false>(a, slices, row_tiles, batch, stream)
         : mode == 2 ? launch<false, true>(a, slices, row_tiles, batch, stream)
                     : launch<false, false>(a, slices, row_tiles, batch, stream);
}
