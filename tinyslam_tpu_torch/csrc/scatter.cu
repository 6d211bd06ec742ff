// Order-fixed scatter-add, CUDA C++ for Hopper (sm_90a).
//
// The pose graph assembles its Gauss-Newton normal equations H and g by
// adding each edge's D x D blocks and D-rows into the slots they hit
// (tinyslam_tpu_torch/backend/pose_graph.py:normal_equations; it replaces
// the XLA scatter of tinyslam_tpu/backend/pose_graph.py:116-123).  A float
// index_add_ on CUDA does that with atomicAdd, whose order, and so whose
// rounding, changes from run to run.  Here every slot sums its
// contributions in the order they are listed:
//
//   out[s] = (((0 + v[perm[ptr[s]]]) + v[perm[ptr[s] + 1]]) + ...)
//
// where perm is a stable sort of the contributions' slots and ptr[s] ..
// ptr[s + 1] the segment of slot s in it.  That is the serial order of
// index_add_ on the CPU (and of numpy's add.at), so the card's H and g
// equal the CPU's bit for bit, a slot that nothing hits is +0.0, -0.0
// terms are added, and NaN and inf propagate.  The sort and the segments
// are built once a solve (the slots do not change across its iterations);
// each iteration is then one launch.
//
// What bounded the first version (one thread a slot, walking its segment
// with two dependent global loads a term, v[perm[k]]): the gauge node's
// chain.  A solve pads its edges to a multiple of 128 with i = j = 0, so
// each padded edge adds four terms to every slot of H's (0, 0) block and
// two to node 0's rows of g.  On the orbit's graph (32 nodes x 7, a few
// tens of valid edges in 128) those 49 slots hold ~4 x 100 terms each, and
// their threads spent ~15 us in load latency while the other ~50,000
// slots finished at once.  The order of each slot's adds cannot change
// (float addition does not reassociate), so only the loads can move.
//
// This version: a block owns a span of NT = 128 consecutive slots, one
// thread a slot (R slots a thread, NT apart, once one wave of blocks no
// longer covers the output: R = 4 at 200 nodes).  The terms of consecutive
// slots are consecutive in perm, so a span's terms are one run
// perm[ptr[s0] .. ptr[s0 + span]).
//   1. The run's ends load (with every slot's offsets at R = 1, in one
//      latency); a span that nothing hits (most of H at 200 nodes) writes
//      zeros and ends.
//   2. The run's positions perm[k] are copied into shared memory with
//      asynchronous copies (cp.async, coalesced), and the segments longer
//      than LONG = 32 terms are listed.
//   3. Each term v[perm[k]] is copied over its position, every copy in
//      flight at once: a short segment's by its own thread, the long ones'
//      by the whole block, term k of every long segment side by side.  The
//      D slots of a row of a D x D block are hit by the same edges in the
//      same order and an edge's terms for them lie 4 bytes apart in v, so
//      a warp's copies of the gauge node's row touch ~5 sectors, not 32.
//      A thread reads a batch of 16 positions before it issues their
//      copies (a shared load issued after a thread's copies waits for
//      them).
//   4. Each thread adds its segment from shared memory, in order, 32 terms
//      loaded into registers at a time.
// The gauge node's rows sit m slots apart, in different spans, so their
// chains run on different SMs, side by side.  A run longer than the stage
// (a segment of thousands of terms) is done in chunks, gathered in run
// order, the sums so far kept in out.
//
// Why not a warp per 32 slots, its long segments found by a ballot and
// summed by the whole warp one after another (loads spread over the
// lanes, adds in lane order through shuffles): the gauge node's 7 slots of
// a row fall in one warp, so that warp would add 7 x ~400 terms in one
// chain; here the 7 chains run side by side after one gather.
//
// What bounds it on the H100: neither bytes nor operations.  The bytes
// bound (terms and their positions read once, the offsets of the slots
// that hold a term, H and g written once) is 0.13 us at the orbit's size
// (32 nodes x 7, 128 edges), 0.31 us at 64 nodes x 7 and 128 edges, 3.1
// us at 200 nodes (224 x 7, 256 edges; 2.5 M slots of H), and the adds
// are a few thousand.  At the solve's sizes the gauge node's span bounds
// the launch: three dependent global latencies (offsets, positions,
// terms), ~3,300 scattered 4-byte copies on one SM, and a chain of ~470
// dependent adds (~9 cycles each from shared memory), ~4.7 us in all
// (tools/scatter_phases.py splits it).  At 200 nodes it is the launch's
// ~4,800 blocks, two thirds of them empty, in ~5 waves.
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;                  // threads of a block
constexpr int R_MAX = 4;                 // slots a thread, at most (NT apart)
constexpr int STAGE_BYTES = 24576;       // shared memory a block stages terms in
constexpr int LONG = 32;                 // a longer segment is gathered by the block
constexpr int RESIDENT = 7;              // blocks an SM holds (the stage's 24 KB)
constexpr int BATCH = 16;                // positions read before their copies are issued

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// For q = q0 + i * step, i < count: copy the term at the position that
// stage[q] holds (in its first word) over it.  BATCH positions are read,
// then their BATCH copies issued, all in flight at once.
template <typename T>
__device__ __forceinline__ void gather(T* stage, const T* __restrict__ vals, int q0, int step,
                                      int count) {
  for (int i = 0; i < count; i += BATCH) {
    int p[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i + u < count) p[u] = *reinterpret_cast<const int*>(&stage[q0 + (i + u) * step]);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (i + u < count) copy_async<sizeof(T)>(&stage[q0 + (i + u) * step], vals + p[u]);
  }
}

// acc + st[0] + st[1] + ... + st[count - 1], one add at a time in that
// order, from batches of terms loaded into registers first.
template <typename T>
__device__ __forceinline__ T add_in_order(T acc, const T* st, int count) {
  int k = 0;
  for (; count - k >= 32; k += 32) {
    T x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = st[k + i];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc += x[i];
  }
  for (; count - k >= 8; k += 8) {
    T x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = st[k + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += x[i];
  }
  for (; k < count; ++k) acc += st[k];
  return acc;
}

// A block owns the span of R * NT slots from s0, thread tid the slots
// s0 + r * NT + tid, r < R.
template <typename T>
__global__ void __launch_bounds__(NT) ordered_scatter_kernel(const T* __restrict__ vals,
                                                             const int* __restrict__ perm,
                                                             const int* __restrict__ ptr,
                                                             T* __restrict__ out, int size,
                                                             int R) {
  constexpr int CAP = STAGE_BYTES / sizeof(T);
  __shared__ __align__(16) T stage[CAP];
  __shared__ int seg[R_MAX * NT + 1];    // ptr over the span, less the run's start
  __shared__ int long_at[NT], long_len[NT];
  __shared__ int n_long;
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * NT * R;
  const int span = (int)min((long long)NT * R, size - s0);
  int offs[R_MAX];
  if (R == 1 && tid < span) offs[0] = ptr[s0 + tid];   // loads with the run's ends
  const int run_b = ptr[s0], run_e = ptr[s0 + span];
  if (run_b == run_e) {                  // no slot of the span is hit
    for (int i = tid; i < span; i += NT) out[s0 + i] = T(0);
    return;
  }
#pragma unroll
  for (int r = 0; r < R_MAX; ++r)
    if (r < R && r * NT + tid < span && R > 1) offs[r] = ptr[s0 + r * NT + tid];
#pragma unroll
  for (int r = 0; r < R_MAX; ++r)
    if (r < R && r * NT + tid < span) seg[r * NT + tid] = offs[r] - run_b;
  if (tid == 0) seg[span] = run_e - run_b, n_long = 0;
  const int* run = perm + run_b;
  const int n = run_e - run_b;
  if (n <= CAP) {
    // The run's positions into the stage, one a slot's first word.
    for (int q = tid; q < n; q += NT) copy_async<4>(&stage[q], run + q);
    __syncthreads();                     // seg and n_long in place
    for (int i = tid; i < span; i += NT) {
      const int len = seg[i + 1] - seg[i];
      if (len > LONG) {
        const int j = atomicAdd(&n_long, 1);
        if (j < NT) long_at[j] = seg[i], long_len[j] = len;
      }
    }
    copy_async_wait_all();
    __syncthreads();                     // the positions and the long segments in place
    if (n_long <= NT) {
      // Each term over its position: a short segment's by its own thread;
      // the long segments' by the whole block, term k of every long segment
      // side by side (thread tid takes segment tid % nl from term tid / nl
      // on, every step-th term), so that a warp copies neighbouring terms of
      // v (the long segments of a row of a block share their edges).
      for (int i = tid; i < span; i += NT) {
        const int len = seg[i + 1] - seg[i];
        if (len <= LONG) gather(stage, vals, seg[i], 1, len);
      }
      const int nl = n_long;
      if (nl > 0 && tid < nl * (NT / nl)) {
        const int step = NT / nl, j = tid % nl, k0 = tid / nl, len = long_len[j];
        if (len > k0) gather(stage, vals, long_at[j] + k0, step, (len - k0 + step - 1) / step);
      }
      copy_async_wait_all();
      __syncthreads();
      for (int i = tid; i < span; i += NT)
        out[s0 + i] = add_in_order(T(0), stage + seg[i], seg[i + 1] - seg[i]);
      return;
    }
  } else {
    __syncthreads();                     // seg in place
  }
  for (int c0 = 0; c0 < n; c0 += CAP) {
    // A chunk of the run, in run order; each thread copies the positions
    // it then gathers over, so it waits for its own copies only.  The
    // sums so far wait in out.
    const int m = min(CAP, n - c0);
    for (int q = tid; q < m; q += NT) copy_async<4>(&stage[q], run + c0 + q);
    copy_async_wait_all();
    gather(stage, vals, tid, NT, (m - tid + NT - 1) / NT);
    copy_async_wait_all();
    __syncthreads();
    for (int i = tid; i < span; i += NT) {
      const int b = max(seg[i], c0), e = min(seg[i + 1], c0 + m);
      out[s0 + i] = add_in_order(c0 ? out[s0 + i] : T(0), stage + b - c0, e - b);
    }
    __syncthreads();                     // the stage is refilled next chunk
  }
}

template <typename T>
int launch(const void* vals, const void* perm, const void* ptr, void* out, int size,
           cudaStream_t stream) {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const long long resident = (dev < 64 && sms[dev] > 0 ? sms[dev] : 132) * RESIDENT;
  // One wave of blocks, a slot a thread, as long as that covers the output;
  // then more slots a thread, up to R_MAX, then more waves.
  const long long tiles = (size + NT - 1) / NT;
  const int R = (int)min((long long)R_MAX, max(1LL, (tiles + resident - 1) / resident));
  const long long span = (long long)NT * R;
  ordered_scatter_kernel<T><<<(unsigned)((size + span - 1) / span), NT, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int*>(perm), static_cast<const int*>(ptr),
      static_cast<T*>(out), size, R);
  return (int)cudaGetLastError();
}

}  // namespace

// out (size,) = the segment sums of vals over perm, segment s at
// perm[ptr[s] .. ptr[s + 1]); vals and out float32, or float64 if `dbl`.
extern "C" int tinyslam_ordered_scatter(const void* vals, const void* perm, const void* ptr,
                                        void* out, int size, int dbl, cudaStream_t stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  return dbl ? launch<double>(vals, perm, ptr, out, size, stream)
             : launch<float>(vals, perm, ptr, out, size, stream);
}
