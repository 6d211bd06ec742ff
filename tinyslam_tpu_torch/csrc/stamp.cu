// Device stamps, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel.  A captured step of the tracker runs its branch
// bodies as conditional nodes (graph.cu), and an event pair can time a
// whole replay from the host's side but nothing inside a body.  These
// one-thread kernels read the card's nanosecond timer (%globaltimer) where
// they run: in a stream, in a captured graph, in a conditional node's body.
// They add no synchronization, and every span they take is on one clock
// (tinyslam_tpu_torch/utils/spans.py reads them and maps that clock onto
// the host's):
//
//   tinyslam_stamp_mark(slot, stream)
//     *slot <- now;
//   tinyslam_stamp_add(begin, acc, stream)
//     *acc += now - *begin (a span's nanoseconds, cumulative);
//   tinyslam_stamp_step(begin, ring, cap, stream)
//     the replay counter ring[0] = n: the pair at ring[1 + 2 (n % cap)]
//     <- (*begin, now), then ring[0] <- n + 1 (each replay's span);
//   tinyslam_stamp_calibrate(stream, trials, out)
//     `trials` times: read the host's CLOCK_REALTIME, launch one stamp
//     into mapped host memory, spin until it lands, read the clock again;
//     out <- (stamp, host before, host after) of the narrowest bracket.
//     The stream must be idle.  Fails after a second without the stamp.
//
// A stamp kernel is bound by its launch; in a graph it is one node.
// Every entry point returns the first CUDA error it met, or 0.

#include <cuda_runtime.h>

#include <climits>
#include <ctime>

namespace {

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void mark(long long* slot) { *slot = global_ns(); }

__global__ void add_since(const long long* begin, long long* acc) {
  *acc += global_ns() - *begin;
}

__global__ void step_span(const long long* begin, long long* ring, int cap) {
  const long long now = global_ns();
  const long long n = ring[0];
  long long* pair = ring + 1 + 2 * (n % cap);
  pair[0] = *begin;
  pair[1] = now;
  ring[0] = n + 1;
}

__global__ void mark_host(long long* slot) {
  *reinterpret_cast<volatile long long*>(slot) = global_ns();
  __threadfence_system();
}

long long host_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // namespace

extern "C" int tinyslam_stamp_mark(void* slot, cudaStream_t stream) {
  mark<<<1, 1, 0, stream>>>(static_cast<long long*>(slot));
  return (int)cudaGetLastError();
}

extern "C" int tinyslam_stamp_add(const void* begin, void* acc, cudaStream_t stream) {
  add_since<<<1, 1, 0, stream>>>(static_cast<const long long*>(begin),
                                 static_cast<long long*>(acc));
  return (int)cudaGetLastError();
}

extern "C" int tinyslam_stamp_step(const void* begin, void* ring, int cap,
                                   cudaStream_t stream) {
  step_span<<<1, 1, 0, stream>>>(static_cast<const long long*>(begin),
                                 static_cast<long long*>(ring), cap);
  return (int)cudaGetLastError();
}

extern "C" int tinyslam_stamp_calibrate(cudaStream_t stream, int trials, long long* out) {
  // One mapped host word for the process, kept.
  static long long* host = nullptr;
  static long long* dev = nullptr;
  cudaError_t e;
  if (host == nullptr) {
    e = cudaHostAlloc(reinterpret_cast<void**>(&host), sizeof(long long),
                      cudaHostAllocMapped);
    if (e != cudaSuccess) return (int)e;
    e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev), host, 0);
    if (e != cudaSuccess) return (int)e;
  }
  volatile long long* word = host;
  long long best = LLONG_MAX;
  for (int i = 0; i < trials; ++i) {
    *word = 0;
    const long long before = host_ns();
    mark_host<<<1, 1, 0, stream>>>(dev);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    long long stamp;
    while ((stamp = *word) == 0) {
      if (host_ns() - before > 1000000000LL) return (int)cudaErrorLaunchTimeout;
    }
    const long long after = host_ns();
    if (after - before < best) {
      best = after - before;
      out[0] = stamp;
      out[1] = before;
      out[2] = after;
    }
  }
  return (int)cudaStreamSynchronize(stream);
}
