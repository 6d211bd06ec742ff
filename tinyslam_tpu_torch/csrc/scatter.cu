// Order-fixed scatter-add, CUDA C++ for Hopper (sm_90a).
//
// The pose graph assembles its Gauss-Newton normal equations H and g by
// adding each edge's D x D blocks and D-rows into the slots they hit
// (tinyslam_tpu_torch/backend/pose_graph.py:normal_equations).  A float
// index_add_ on CUDA does that with atomicAdd, whose order, and so whose
// rounding, changes from run to run.  Here every slot is one thread that
// sums its contributions in the order they are listed:
//
//   out[s] = (((0 + v[perm[ptr[s]]]) + v[perm[ptr[s] + 1]]) + ...)
//
// where perm is a stable sort of the contributions' slots and ptr[s] ..
// ptr[s + 1] the segment of slot s in it.  That is the serial order of
// index_add_ on the CPU (and of numpy's add.at), so the card's H and g
// equal the CPU's bit for bit, and a slot that nothing hits is 0.  The sort
// and the segments are built once a solve (the slots do not change across
// its iterations); each iteration is then one launch.
//
// What bounds it on the H100: bytes.  Every slot is written once and every
// contribution read once (with its index); at the orbit's Sim(3) graph
// (96 padded nodes, 7 x 7 blocks) that is 1.8 MB of H, a few microseconds.
//
// Entry point (plain C, loaded with ctypes): returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) ordered_scatter_kernel(const T* __restrict__ vals,
                                                             const int* __restrict__ perm,
                                                             const int* __restrict__ ptr,
                                                             T* __restrict__ out, int size) {
  const int s = blockIdx.x * NT + threadIdx.x;
  if (s >= size) return;
  const int b = ptr[s], e = ptr[s + 1];
  T acc = T(0);
  for (int k = b; k < e; ++k) acc += vals[perm[k]];
  out[s] = acc;
}

}  // namespace

// out (size,) = the segment sums of vals over perm, segment s at
// perm[ptr[s] .. ptr[s + 1]); vals and out float32, or float64 if `dbl`.
extern "C" int tinyslam_ordered_scatter(const void* vals, const void* perm, const void* ptr,
                                        void* out, int size, int dbl, cudaStream_t stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((size + NT - 1) / NT);
  if (dbl)
    ordered_scatter_kernel<double><<<grid, NT, 0, stream>>>(
        static_cast<const double*>(vals), static_cast<const int*>(perm),
        static_cast<const int*>(ptr), static_cast<double*>(out), size);
  else
    ordered_scatter_kernel<float><<<grid, NT, 0, stream>>>(
        static_cast<const float*>(vals), static_cast<const int*>(perm),
        static_cast<const int*>(ptr), static_cast<float*>(out), size);
  return (int)cudaGetLastError();
}
