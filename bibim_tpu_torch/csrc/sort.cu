// K3 — ascending sort of packed (tile, triangle) pair keys, int32 or int64.
//
// Replaces bibim_tpu/ops/sort_pallas.py:_bitonic_kernel (via
// sort_keys_vmem / sort_pairs). The TPU kernel keeps the whole network in
// VMEM and is capped at 2^17 keys; this one sorts any power-of-two padded
// length with a bitonic network in three kernels:
//   local_sort   — each block sorts SORT_BLOCK keys in shared memory
//                  (all stages k <= SORT_BLOCK, directions from the global
//                  index so the blocks form bitonic runs);
//   global_step  — one compare-exchange stage of stride j >= SORT_BLOCK;
//   local_merge  — all stages j < SORT_BLOCK of one k, in shared memory.
//
// What bounds it on an H100: at binning sizes (10^4-10^5 keys) launch
// latency and the log^2 n global stages; the shared-memory stages keep all
// strides below 2048 out of device memory. The pair keys are unique (equal
// keys are identical dead entries), so any correct sort gives the order the
// reference's sort gives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace bb {

constexpr int SORT_THREADS = 1024;
constexpr int SORT_BLOCK = 2 * SORT_THREADS;  // keys per shared-memory block

template <typename T>
__device__ __forceinline__ void exchange(T* s, unsigned i, unsigned p,
                                         bool asc) {
  const T a = s[i], b = s[p];
  if ((a > b) == asc) {
    s[i] = b;
    s[p] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(SORT_THREADS) local_sort(T* d) {
  __shared__ T s[SORT_BLOCK];
  const size_t base = (size_t)blockIdx.x * SORT_BLOCK;
  s[threadIdx.x] = d[base + threadIdx.x];
  s[threadIdx.x + SORT_THREADS] = d[base + threadIdx.x + SORT_THREADS];
  __syncthreads();
  for (unsigned k = 2; k <= SORT_BLOCK; k <<= 1) {
    for (unsigned j = k >> 1; j > 0; j >>= 1) {
      const unsigned t = threadIdx.x;
      const unsigned i = 2 * j * (t / j) + (t % j);
      exchange(s, i, i + j, ((base + i) & k) == 0);
      __syncthreads();
    }
  }
  d[base + threadIdx.x] = s[threadIdx.x];
  d[base + threadIdx.x + SORT_THREADS] = s[threadIdx.x + SORT_THREADS];
}

template <typename T>
__global__ void global_step(T* d, size_t n, size_t j, size_t k) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const size_t i = 2 * j * (t / j) + (t % j);
  const size_t p = i + j;
  const bool asc = (i & k) == 0;
  const T a = d[i], b = d[p];
  if ((a > b) == asc) {
    d[i] = b;
    d[p] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(SORT_THREADS) local_merge(T* d, size_t k) {
  __shared__ T s[SORT_BLOCK];
  const size_t base = (size_t)blockIdx.x * SORT_BLOCK;
  s[threadIdx.x] = d[base + threadIdx.x];
  s[threadIdx.x + SORT_THREADS] = d[base + threadIdx.x + SORT_THREADS];
  __syncthreads();
  for (unsigned j = SORT_BLOCK >> 1; j > 0; j >>= 1) {
    const unsigned t = threadIdx.x;
    const unsigned i = 2 * j * (t / j) + (t % j);
    exchange(s, i, i + j, ((base + i) & k) == 0);
    __syncthreads();
  }
  d[base + threadIdx.x] = s[threadIdx.x];
  d[base + threadIdx.x + SORT_THREADS] = s[threadIdx.x + SORT_THREADS];
}

// n: a power of two >= SORT_BLOCK (the wrapper pads with the type's max).
template <typename T>
int sort_keys(T* d, int n, cudaStream_t st) {
  if (n < SORT_BLOCK || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int blocks = n / SORT_BLOCK;
  local_sort<T><<<blocks, SORT_THREADS, 0, st>>>(d);
  for (size_t k = 2 * (size_t)SORT_BLOCK; k <= (size_t)n; k <<= 1) {
    for (size_t j = k >> 1; j >= (size_t)SORT_BLOCK; j >>= 1) {
      const size_t pairs = (size_t)n / 2;
      global_step<T><<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
          d, (size_t)n, j, k);
    }
    local_merge<T><<<blocks, SORT_THREADS, 0, st>>>(d, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace bb

extern "C" int bb_sort_i32(void* d, int n, void* stream) {
  return bb::sort_keys<int32_t>((int32_t*)d, n, (cudaStream_t)stream);
}

extern "C" int bb_sort_i64(void* d, int n, void* stream) {
  return bb::sort_keys<long long>((long long*)d, n, (cudaStream_t)stream);
}
