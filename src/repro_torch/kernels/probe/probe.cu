// K2: batched greedy feasibility probe (interval counts per candidate).
//
// Replaces the Pallas kernel src/repro/kernels/probe/probe.py::
// probe_counts_pallas (_probe_kernel).  For prefix row s and candidate
// bottleneck L = Ls[s, k] it counts the greedy maximal intervals of load
// <= L over exactly `cap` steps, with the semantics of
// src/repro/kernels/probe/ref.py, bit for bit:
//   nxt = clip(upper_bound(p, p[pos] + L) - 1, pos, n)
//   adv = (pos < n) & (nxt > pos)
//   result = cap + 1 if pos < n after cap steps, else max(count, 1)
// (upper_bound is searchsorted(side="right") on the non-decreasing row.)
//
// What bounds it on the card: neither bytes nor operations at the
// planner's shapes (a 513-entry row, 8 candidates) but latency: each step
// is a binary search whose probes depend on each other.
//
// Design.  The TPU has no vector binary search, so its kernel recounted a
// masked comparison over the whole row at every step (O(N) per step).
// Here one block stages row s in shared memory (513 entries are about
// 2 KB) and one thread per candidate runs its own binary searches there,
// O(log N) per step.  A lane stops early once nothing can change any more
// (it reached n, or it is stuck on an element larger than L); the result
// is the one the full `cap` steps give.  The int32 form computes p[pos]+L
// in int32: callers keep the total load below 2**30 so it cannot wrap.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void probe_kernel(const T* __restrict__ p, const T* __restrict__ Ls,
                             int* __restrict__ out, int n_plus_1, int K,
                             int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  const long long s = blockIdx.x;
  const T* prow = p + s * n_plus_1;
  for (int i = threadIdx.x; i < n_plus_1; i += blockDim.x) row[i] = prow[i];
  __syncthreads();
  const int n = n_plus_1 - 1;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const T L = Ls[s * K + k];
    int pos = 0, cnt = 0;
    for (int step = 0; step < cap && pos < n; ++step) {
      const T target = row[pos] + L;
      int lo = 0, hi = n_plus_1;  // first index with row[idx] > target
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] <= target) lo = mid + 1; else hi = mid;
      }
      int nxt = lo - 1;
      nxt = nxt < pos ? pos : (nxt > n ? n : nxt);
      if (nxt <= pos) break;  // stuck: every later step is the same
      pos = nxt;
      ++cnt;
    }
    out[s * K + k] = pos < n ? cap + 1 : (cnt > 1 ? cnt : 1);
  }
}

template <typename T>
int probe_launch(const T* p, const T* Ls, int* out, int S, int n_plus_1,
                 int K, int cap, cudaStream_t st) {
  if (S == 0 || K == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_plus_1 * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        probe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((K + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  probe_kernel<T><<<S, threads, smem, st>>>(p, Ls, out, n_plus_1, K, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_probe_counts_f32(const void* p, const void* Ls, void* out,
                                      int S, int n_plus_1, int K, int cap,
                                      void* stream) {
  return probe_launch<float>(static_cast<const float*>(p),
                             static_cast<const float*>(Ls),
                             static_cast<int*>(out), S, n_plus_1, K, cap,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_probe_counts_i32(const void* p, const void* Ls, void* out,
                                      int S, int n_plus_1, int K, int cap,
                                      void* stream) {
  return probe_launch<int>(static_cast<const int*>(p),
                           static_cast<const int*>(Ls), static_cast<int*>(out),
                           S, n_plus_1, K, cap,
                           static_cast<cudaStream_t>(stream));
}
