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
// What bounds it on the card: neither bytes (4.2 MB of rows at the exact
// planner's shape, about 1.3 us) nor operations, but the walks' chains of
// dependent steps (a step's target needs the step before it) and the
// instructions that each step issues: 16,384 walks of about 32 steps.
//
// Design.  The TPU kernel recounted a masked comparison over the whole row
// at every step.  Here a block of one warp stages one row in shared memory
// with every 4-byte copy in flight at once (cp.async; rows of 4 (N+1) bytes
// are not 16-byte aligned), and a group of 4 lanes walks one candidate, 8
// candidates at a time.  A step tests the 32 entries after pos (those up
// to n), lane i of the group the entries pos+1+i+4e for e < 8, and adds up
// the group's hits with xor shuffles.  The row is non-decreasing, so the
// hits are a prefix of the window and their count c is upper_bound - 1 -
// pos, clipped at n: nxt = pos + c.  c = 0 means stuck; a full window (an
// interval past 32 entries) goes on with a 32-ary search over
// (pos + 32, n].  The steps of a warp's candidates run in lockstep, so the
// step count, and the stop when no candidate of the warp can move any more
// (every one at n, stuck, or done with `cap` steps), are the same for every
// lane.  Fewer lanes per candidate issue fewer instructions per step: on
// the H100, 4 lanes a walk were faster at the exact planner's shape than
// 8, 16 or 32, and several rows or several warps a block no faster than
// one of each (PERF.md).
//
// Rows that shared memory cannot hold (more than 232,448 bytes: long 1D
// prefixes, very wide Gammas) take the general route, probe_general: the
// same walk reading the row from global memory (through L1 and L2)
// instead of staging it.  The wrapper (ops.py) chooses the route by row
// length.

// int32: the target p[pos] + L is computed in uint32 and wraps as the plain
// version's int32 add does; callers keep totals below 2**30 so it cannot.

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;        // entries a step tests at once
constexpr int kLanes = 4;          // lanes that walk one candidate
constexpr int kWalks = 32 / kLanes;  // candidates a warp walks (ops)
constexpr int kHits = kWindow / kLanes;  // window entries a lane tests
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// The group's sum of c (xor shuffles within aligned groups of kLanes).
__device__ __forceinline__ int group_sum(int c) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1)
    c += __shfl_xor_sync(kFull, c, off);
  return c;
}

// Entries <= t among row[pos + 1 .. min(pos + 32, n)].
template <typename T>
__device__ __forceinline__ int count_window(const T* row, int pos, int n, T t,
                                            bool on, int gl) {
  const int i0 = pos + 1 + gl;
  int hit[kHits];
#pragma unroll
  for (int e = 0; e < kHits; ++e)
    hit[e] = on && i0 + kLanes * e <= n && row[i0 + kLanes * e] <= t;
#pragma unroll
  for (int d = 1; d < kHits; d *= 2)
#pragma unroll
    for (int e = 0; e + d < kHits; e += 2 * d) hit[e] += hit[e + d];
  return group_sum(hit[0]);
}

// Entries <= t among row[lo + j * stride], j = 1..32, below top: one round
// of the 32-ary search.
template <typename T>
__device__ __forceinline__ int count_strided(const T* row, int lo, int stride,
                                             int top, T t, bool on, int gl) {
  int c = 0;
#pragma unroll
  for (int e = 0; e < kHits; ++e) {
    const int i = lo + (gl + 1 + kLanes * e) * stride;
    c += on && i < top && row[i] <= t;
  }
  return group_sum(c);
}

// One block of one warp per row; the grid is the rows.  kStaged: the row
// is staged in shared memory (probe); otherwise it is read where it lies
// (probe_general).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(32)
probe_kernel(const T* __restrict__ p, const T* __restrict__ Ls,
             int* __restrict__ out, int n_plus_1, int K, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long s = blockIdx.x;
  const T* src = p + s * n_plus_1;
  const T* row;
  if constexpr (kStaged) {
    T* staged = reinterpret_cast<T*>(smem_raw);
    for (int i = threadIdx.x; i < n_plus_1; i += 32)
      cp_async4(staged + i, src + i);
    row = staged;
  } else {
    row = src;
  }

  const int lane = threadIdx.x;
  const int g = lane / kLanes, gl = lane % kLanes;
  const int n = n_plus_1 - 1;
  // the first candidates' bottlenecks travel while the row arrives
  T L = g < K ? Ls[s * K + g] : T(0);
  if constexpr (kStaged) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  for (int k0 = 0; k0 < K; k0 += kWalks) {  // warp-uniform
    const int k = k0 + g;
    if (k0 != 0) L = k < K ? Ls[s * K + k] : T(0);
    int pos = 0, cnt = 0;
    bool on = k < K && n > 0;  // this group's walk can still move
    T t = on ? add_wrap(row[0], L) : T(0);
    for (int step = 0; step < cap && __any_sync(kFull, on); ++step) {
      int c = count_window<T>(row, pos, n, t, on, gl);
      bool far = on && c == kWindow;  // the interval outruns the window
      if (__any_sync(kFull, far)) {
        int lo = pos + kWindow, top = n_plus_1;
        far = far && top - lo > 1;
        while (__any_sync(kFull, far)) {
          const int d = (top - lo - 1 + kWindow - 1) / kWindow;
          const int c2 = count_strided<T>(row, lo, d, top, t, far, gl);
          if (far) {
            if (c2 < kWindow) top = min(top, lo + (c2 + 1) * d);
            lo += c2 * d;
            far = top - lo > 1;
          }
        }
        if (on && c == kWindow) c = lo - pos;
      }
      if (on) {
        if (c == 0) {
          on = false;  // stuck: no later step moves
        } else {
          pos += c;
          ++cnt;
          on = pos < n;
          if (on) t = add_wrap(row[pos], L);
        }
      }
    }
    if (k < K && gl == 0)
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
        probe_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_kernel<T, true><<<(unsigned)S, 32, smem, st>>>(p, Ls, out, n_plus_1,
                                                        K, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int probe_general_launch(const T* p, const T* Ls, int* out, int S,
                         int n_plus_1, int K, int cap, cudaStream_t st) {
  if (S == 0 || K == 0) return (int)cudaGetLastError();
  probe_kernel<T, false><<<(unsigned)S, 32, 0, st>>>(p, Ls, out, n_plus_1,
                                                      K, cap);
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

extern "C" int repro_probe_general_f32(const void* p, const void* Ls,
                                       void* out, int S, int n_plus_1, int K,
                                       int cap, void* stream) {
  return probe_general_launch<float>(static_cast<const float*>(p),
                                     static_cast<const float*>(Ls),
                                     static_cast<int*>(out), S, n_plus_1, K,
                                     cap, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_probe_general_i32(const void* p, const void* Ls,
                                       void* out, int S, int n_plus_1, int K,
                                       int cap, void* stream) {
  return probe_general_launch<int>(static_cast<const int*>(p),
                                   static_cast<const int*>(Ls),
                                   static_cast<int*>(out), S, n_plus_1, K, cap,
                                   static_cast<cudaStream_t>(stream));
}
