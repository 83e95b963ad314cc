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
// prefixes, very wide Gammas) take the general route, probe_general, which
// reads the row where it lies (through L1 and L2).  The wrapper (ops.py)
// chooses the route by row length.  Its shapes differ from the staged
// route's: few rows, often one (the exact 1D solver's (1, 1,048,577) x 15
// candidates, cap 1024), with intervals of about a thousand entries.  There
// the staged route's design ran one warp on the whole card, walking 8
// candidates at a time in lockstep, and a step missed its 32 entries and
// searched all of (pos + 32, n] in strided rounds, then read row[pos]: six
// dependent reads of L2 a step.  Its pace is that chain, not bytes or
// operations.  So the general route:
// - gives each walk (s, k) a warp of its own: the grid covers the S x K
//   walks, and the longest walk, not the candidates' sum, sets the time;
// - predicts where a step ends: consecutive greedy intervals are about as
//   long, so a step reads one window of 128 entries (4 coalesced reads a
//   lane, all in flight at once) centred on pos + the last interval's
//   length.  The hits (entries <= t) are a prefix of the window, so a
//   ballot's count gives upper_bound when the end falls inside it, and the
//   next target p[nxt] + L comes from the same window by a shuffle: one
//   dependent read a step.  The first step, with no history, reads the 128
//   entries after pos;
// - on a miss, gallops outward from the window's edge, lane i reading 128
//   2^i entries past it (or before it, down to pos), which brackets the
//   end in one round, then searches the bracket 128 entries a round.
// The walk stops when it is stuck (no entry after pos is <= t), at n, or
// after cap steps, as the staged route's does.  On the H100 at the 1D
// solver's shape this takes 0.36 ms against the staged design's 5.2,
// about 0.36 us a step of the longest walk: one round trip to L2 and the
// count.  Four warps a block, 8 entries a lane and L2-only loads were no
// faster; reading the next step's window during this one gained 6% there
// and costs a round a step where intervals vary (PERF.md), so it is not
// done.

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

// The staged route: one block of one warp per row; the grid is the rows.
template <typename T>
__global__ void __launch_bounds__(32)
probe_kernel(const T* __restrict__ p, const T* __restrict__ Ls,
             int* __restrict__ out, int n_plus_1, int K, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long s = blockIdx.x;
  const T* src = p + s * n_plus_1;
  T* row = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < n_plus_1; i += 32)
    cp_async4(row + i, src + i);

  const int lane = threadIdx.x;
  const int g = lane / kLanes, gl = lane % kLanes;
  const int n = n_plus_1 - 1;
  // the first candidates' bottlenecks travel while the row arrives
  T L = g < K ? Ls[s * K + g] : T(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

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
        probe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_kernel<T><<<(unsigned)S, 32, smem, st>>>(p, Ls, out, n_plus_1, K,
                                                  cap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general route (probe_general): one warp a walk, a predicted window a
// step.

constexpr int kGenPerLane = 4;  // entries a lane reads a round
constexpr int kGenWindow = 32 * kGenPerLane;  // slots of a round
constexpr int kGenWarps = 1;  // walks (warps) a block

// The reads of one round of a walk's warp: slot q = 32 e + lane (e <
// kGenPerLane) reads row[b + q d] where that index is below top, every
// read in flight at once (for d = 1, kGenPerLane coalesced rows of 32).
template <typename T>
__device__ __forceinline__ void read_slots(const T* __restrict__ row,
                                           long long b, long long d,
                                           long long top, int lane,
                                           T (&x)[kGenPerLane]) {
#pragma unroll
  for (int e = 0; e < kGenPerLane; ++e) {
    const long long i = b + (long long)(32 * e + lane) * d;
    x[e] = i < top ? row[i] : T(0);
  }
}

// How many slots of a round hold an entry <= t.  The row is
// non-decreasing, so they are the first ones; v receives the last of them
// (when there is one).
template <typename T>
__device__ __forceinline__ int count_slots(const T (&x)[kGenPerLane],
                                           long long b, long long d,
                                           long long top, T t, int lane,
                                           T& v) {
  int c = 0;
#pragma unroll
  for (int e = 0; e < kGenPerLane; ++e)
    c += __popc(__ballot_sync(
        kFull, b + (long long)(32 * e + lane) * d < top && x[e] <= t));
  if (c > 0) {  // warp-uniform
    const int q = c - 1;
    T last = x[0];
#pragma unroll
    for (int e = 1; e < kGenPerLane; ++e)
      if (q >> 5 == e) last = x[e];
    v = __shfl_sync(kFull, last, q & 31);
  }
  return c;
}

// The walk's next position from pos: the last index in (pos, n] whose
// entry is <= t, or pos if there is none (stuck); v receives its entry.
// x holds the window of the 128 entries from base (pos < base <= n).
// Every value here is warp-uniform.
template <typename T>
__device__ __forceinline__ int next_pos(const T* __restrict__ row, int pos,
                                        int n, T t, long long base,
                                        const T (&x)[kGenPerLane], int lane,
                                        T& v) {
  const int c = count_slots(x, base, 1, (long long)n + 1, t, lane, v);
  long long lo, top;  // the end lies in [lo, top): row[top] > t or top > n
  if (c == 0) {
    if (base == pos + 1) return pos;  // stuck
    // the interval ends before the window: gallop back from its start,
    // lane i reading base - 128 * 2^i, down to pos
    lo = pos;
    top = base;
    const long long j = base - ((long long)kGenWindow << lane);
    const bool in = j > pos;
    const T y = in ? row[j] : T(0);
    const unsigned inside = __ballot_sync(kFull, in);
    const int m = __popc(__ballot_sync(kFull, in && !(y <= t)));
    const T z = __shfl_sync(kFull, y, m & 31);
    if (m > 0) top = base - ((long long)kGenWindow << (m - 1));
    if (m < 32 && (inside >> m & 1u)) {
      lo = base - ((long long)kGenWindow << m);
      v = z;
    }
  } else if (c == kGenWindow && base + kGenWindow - 1 < n) {
    // the interval ends past the window: gallop on from its end, lane i
    // reading end + 128 * 2^i, up to n
    const long long end = base + kGenWindow - 1;
    lo = end;
    top = (long long)n + 1;
    const long long j = end + ((long long)kGenWindow << lane);
    const bool in = j < top;
    const T y = in ? row[j] : T(0);
    const int h = __popc(__ballot_sync(kFull, in && y <= t));
    const T z = __shfl_sync(kFull, y, (h + 31) & 31);
    if (h < 32) top = min(top, end + ((long long)kGenWindow << h));
    if (h > 0) {
      lo = end + ((long long)kGenWindow << (h - 1));
      v = z;
    }
  } else {
    return (int)(base + c - 1);  // the window holds the end
  }
  // kGenWindow-ary search of the bracket: each round reads kGenWindow
  // entries strided across (lo, top); the last round reads them in a row
  while (top - lo > 1) {
    const long long d = (top - lo - 2) / kGenWindow + 1;
    T y[kGenPerLane], z;
    read_slots(row, lo + d, d, top, lane, y);
    const int c2 = count_slots(y, lo + d, d, top, t, lane, z);
    if (c2 < kGenWindow) top = min(top, lo + (c2 + 1) * d);
    if (c2 > 0) {
      lo += c2 * d;
      v = z;
    }
  }
  return (int)lo;
}

// One warp a walk (s, k) = divmod(w, K); the grid covers the S x K walks,
// kGenWarps to a block.
template <typename T>
__global__ void __launch_bounds__(32 * kGenWarps)
probe_general_kernel(const T* __restrict__ p, const T* __restrict__ Ls,
                     int* __restrict__ out, int n_plus_1, long long walks,
                     int K, int cap) {
  const long long w = (long long)blockIdx.x * kGenWarps + threadIdx.x / 32;
  if (w >= walks) return;  // a whole warp
  const int lane = threadIdx.x % 32;
  const T* row = p + (w / K) * n_plus_1;
  const T L = Ls[w];
  const int n = n_plus_1 - 1;
  int pos = 0, cnt = 0, last = 0;  // last: the previous interval's length
  T t = T(0);
  T x[kGenPerLane];  // the step's window, from base
  long long base = 1;  // the first step's: right after pos, no history
  if (n > 0) {
    t = add_wrap(row[0], L);
    read_slots(row, base, 1, (long long)n + 1, lane, x);
  }
  for (int step = 0; step < cap && pos < n; ++step) {
    T v = T(0);
    const int nxt = next_pos(row, pos, n, t, base, x, lane, v);
    if (nxt == pos) break;  // stuck: no later step moves
    last = nxt - pos;
    pos = nxt;
    ++cnt;
    t = add_wrap(v, L);
    // the next step's window, centred on its predicted end pos + last,
    // inside (pos, n] where the row allows
    base = max((long long)pos + 1, min((long long)pos + last - kGenWindow / 2,
                                       (long long)n + 1 - kGenWindow));
    read_slots(row, base, 1, (long long)n + 1, lane, x);
  }
  if (lane == 0) out[w] = pos < n ? cap + 1 : (cnt > 1 ? cnt : 1);
}

template <typename T>
int probe_general_launch(const T* p, const T* Ls, int* out, int S,
                         int n_plus_1, int K, int cap, cudaStream_t st) {
  if (S == 0 || K == 0) return (int)cudaGetLastError();
  const long long walks = (long long)S * K;
  probe_general_kernel<T>
      <<<(unsigned)((walks + kGenWarps - 1) / kGenWarps), 32 * kGenWarps, 0,
         st>>>(p, Ls, out, n_plus_1, walks, K, cap);
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
