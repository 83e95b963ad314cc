// K4: the 3D summed-area table, written straight into the exclusive Gamma3.
//
// Replaces the Pallas kernel src/repro/kernels/sat/sat3d.py::sat3_pallas
// (_scan3_kernel, _scan2_kernel, _scan1_kernel) plus the zero-border
// embedding of src/repro/kernels/sat/ref.py::gamma3_from_sat, fused: the
// output is the (B, n1+1, n2+1, n3+1) Gamma3 with its three zero planes.
//
// What bounds it on the card: bytes, one read of the input and one write
// of Gamma3 (at (16, 128, 128, 128) float32, 134.2 MB in and 137.4 MB
// out, 0.081 ms at 3.35 TB/s); the operations are a few adds per entry.
//
// Design, by linearity: Gamma3 of slab s is the 2D prefix of the running
// plane, the sum of slabs 0..s.  "Reduce, then scan" over bands of S slabs:
//   * the reduce (sat_scan.cuh's, the slabs as rows and the n2 * n3 plane
//     entries as columns) reads every band but the last and leaves for
//     each band the sum of the slabs above it, a float64 (uint32) plane in
//     scratch;
//   * the scan (sat3_band_kernel): a block per (frame, band) keeps the
//     running plane, row prefixed, in registers (float64), walks its S
//     slabs with the next two in flight, and writes each Gamma3 plane once,
//     through the same lane layout, row scans, column exchange and staged
//     stores as K1's scan.
// At (16, 128, 128, 128) with 8 bands of 16 slabs it moves 418.4 MB,
// 1.54x the bound's bytes: 117.4 MB for the reduce, 29.4 MB of carries,
// 271.6 MB for the scan.  The design it replaces (a 2D table of every slab
// by K1's old row and column scans, then two more sweeps down the slabs)
// wrote and read Gamma3 five times, about 5x the bound (its note said
// three).
// A plane that does not fit a block (n3 > 256, or n2 > 512 / c for the
// smallest class c with n3 <= 32 c) takes the general route, counted as
// sat3_general: a scan down the slabs of each (j, k) entry into Gamma3's
// interior (slab_scan_kernel, float64 sums rounded once), then K1's reduce
// and scan on every plane in place, about 2.5x the bound's bytes.
// Sums as in sat_scan.cuh, one rounding into each entry (two on the
// general route).  int32: sums in uint32, which wrap mod 2**32 as
// torch.cumsum does; the int additions before overflowed, undefined
// behaviour in C++.

#include "sat_scan.cuh"

namespace {

// Block (frame f, band c): Gamma3 planes s0 + 1 .. s1 of frame f (and the
// zero plane 0 for band 0).  Lane l of warp w holds plane rows w * RPW + t
// and the CPL neighbouring columns from CPL * l, and in registers q, the
// running plane there with each row prefix summed (RPW * CPL = 16 entries
// a thread, 32 for class 8).  Shared memory: tb [2][NW + 1][CW] (as in
// sat_band_kernel), stage [NW][CW] (a warp's output row) and ring
// [2][TR][CW], the next two slabs in flight.
template <typename T, int CPL, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
sat3_band_kernel(const T* __restrict__ x, T* __restrict__ g, int n1, int n2,
                 int n3, int S, int nb,
                 const typename Sums<T>::Acc* __restrict__ E, long long efs,
                 bool vec) {
  using Row = typename Sums<T>::Row;
  using Acc = typename Sums<T>::Acc;
  constexpr int CW = 32 * CPL, TR = 512 / CPL, RPW = TR / NW, NT = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tot = reinterpret_cast<Acc*>(smem_raw);
  T* stage = reinterpret_cast<T*>(tot + 2 * (NW + 1) * CW);
  T* ring = stage + NW * CW;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cl = CPL * lane;
  const long long f = blockIdx.x / nb;
  const int c = blockIdx.x % nb;
  const int s0 = c * S, s1 = min(s0 + S, n1);
  const long long np = (long long)n2 * n3;
  const long long pitch = n3 + 1, P3 = (long long)(n2 + 1) * pitch;
  const T* xf = x + f * n1 * np;
  T* gf = g + f * (n1 + 1) * P3;
  T* sw = stage + w * CW;

  auto issue = [&](int s) {  // slab s into ring slot (s - s0) % 2
    if (s < s1) {
      T* slot = ring + ((s - s0) & 1) * TR * CW;
#pragma unroll
      for (int t = 0; t < RPW; ++t) {
        const int j = w * RPW + t;
        copy_seg<T, CPL>(slot + j * CW + cl, xf + s * np + (long long)j * n3,
                         cl, n3, j < n2, vec);
      }
    }
    cp_async_commit();
  };
  issue(s0);
  issue(s0 + 1);

  if (c == 0)
    for (long long e = tid; e < P3; e += NT) gf[e] = T(0);
  // q = the slabs above the band, each row prefix summed
  const Acc* ep = c > 0 ? E + f * efs + (c - 1) * np : nullptr;
  Acc q[RPW][CPL];
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int j = w * RPW + t;
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      q[t][e] = (ep != nullptr && j < n2 && cl + e < n3)
                    ? ep[(long long)j * n3 + cl + e]
                    : Acc(0);
    Acc total;
    const Acc ex = seg_scan<Acc>(q[t], lane, total);
#pragma unroll
    for (int e = 0; e < CPL; ++e) q[t][e] += ex;
  }

  for (int s = s0; s < s1; ++s) {
    cp_async_wait<1>();  // slab s has landed
    const T* slot = ring + ((s - s0) & 1) * TR * CW;
    T* out = gf + (long long)(s + 1) * P3;
    for (int e = tid; e <= n3; e += NT) out[e] = T(0);
    Acc* tb = tot + ((s - s0) & 1) * (NW + 1) * CW;
    // phase 1: q += this slab's row prefixes; this thread's column sums
    Acc cs[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) cs[e] = Acc(0);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      Row v[CPL];
      Acc total;
      read_seg<T, CPL>(v, slot + (w * RPW + t) * CW + cl);
      const Acc ex = seg_scan<Acc>(v, lane, total);
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        q[t][e] += Acc(ex + v[e]);
        cs[e] += q[t][e];
      }
    }
    issue(s + 2);  // into the slot just read (each thread its own entries)
#pragma unroll
    for (int e = 0; e < CPL; ++e) tb[w * CW + e * 32 + lane] = cs[e];
    exchange_columns<NW>(tb, CW);
    // phase 2: Gamma3 rows = rows above + q, rounded once
    Acc run[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) run[e] = tb[w * CW + e * 32 + lane];
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int j = w * RPW + t;
      if (j >= n2) break;  // warp-uniform
      T o[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        run[e] += q[t][e];
        o[e] = Sums<T>::out(run[e]);
      }
      T* orow = out + (long long)(j + 1) * pitch;
      if (lane == 0) orow[0] = T(0);
      store_row<T, CPL>(orow + 1, n3, sw, lane, o);
    }
  }
  cp_async_wait<0>();
}

// Warps of a K4 scan block: 32 (16 entries a thread) where the block's
// shared memory allows it, 16 for the widest planes.
template <int CPL>
constexpr int scan3_warps() {
  return CPL == 8 ? 16 : 32;
}

template <typename T, int CPL>
cudaError_t launch_band3(const T* a, T* g, int B, int n1, int n2, int n3,
                         int S, int nb, const typename Sums<T>::Acc* E,
                         cudaStream_t st) {
  using Acc = typename Sums<T>::Acc;
  constexpr int NW = scan3_warps<CPL>(), CW = 32 * CPL, TR = 512 / CPL;
  const size_t smem = sizeof(Acc) * 2 * (NW + 1) * CW +
                      sizeof(T) * (NW + 2 * TR) * CW;
  auto kernel = sat3_band_kernel<T, CPL, NW>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const bool vec = reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                   n3 % 4 == 0;
  const long long efs = (long long)(nb - 1) * ((S + kSub - 1) / kSub) * n2 * n3;
  kernel<<<(unsigned)((long long)B * nb), 32 * NW, smem, st>>>(
      a, g, n1, n2, n3, S, nb, E, efs, vec);
  return cudaSuccess;
}

// The general route's first pass: thread per (frame, plane entry) walks the
// slabs and writes the running sum into Gamma3's interior; the blocks also
// zero plane 0.  Rows 0 and columns 0 of the other planes are left to K1.
template <typename T>
__global__ void slab_scan_kernel(const T* __restrict__ x, T* __restrict__ g,
                                 int n1, int n2, int n3, long long bpf) {
  using Acc = typename Sums<T>::Acc;
  const long long f = blockIdx.x / bpf;
  const long long p = (blockIdx.x % bpf) * blockDim.x + threadIdx.x;
  const long long np = (long long)n2 * n3;
  const long long pitch = n3 + 1, P3 = (long long)(n2 + 1) * pitch;
  T* gf = g + f * (n1 + 1) * P3;
  for (long long e = p; e < P3; e += bpf * blockDim.x) gf[e] = T(0);
  if (p >= np) return;
  const T* src = x + f * n1 * np + p;
  T* dst = gf + P3 + (p / n3 + 1) * pitch + p % n3 + 1;
  Acc run = Acc(0);
  int s = 0;
  for (; s + 8 <= n1; s += 8) {  // eight loads in flight
    Acc v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = Acc(Sums<T>::load(src + (long long)(s + u) * np));
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      run += v[u];
      dst[(long long)(s + u) * P3] = Sums<T>::out(run);
    }
  }
  for (; s < n1; ++s) {
    run += Acc(Sums<T>::load(src + (long long)s * np));
    dst[(long long)s * P3] = Sums<T>::out(run);
  }
}

// fast route: S slabs per band, plane class cpl (columns per lane)
template <typename T>
int gamma3_launch(const T* a, T* g, void* scratch, int B, int n1, int n2,
                  int n3, int S, int cpl, cudaStream_t st) {
  using Acc = typename Sums<T>::Acc;
  Acc* E = static_cast<Acc*>(scratch);
  if (S <= 0 || n3 > 32 * cpl || n2 > 512 / cpl)
    return (int)cudaErrorInvalidConfiguration;
  const int nb = n1 > 0 ? (n1 + S - 1) / S : 1;
  const long long np = (long long)n2 * n3;
  if ((long long)B * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t e = band_carries<T>(a, Planes{(long long)n1 * np, 0, np, 0}, B,
                                  (int)np, S, nb, E, st);
  if (e != cudaSuccess) return (int)e;
  switch (cpl) {
    case 1: e = launch_band3<T, 1>(a, g, B, n1, n2, n3, S, nb, E, st); break;
    case 2: e = launch_band3<T, 2>(a, g, B, n1, n2, n3, S, nb, E, st); break;
    case 4: e = launch_band3<T, 4>(a, g, B, n1, n2, n3, S, nb, E, st); break;
    case 8: e = launch_band3<T, 8>(a, g, B, n1, n2, n3, S, nb, E, st); break;
    default: e = cudaErrorInvalidConfiguration;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// general route: the slab scan, then K1 in place on the B * n1 planes with
// bands of R rows
template <typename T>
int gamma3_general_launch(const T* a, T* g, void* scratch, int B, int n1,
                          int n2, int n3, int R, cudaStream_t st) {
  const long long np = (long long)n2 * n3;
  const long long bpf = np > 0 ? (np + 255) / 256 : 1;
  if ((long long)B * bpf > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (B == 0) return (int)cudaSuccess;
  slab_scan_kernel<T><<<(unsigned)(B * bpf), 256, 0, st>>>(a, g, n1, n2, n3,
                                                            bpf);
  const long long pitch = n3 + 1, P3 = (long long)(n2 + 1) * pitch;
  const cudaError_t e = gamma_planes<T>(
      g, Planes{P3, pitch + 1, pitch, n1}, g, Planes{P3, 0, pitch, n1},
      (long long)B * n1, n2, n3, R,
      static_cast<typename Sums<T>::Acc*>(scratch), st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (B, ceil(n1 / S) - 1, n2 * n3) float64 sums
extern "C" int repro_sat3_gamma_f32(const void* a, void* g, void* scratch,
                                    int B, int n1, int n2, int n3, int S,
                                    int cpl, void* stream) {
  return gamma3_launch<float>(static_cast<const float*>(a),
                              static_cast<float*>(g), scratch, B, n1, n2, n3,
                              S, cpl, static_cast<cudaStream_t>(stream));
}

// scratch: as above, uint32 sums
extern "C" int repro_sat3_gamma_i32(const void* a, void* g, void* scratch,
                                    int B, int n1, int n2, int n3, int S,
                                    int cpl, void* stream) {
  return gamma3_launch<int>(static_cast<const int*>(a), static_cast<int*>(g),
                            scratch, B, n1, n2, n3, S, cpl,
                            static_cast<cudaStream_t>(stream));
}

// scratch: as K1's for B * n1 planes of (n2, n3) by bands of R rows
extern "C" int repro_sat3_general_f32(const void* a, void* g, void* scratch,
                                      int B, int n1, int n2, int n3, int R,
                                      void* stream) {
  return gamma3_general_launch<float>(
      static_cast<const float*>(a), static_cast<float*>(g), scratch, B, n1,
      n2, n3, R, static_cast<cudaStream_t>(stream));
}

// scratch: as above, uint32 sums
extern "C" int repro_sat3_general_i32(const void* a, void* g, void* scratch,
                                      int B, int n1, int n2, int n3, int R,
                                      void* stream) {
  return gamma3_general_launch<int>(
      static_cast<const int*>(a), static_cast<int*>(g), scratch, B, n1, n2,
      n3, R, static_cast<cudaStream_t>(stream));
}
