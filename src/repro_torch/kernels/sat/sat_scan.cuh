// Device code shared by K1 (sat.cu, the 2D Gamma) and K4 (sat3d.cu, the 3D
// Gamma3): "reduce, then scan" over bands of rows, written straight into
// the exclusive Gamma with its zero borders.
//
// A "plane stack" (Planes) is F planes of (rows, cols) entries; plane f
// starts at plane_of(f, slabs) * ps + off, its rows `rp` entries apart.
// plane_of is f for a 2D stack (slabs = 0); for slab s of 3D frame b
// (f = b * slabs + s) it is b * (slabs + 1) + s + 1, so that each 3D frame
// keeps its zero plane 0.
//
// The TPU kernels carried a running edge sum from one sequential grid step
// to the next; on the card blocks run in no order.  So each plane is cut
// into bands of R rows, and launches in turn take the place of the carry:
//   * the reduce (band_carries) sums every band but the last column by
//     column and leaves in scratch E, for every band but the first, the
//     column sums of all rows above it: band_sum_kernel then
//     carry_scan_kernel, or band_walk_kernel in one launch where a plane
//     has columns enough;
//   * the scan (sat_band_kernel): a block per (plane, band) walks the band
//     in tiles of NW * RPW rows by 32 * CPL columns.  Lane l of warp w
//     holds rows w * RPW + t and the CPL neighbouring columns from CPL * l.
//     A ring of cp.async copies keeps the next tiles in flight, each thread
//     copying the entries it later reads; a lane scans its own entries and
//     a warp shuffle scan the lanes; the column sums go down the tile
//     through one exchange in shared memory, with the band's carry (the
//     row prefix of E, i.e. Gamma's row above the band) added on; each
//     output row passes through shared memory so that the stores to
//     Gamma's unaligned rows cover 32 neighbouring entries.  It reads its
//     band once and writes each Gamma entry once.
// sat3d.cu builds K4 from the same pieces.
//
// Sums.  A float32 row is summed in float32 within one lane's CPL entries
// only; every other sum (across lanes, down the columns, across bands and
// slabs) is float64, and each Gamma entry is rounded once.  Integer loads
// below 2**53 are then exact until that rounding, so below a frame total of
// 2**24 the result equals torch.cumsum's bit for bit.  int32 sums are taken
// in uint32: they wrap mod 2**32 as torch.cumsum(dtype=int32) does, in any
// order, without the undefined behaviour of signed overflow.  float64 (K1
// only) sums in float64 throughout: integer loads are exact below a frame
// total of 2**53.
//
// Element size.  The tiles are sized in bytes: a 4-byte element takes 8
// columns a lane (16 x 256 tiles), an 8-byte one 4 (16 x 128 tiles), so a
// tile, the ring and the staging rows hold the same bytes for both and
// every 16-byte copy moves 16 / sizeof(T) entries.
#pragma once

#include <cuda_runtime.h>

namespace {

template <typename T> struct Sums;
template <> struct Sums<float> {
  using Row = float;    // sums within one lane's entries of a row
  using Acc = double;   // every other sum
  using V4 = float4;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float out(double v) {
    return __double2float_rn(v);
  }
};
// four doubles, 16-byte aligned (loaded as two 16-byte vectors)
struct __align__(16) D4 {
  double x, y, z, w;
};
template <> struct Sums<double> {
  using Row = double;
  using Acc = double;
  using V4 = D4;
  static __device__ __forceinline__ double load(const double* p) {
    return *p;
  }
  static __device__ __forceinline__ double out(double v) { return v; }
};
template <> struct Sums<int> {
  using Row = unsigned;
  using Acc = unsigned;
  using V4 = int4;
  static __device__ __forceinline__ unsigned load(const int* p) {
    return static_cast<unsigned>(*p);
  }
  static __device__ __forceinline__ int out(unsigned v) {
    return static_cast<int>(v);
  }
};

struct Planes {
  long long ps, off, rp;  // plane stride, offset of entry (0, 0), row pitch
  int slabs;
};

__device__ __forceinline__ long long plane_start(const Planes& p,
                                                 long long f) {
  const long long pl = p.slabs > 0 ? f + f / p.slabs + 1 : f;
  return pl * p.ps + p.off;
}

// inclusive scan over the 32 lanes of a warp
template <typename V>
__device__ __forceinline__ V warp_scan(V v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Scan of a row chunk held CPL neighbouring entries a lane: v becomes the
// lane's own inclusive scan; returns the sum of the lanes before this one,
// taken in S, and leaves the chunk's sum in `total`.
template <typename S, typename Row, int CPL>
__device__ __forceinline__ S seg_scan(Row (&v)[CPL], int lane, S& total) {
#pragma unroll
  for (int e = 1; e < CPL; ++e) v[e] += v[e - 1];
  const S incl = warp_scan(S(v[CPL - 1]), lane);
  total = __shfl_sync(0xffffffffu, incl, 31);
  const S ex = __shfl_up_sync(0xffffffffu, incl, 1);
  return lane == 0 ? S(0) : ex;
}

// -- cp.async: each thread copies the entries it later reads, so waiting
// on its own groups is enough (no block barrier) --------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one entry's copy, by element size
template <int Bytes> struct CpAsync;
template <> struct CpAsync<4> {
  static __device__ __forceinline__ void one(void* d, const void* s) {
    cp_async4(d, s);
  }
};
template <> struct CpAsync<8> {
  static __device__ __forceinline__ void one(void* d, const void* s) {
    cp_async8(d, s);
  }
};

// Copy entries c .. c + CPL - 1 of a row to dst, zeros past `cols` or for
// a row that is not there (`live` false; row is then not read); vec:
// 16-byte copies of 16 / sizeof(T) entries (rows and c 16-byte aligned).
template <typename T, int CPL>
__device__ __forceinline__ void copy_seg(T* dst, const T* row, int c,
                                         int cols, bool live, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (CPL % 4 == 0 && vec && live && c + CPL <= cols) {
#pragma unroll
    for (int e = 0; e < CPL; e += V) cp_async16(dst + e, row + c + e);
  } else {
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      if (live && c + e < cols)
        CpAsync<sizeof(T)>::one(dst + e, row + c + e);
      else
        dst[e] = T(0);
    }
  }
}

// A lane's CPL entries from / to shared memory (16-byte aligned when
// CPL % 4 == 0)
template <typename T, int CPL>
__device__ __forceinline__ void read_seg(typename Sums<T>::Row (&v)[CPL],
                                         const T* p) {
  using Row = typename Sums<T>::Row;
  if (CPL % 4 == 0) {
#pragma unroll
    for (int e = 0; e < CPL; e += 4) {
      const typename Sums<T>::V4 u =
          *reinterpret_cast<const typename Sums<T>::V4*>(p + e);
      v[e] = Row(u.x);
      v[e + 1] = Row(u.y);
      v[e + 2] = Row(u.z);
      v[e + 3] = Row(u.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < CPL; ++e) v[e] = Row(p[e]);
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void write_seg(T* p, const T (&o)[CPL]) {
  if (CPL % 4 == 0) {
#pragma unroll
    for (int e = 0; e < CPL; e += 4)
      *reinterpret_cast<typename Sums<T>::V4*>(p + e) = {o[e], o[e + 1],
                                                         o[e + 2], o[e + 3]};
  } else {
#pragma unroll
    for (int e = 0; e < CPL; ++e) p[e] = o[e];
  }
}

// One output row of a warp: the lanes' CPL entries through the warp's
// staging row sw, then 32 neighbouring entries a store (n of them live).
template <typename T, int CPL>
__device__ __forceinline__ void store_row(T* dst, int n, T* sw, int lane,
                                          const T (&o)[CPL]) {
  write_seg<T, CPL>(sw + CPL * lane, o);
  __syncwarp();
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = 32 * u + lane;
    if (c < n) dst[c] = sw[c];
  }
  __syncwarp();
}

// Column offsets of a tile: warp w left the column sums of its rows in
// tb[w][col]; afterwards tb[w][col] holds the sums of warps above w, and
// tb[NW][col] the sum of all warps.  Called by the whole block; tb is
// (NW + 1) x CW, CW <= 32 * NW.
template <int NW, typename Acc>
__device__ __forceinline__ void exchange_columns(Acc* tb, int CW) {
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < CW) {
    Acc a[NW];
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) a[ww] = tb[ww * CW + tid];
    Acc run = Acc(0);
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      tb[ww * CW + tid] = run;
      run += a[ww];
    }
    tb[NW * CW + tid] = run;
  }
  __syncthreads();
}

// The reduce, in two launches.  The bands below the last are cut into
// sub-bands of at most kSub rows.  band_sum_kernel: block (plane f,
// sub-band j, chunk of 4 * TC columns) of TR x TC threads, thread (r, t)
// summing rows r, r + TR, ... of the sub-band over the 4 columns from
// 4 t, so that the block reads whole runs of each row; E[f][j][c] = the
// sub-band's column sums.  carry_scan_kernel: thread per (plane, column)
// adds them up in place: E[f][k][c] = sum of rows [0, (k + 1) R) of column
// c, the carry of band k + 1.
constexpr int kSub = 32, kSumThreads = 256, kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
band_sum_kernel(const T* x, Planes xp, int cols, int R, int per, int nsub,
                int TC, long long nchunk, typename Sums<T>::Acc* E,
                bool vec) {
  using Acc = typename Sums<T>::Acc;
  __shared__ Acc red[kSumThreads][4];
  const int tid = threadIdx.x, tc = tid % TC, tr = tid / TC;
  const int TR = kSumThreads / TC;
  long long b = blockIdx.x;
  const int ch = (int)(b % nchunk);
  b /= nchunk;
  const int j = (int)(b % nsub);
  const long long f = b / nsub;
  const int k = j / per, i0 = k * R + (j % per) * kSub;
  const int n = min(i0 + kSub, (k + 1) * R) - i0;
  const int c = ch * 4 * TC + 4 * tc;
  const T* p = x + plane_start(xp, f) + (long long)i0 * xp.rp + c;
  Acc s[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
  auto add_row = [&](int i) {
    const T* q = p + (long long)i * xp.rp;
    if (vec && c + 4 <= cols) {
      const typename Sums<T>::V4 u =
          *reinterpret_cast<const typename Sums<T>::V4*>(q);
      s[0] += Acc(typename Sums<T>::Row(u.x));
      s[1] += Acc(typename Sums<T>::Row(u.y));
      s[2] += Acc(typename Sums<T>::Row(u.z));
      s[3] += Acc(typename Sums<T>::Row(u.w));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < cols) s[e] += Acc(Sums<T>::load(q + e));
    }
  };
  int i = tr;
  for (; i + (kUnroll - 1) * TR < n; i += kUnroll * TR) {  // rows in flight
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_row(i + u * TR);
  }
  for (; i < n; i += TR) add_row(i);
  if (TR > 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[tid][e] = s[e];
    __syncthreads();
    if (tr == 0)
      for (int r = 1; r < TR; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += red[r * TC + tc][e];
  }
  if (tr == 0) {
    Acc* o = E + (f * nsub + j) * (long long)cols + c;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < cols) o[e] = s[e];
  }
}

template <typename Acc>
__global__ void carry_scan_kernel(Acc* E, int cols, int per, int nsub,
                                  long long F) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * cols) return;
  Acc* e = E + (idx / cols) * nsub * (long long)cols + idx % cols;
  Acc run = Acc(0);
  for (int j = 0; j < nsub; ++j) {  // writes only entries already read
    run += e[(long long)j * cols];
    if (j % per == per - 1) e[(long long)(j / per) * cols] = run;
  }
}

// The reduce in one launch where there are columns enough: block (plane f,
// 4 * kSumThreads columns), each thread on 4 columns walks the rows of all
// bands but the last and writes the running sums at each band's end, where
// carry_scan_kernel would have left them.
constexpr int kWalkThreads = 256, kWalkUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
band_walk_kernel(const T* x, Planes xp, int cols, int R, int nb,
                 typename Sums<T>::Acc* E, long long nchunk, long long efs,
                 bool vec) {
  using Acc = typename Sums<T>::Acc;
  const long long f = blockIdx.x / nchunk;
  const int c = (int)(blockIdx.x % nchunk) * 4 * kWalkThreads + 4 * threadIdx.x;
  if (c >= cols) return;
  const T* p = x + plane_start(xp, f) + c;
  Acc* o = E + f * efs + c;
  Acc s[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
  auto add_row = [&](int i) {
    const T* q = p + (long long)i * xp.rp;
    if (vec) {
      const typename Sums<T>::V4 u =
          *reinterpret_cast<const typename Sums<T>::V4*>(q);
      s[0] += Acc(typename Sums<T>::Row(u.x));
      s[1] += Acc(typename Sums<T>::Row(u.y));
      s[2] += Acc(typename Sums<T>::Row(u.z));
      s[3] += Acc(typename Sums<T>::Row(u.w));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < cols) s[e] += Acc(Sums<T>::load(q + e));
    }
  };
  for (int k = 0; k < nb - 1; ++k) {
    int i = k * R;
    for (; i + kWalkUnroll <= (k + 1) * R; i += kWalkUnroll) {
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) add_row(i + u);  // in flight
    }
    for (; i < (k + 1) * R; ++i) add_row(i);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < cols) o[(long long)k * cols + e] = s[e];
  }
}

// 16-byte loads of rows start at a 16-byte boundary in every plane
inline bool rows_aligned(const void* x, const Planes& p, long long cols) {
  return reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
         cols % 4 == 0 && p.rp % 4 == 0 && p.ps % 4 == 0 && p.off % 4 == 0;
}

// Both launches of the reduce for F planes of (rows, cols) by bands of R
// rows (nb bands); E holds F * nsub * cols sums.
template <typename T>
cudaError_t band_carries(const T* x, Planes xp, long long F, int cols, int R,
                         int nb, typename Sums<T>::Acc* E, cudaStream_t st) {
  const int per = (R + kSub - 1) / kSub;
  const long long nsub = (long long)(nb - 1) * per;
  if (nsub == 0 || cols == 0 || F == 0) return cudaSuccess;
  const long long quads = (cols + 3) / 4;
  const long long wchunk = (quads + kWalkThreads - 1) / kWalkThreads;
  if (F * wchunk >= 128) {
    band_walk_kernel<T><<<(unsigned)(F * wchunk), kWalkThreads, 0, st>>>(
        x, xp, cols, R, nb, E, wchunk, nsub * cols, rows_aligned(x, xp, cols));
    return cudaSuccess;
  }
  const int TC = quads >= kSumThreads ? kSumThreads
                                      : (int)((quads + 31) / 32 * 32);
  const long long nchunk = (quads + TC - 1) / TC;
  if (F * nsub * nchunk > 0x7fffffffLL || nsub > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  band_sum_kernel<T><<<(unsigned)(F * nsub * nchunk), kSumThreads, 0, st>>>(
      x, xp, cols, R, per, (int)nsub, TC, nchunk, E,
      rows_aligned(x, xp, cols));
  const long long n = F * cols;
  carry_scan_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      E, cols, per, (int)nsub, F);
  return cudaSuccess;
}

// The scan.  Block (plane f, band k) writes Gamma rows r0 + 1 .. r1 of its
// plane (and row 0 for band 0, column 0 of its rows) from E's carry for
// band k (Gamma's row above the band, as the row prefix of E).  x may be
// g's own interior (K4's general route scans in place): each entry is read
// by the step that writes it, and no other block reads it.
// Shared memory: tb [2][NW + 1][CW] (column e * 32 + l of tb is entry e of
// lane l), stage [NW][CW] (a warp's output row), ring [NST][TR][CW] (the
// input tiles in flight) and, when a row takes more than one chunk of CW
// columns, rc [R] (each row's sum left of the chunk).
template <typename T, int CPL, int RPW, int NW, int NST>
__global__ void __launch_bounds__(32 * NW)
sat_band_kernel(const T* x, Planes xp, T* g, Planes gp, int rows, int cols,
                int R, int nb, const typename Sums<T>::Acc* __restrict__ E,
                long long efs, bool vec) {
  using Row = typename Sums<T>::Row;
  using Acc = typename Sums<T>::Acc;
  constexpr int CW = 32 * CPL, TR = NW * RPW, NT = 32 * NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* tot = reinterpret_cast<Acc*>(smem_raw);
  T* stage = reinterpret_cast<T*>(tot + 2 * (NW + 1) * CW);
  T* ring = stage + NW * CW;
  Acc* rc = reinterpret_cast<Acc*>(ring + NST * TR * CW);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int cl = CPL * lane;  // this lane's first column of a chunk
  const long long f = blockIdx.x / nb;
  const int k = blockIdx.x % nb;
  const int r0 = k * R, r1 = min(r0 + R, rows);
  const T* xs = x + plane_start(xp, f);
  T* gs = g + plane_start(gp, f);
  const long long rp = gp.rp;
  const int nch = (cols + CW - 1) / CW;
  const bool multi = nch > 1;
  if (k == 0)
    for (int c = tid; c <= cols; c += NT) gs[c] = T(0);
  for (int i = r0 + tid; i < r1; i += NT) gs[(i + 1) * rp] = T(0);
  if (multi)
    for (int i = tid; i < r1 - r0; i += NT) rc[i] = Acc(0);
  __syncthreads();
  const int ntiles = (r1 - r0 + TR - 1) / TR;
  const int nsteps = nch * ntiles;
  const Acc* eband = k > 0 ? E + f * efs + (k - 1) * (long long)cols
                           : nullptr;
  T* sw = stage + w * CW;
  Acc V[CPL];            // Gamma's row above the tile, this lane's columns
  Acc ecarry = Acc(0);   // row prefix of E left of the chunk
#pragma unroll
  for (int e = 0; e < CPL; ++e) V[e] = Acc(0);

  auto issue = [&](int st) {  // step st's tile into its ring slot
    if (st < nsteps) {
      const int c0 = (st / ntiles) * CW, t0 = r0 + (st % ntiles) * TR;
      T* slot = ring + (st % NST) * TR * CW;
#pragma unroll
      for (int t = 0; t < RPW; ++t) {
        const int i = t0 + w * RPW + t;
        copy_seg<T, CPL>(slot + (w * RPW + t) * CW + cl,
                         xs + (long long)i * xp.rp, c0 + cl, cols, i < r1,
                         vec);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) issue(st);
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<NST - 2>();  // step st's tile has landed
    issue(st + NST - 1);       // into the slot that step st - 1 read
    const int c0 = (st / ntiles) * CW, t0 = r0 + (st % ntiles) * TR;
    const T* slot = ring + (st % NST) * TR * CW;
    Acc* tb = tot + (st & 1) * (NW + 1) * CW;
    if (st % ntiles == 0) {  // a new chunk: V = row prefix of E
      Acc ev[CPL], total;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const int c = c0 + cl + e;
        ev[e] = (eband != nullptr && c < cols) ? eband[c] : Acc(0);
      }
      const Acc ex = seg_scan<Acc>(ev, lane, total);
#pragma unroll
      for (int e = 0; e < CPL; ++e) V[e] = ecarry + (ex + ev[e]);
      ecarry += total;
    }
    // phase 1: scan each row; Cb = the row's sum left of this lane
    Row v[RPW][CPL];
    Acc cs[CPL], Cb[RPW];
#pragma unroll
    for (int e = 0; e < CPL; ++e) cs[e] = Acc(0);
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int i = t0 + w * RPW + t;
      read_seg<T, CPL>(v[t], slot + (w * RPW + t) * CW + cl);
      const Acc C = (multi && i < r1) ? rc[i - r0] : Acc(0);
      Acc total;
      Cb[t] = C + seg_scan<Acc>(v[t], lane, total);
#pragma unroll
      for (int e = 0; e < CPL; ++e) cs[e] += Cb[t] + Acc(v[t][e]);
      if (multi) {  // every lane has read rc; lane 0 moves it on
        __syncwarp();
        if (lane == 0 && i < r1) rc[i - r0] = C + total;
      }
    }
#pragma unroll
    for (int e = 0; e < CPL; ++e) tb[w * CW + e * 32 + lane] = cs[e];
    exchange_columns<NW>(tb, CW);
    // phase 2: Gamma = V + rows above in the tile + this row, rounded once
    Acc run[CPL];
#pragma unroll
    for (int e = 0; e < CPL; ++e) run[e] = V[e] + tb[w * CW + e * 32 + lane];
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int i = t0 + w * RPW + t;
      T o[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        run[e] += Cb[t] + Acc(v[t][e]);
        o[e] = Sums<T>::out(run[e]);
      }
      if (i < r1)  // warp-uniform
        store_row<T, CPL>(gs + (i + 1) * rp + 1 + c0, cols - c0, sw, lane, o);
    }
#pragma unroll
    for (int e = 0; e < CPL; ++e) V[e] += tb[NW * CW + e * 32 + lane];
  }
  cp_async_wait<0>();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K1's tiles: 16 rows x 16 * 64 bytes (256 columns of 4 bytes, 128 of 8),
// three in flight
constexpr int kScanRPW = 2, kScanNW = 8, kScanNST = 3;
template <typename T>
constexpr int scan_cpl() {
  return sizeof(T) == 8 ? 4 : 8;
}

// Gamma of F planes of (rows, cols) by bands of R rows: the reduce, then
// the scan.  E holds F * (nb - 1) * ceil(R / kSub) * cols sums.  Returns
// cudaErrorInvalidConfiguration for a plan it cannot run.
template <typename T>
cudaError_t gamma_planes(const T* x, Planes xp, T* g, Planes gp, long long F,
                         int rows, int cols, int R,
                         typename Sums<T>::Acc* E, cudaStream_t st) {
  using Acc = typename Sums<T>::Acc;
  if (R <= 0) return cudaErrorInvalidConfiguration;
  const int nb = rows > 0 ? (rows + R - 1) / R : 1;
  if (F <= 0) return cudaSuccess;
  if (F * nb > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t e = band_carries<T>(x, xp, F, cols, R, nb, E, st);
  if (e != cudaSuccess) return e;
  constexpr int CPL = scan_cpl<T>();
  constexpr int CW = 32 * CPL, TR = kScanNW * kScanRPW;
  const bool multi = cols > CW;
  const size_t smem = sizeof(Acc) * 2 * (kScanNW + 1) * CW +
                      sizeof(T) * (kScanNW + kScanNST * TR) * CW +
                      (multi ? sizeof(Acc) * (size_t)R : 0);
  auto kernel = sat_band_kernel<T, CPL, kScanRPW, kScanNW, kScanNST>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const long long efs = (long long)(nb - 1) * ((R + kSub - 1) / kSub) * cols;
  kernel<<<(unsigned)(F * nb), 32 * kScanNW, smem, st>>>(
      x, xp, g, gp, rows, cols, R, nb, E, efs, rows_aligned(x, xp, cols));
  return cudaSuccess;
}

}  // namespace
