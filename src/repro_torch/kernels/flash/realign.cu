// K5's realigning copy: (rows, d) rows that start at any element boundary
// <-> (rows, dp) rows at a 16-byte aligned base, dp = d rounded up to a
// multiple of 8, at 2-byte (bfloat16, float16) and 4-byte (float32)
// elements.
//
// Replaces no TPU kernel.  It was added in front of the port of
// src/repro/kernels/flash/flash.py:94 (flash.cu's flash_wide route, which
// computes S once a key tile for every output column): that route reads
// its tensors by TMA, which describes only 16-byte aligned bases with rows
// of a multiple of 16 bytes, and has neither the shared memory nor the
// registers left for a producer that realigns rows itself.  So
// ops.flash_attention copies each tensor TMA cannot describe into padded,
// aligned scratch with this kernel (pad: columns [d, dp) zero, which add
// nothing to S) and, where d % 8 != 0, copies the padded output back
// (unpad: the first d columns of each row, stores at any element
// boundary).
//
// What bounds it on the card: bytes.  Each source byte is read once and
// each destination byte written once, over 3.35 TB/s; it does no
// arithmetic worth counting.  What the design does about that:
//
// * Every thread writes whole aligned 16-byte units of the destination,
//   one 16-byte store each, neighbouring threads on neighbouring units, so
//   the writes are coalesced whatever the source's offset.
// * For each unit a thread reads the one or two aligned 16-byte source
//   segments that hold its bytes (ld.global.nc, 16 bytes each) and shifts
//   them into place in registers: a word select by bits 3 and 2 of the
//   byte offset, then four funnel shifts by its bits 1 and 0.  The
//   neighbouring threads read overlapping segments, so device memory sees
//   each source byte about once; the second read of a segment hits L1/L2.
// * No segment that holds none of the source tensor's bytes is read (the
//   rule of flash.cu's general producer): a unit loads its second segment
//   only where its bytes reach into it, so the last partial segment of the
//   allocation is read only for the bytes it holds.
// * Pad: a unit lies in one destination row; bytes past the row's d
//   columns are zeroed.  Unpad: the destination's rows start at any
//   element boundary, so a unit may hold the end of one row and the start
//   of the next (two source runs: the row's tail, one or two segments, and
//   the next row's head, one aligned segment); the destination's first and
//   last segments may hold bytes outside the tensor and are written
//   element by element, only where the tensor lies.
// * One block a run of rows (about 1,024 units, 4 a thread, 256 threads),
//   so a thread finds its row by a 32-bit division within the block.
//
// A refused launch returns a CUDA error code (positive) and the wrapper
// raises; misaligned bases (the aligned side not on 16 bytes, the other
// not on an element) are refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int UNITS = 4 * NT;    // 16-byte destination units a block, about

// The 16 bytes that start at byte sh (0 <= sh < 16) of the 32 bytes a, b
// (a first, little-endian)
__device__ __forceinline__ uint4 bytes_at(uint4 a, uint4 b, int sh) {
  uint32_t w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w, w4 = b.x, w5 = b.y;
  if (sh & 8) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = b.z; w5 = b.w;
  }
  if (sh & 4) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5;
  }
  const uint32_t s = 8 * (sh & 3);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

// The first nb bytes of word w (nb <= 0: none; nb >= 4: all)
__device__ __forceinline__ uint32_t head(uint32_t w, int nb) {
  return nb >= 4 ? w : nb <= 0 ? 0u : w & ((1u << (8 * nb)) - 1u);
}

__device__ __forceinline__ uint4 head(uint4 x, int nb) {
  return make_uint4(head(x.x, nb), head(x.y, nb - 4), head(x.z, nb - 8),
                    head(x.w, nb - 12));
}

__device__ __forceinline__ uint4 ld16(uintptr_t a) {
  return __ldg(reinterpret_cast<const uint4*>(a));
}

// Pad: block b takes rows [b R, b R + R); unit i of the block is (row
// i / upr, columns 16 / EB a unit); src at any EB-byte boundary, dst
// 16-byte aligned
template <int EB>
__global__ void __launch_bounds__(NT)
    pad_kernel(const unsigned char* __restrict__ src, uint4* __restrict__ dst,
               int rows, int d, int upr, int R) {
  const long long r0 = (long long)blockIdx.x * R;
  const int n = (int)min((long long)R, rows - r0) * upr;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src) + r0 * d * EB;
  uint4* o = dst + r0 * upr;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int r = i / upr, c = (i - r * upr) * (16 / EB);
    const int nb = min(16, (d - c) * EB);  // the row's bytes in this unit
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (nb > 0) {
      const uintptr_t a = s + ((long long)r * d + c) * EB;
      const uintptr_t g = a & ~uintptr_t(15);
      const int sh = (int)(a & 15);
      const uint4 lo = ld16(g);
      const uint4 hi = sh + nb > 16 ? ld16(g + 16) : lo;
      x = head(bytes_at(lo, hi, sh), nb);
    }
    o[i] = x;
  }
}

// One element of the unpadded tensor (flat index e) from the padded one
template <int EB>
__device__ __forceinline__ void copy_elem(const unsigned char* src,
                                          unsigned char* dst, long long e,
                                          int d, int dp) {
  const long long r = e / d, c = e - r * d;
  if (EB == 2) {
    reinterpret_cast<uint16_t*>(dst)[e] =
        reinterpret_cast<const uint16_t*>(src)[r * dp + c];
  } else {
    reinterpret_cast<uint32_t*>(dst)[e] =
        reinterpret_cast<const uint32_t*>(src)[r * dp + c];
  }
}

// Unpad: the destination's aligned 16-byte segments, counted from the one
// that holds its first byte (byte off of segment 0); block b takes the
// segments from the one holding row b R's first element to the one
// before row b R + R's (the last block: to the end).  src 16-byte
// aligned, dst at any EB-byte boundary
template <int EB>
__global__ void __launch_bounds__(NT)
    unpad_kernel(const unsigned char* __restrict__ src,
                 unsigned char* __restrict__ dst, int rows, int d, int dp,
                 int R) {
  constexpr int E = 16 / EB;  // elements a unit
  const int off = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(dst) - off;
  const long long N = (long long)rows * d;
  const long long r0 = (long long)blockIdx.x * R;
  const long long ulo = (off + r0 * d * EB) >> 4;
  const long long uhi = r0 + R >= rows ? (off + N * EB + 15) >> 4
                                       : (off + (r0 + R) * d * EB) >> 4;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  for (long long i = ulo + threadIdx.x; i < uhi; i += NT) {
    const long long e0 = (16 * i - off) / EB;  // the unit's first slot
    // the first or last segment, which hold bytes outside the tensor (and
    // every unit of rows narrower than a unit): element by element
    if (e0 < 0 || e0 + E > N || d < E) {
      for (int j = 0; j < E; ++j)
        if (e0 + j >= 0 && e0 + j < N) copy_elem<EB>(src, dst, e0 + j, d, dp);
      continue;
    }
    // > -E >= -d: the block's first unit may start in row r0 - 1; a unit
    // spans at most two rows
    const int l = (int)(e0 - r0 * d);
    const int q = (l + d) / d - 1, c = l - q * d;
    const long long row = r0 + q;
    const int k = min(E, d - c) * EB;  // bytes from this row
    const uintptr_t a = s + (row * dp + c) * EB;
    const uintptr_t g = a & ~uintptr_t(15);
    const int sh = (int)(a & 15);
    const uint4 lo = ld16(g);
    const uint4 hi = sh + k > 16 ? ld16(g + 16) : lo;
    uint4 x = bytes_at(lo, hi, sh);
    if (k < 16) {  // the rest from the next row's first segment
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      x = bytes_at(bytes_at(zero, x, k), ld16(s + (row + 1) * dp * EB),
                   16 - k);
    }
    reinterpret_cast<uint4*>(g0)[i] = x;
  }
}

template <int EB>
int launch(const void* src, void* dst, int rows, int d, int unpad,
           cudaStream_t st) {
  const int dp = (d + 7) / 8 * 8;
  const int R = max(1, UNITS / (dp * EB / 16));
  const unsigned blocks = (unsigned)((rows + (long long)R - 1) / R);
  if (unpad) {
    unpad_kernel<EB><<<blocks, NT, 0, st>>>(
        static_cast<const unsigned char*>(src),
        static_cast<unsigned char*>(dst), rows, d, dp, R);
  } else {
    pad_kernel<EB><<<blocks, NT, 0, st>>>(
        static_cast<const unsigned char*>(src), static_cast<uint4*>(dst),
        rows, d, dp * EB / 16, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Copies rows x d elements of elem_bytes (2 or 4) each: unpad = 0 from src
// (any element boundary) into dst (16-byte aligned, rows x dp, columns
// [d, dp) zeroed); unpad = 1 the first d of each row of dp from src
// (16-byte aligned) into dst (any element boundary).  Returns 0 or a CUDA
// error code.
extern "C" int repro_flash_realign(const void* src, void* dst, int rows,
                                   int d, int elem_bytes, int unpad,
                                   void* stream) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t t = reinterpret_cast<uintptr_t>(dst);
  if (rows < 0 || d < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if ((unpad ? s : t) % 16 != 0 || (unpad ? t : s) % elem_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem_bytes == 2 ? launch<2>(src, dst, rows, d, unpad, st)
                         : launch<4>(src, dst, rows, d, unpad, st);
}
