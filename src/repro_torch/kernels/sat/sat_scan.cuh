// Device code shared by K1 (sat.cu, the 2D Gamma) and K4 (sat3d.cu, the 3D
// Gamma): the two scans of a stack of 2D planes, written straight into an
// exclusive Gamma with its zero borders.
//
// A "plane stack" is F input frames of (rows, cols), contiguous, and an
// output of planes of (rows + 1, width) entries, width = cols + 1.  Input
// frame f goes to output plane plane_of(f, slabs): plane f for a 2D stack
// (slabs = 0); for slab s of 3D frame b (f = b * slabs + s) it is plane
// b * (slabs + 1) + s + 1, so that each 3D frame keeps its zero plane 0.
//
// Design.  The TPU kernels carried a running edge sum from one sequential
// grid step to the next; on the card blocks run in no order, so each scan
// direction becomes a loop inside one thread group instead:
//   * row scan: one warp per (frame, row).  The warp walks the row in
//     chunks of 32: an inclusive shuffle scan of the chunk plus the carry
//     from the previous chunk.  Loads and stores are coalesced.
//   * column scan: a block per (plane, 32 columns), a warp's lanes on
//     neighbouring columns so every row step is one coalesced load and
//     store.  The rows are cut into 32 groups: each thread scans its
//     group in place from zero, one warp per column scans the 32 group
//     totals, and each thread adds its group's offset.  A single running
//     sum down 512 rows would round at the frame total's magnitude on
//     every step; this way each entry sees at most one such rounding.
// The column scan takes any row stride (width), so K4 also runs it down
// the slab axis of a 3D Gamma, each "column" one (j, k) entry of a plane.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long plane_of(long long f, int slabs) {
  return slabs > 0 ? f + f / slabs + 1 : f;
}

template <typename T>
__global__ void row_scan_kernel(const T* __restrict__ a, T* __restrict__ g,
                                long long F, int rows, int cols, int slabs) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= F * rows) return;  // warp-uniform
  const long long f = r / rows, i = r % rows;
  const T* src = a + r * (long long)cols;
  T* dst = g + (plane_of(f, slabs) * (rows + 1) + i + 1) * (long long)(cols + 1);
  if (lane == 0) dst[0] = T(0);  // Gamma's zero column
  T carry = T(0);
  for (int j0 = 0; j0 < cols; j0 += 32) {
    const int j = j0 + lane;
    T v = j < cols ? src[j] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (j < cols) dst[1 + j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

template <typename T>
__global__ void col_scan_kernel(T* __restrict__ g, int rows, long long width,
                                long long colblocks, int slabs) {
  // block (32, 32): 32 columns of one plane; threadIdx.y is a group of
  // ceil(rows / 32) consecutive rows
  __shared__ T part[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long f = blockIdx.x / colblocks;
  const long long j = (blockIdx.x % colblocks) * 32 + tx;
  const bool live = j < width;
  T* col = g + plane_of(f, slabs) * (rows + 1) * width + j;
  const int per = (rows + 31) / 32;
  const int r0 = 1 + ty * per;
  const int r1 = min(r0 + per, rows + 1);
  // 1. scan of the group's rows, in place, from zero
  T acc = T(0);
  if (live) {
    if (ty == 0) col[0] = T(0);  // Gamma's zero row (zero plane in 3D)
    for (int i = r0; i < r1; ++i) {
      T* e = col + (long long)i * width;
      acc += *e;
      *e = acc;
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  // 2. warp ty scans the 32 group totals of column ty (lane = group) and
  //    leaves each group its exclusive offset
  {
    T s = part[tx][ty];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, s, off);
      if (tx >= off) s += u;
    }
    const T excl = __shfl_up_sync(0xffffffffu, s, 1);
    part[tx][ty] = tx == 0 ? T(0) : excl;
  }
  __syncthreads();
  // 3. add the offset to the group's rows
  const T offset = part[ty][tx];
  if (live && ty > 0) {
    for (int i = r0; i < r1; ++i) col[(long long)i * width] += offset;
  }
}

// Row scan then column scan of F frames of (rows, cols) into their Gamma
// planes (see plane_of).  Returns cudaErrorInvalidConfiguration where the
// grid would be too large for one launch.
template <typename T>
cudaError_t scan_planes(const T* a, T* g, long long F, int rows, int cols,
                        int slabs, cudaStream_t st) {
  const int warps = 8;
  const long long nrows = F * rows;
  const long long row_blocks = (nrows + warps - 1) / warps;
  const long long colblocks = (cols + 1 + 31) / 32;
  if (row_blocks > 0x7fffffffLL || F * colblocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (row_blocks > 0)
    row_scan_kernel<T><<<(unsigned)row_blocks, warps * 32, 0, st>>>(
        a, g, F, rows, cols, slabs);
  if (F > 0)
    col_scan_kernel<T><<<(unsigned)(F * colblocks), dim3(32, 32), 0, st>>>(
        g, rows, cols + 1, colblocks, slabs);
  return cudaSuccess;
}

// Column scan alone, down `rows` rows of `width` entries in each of F
// planes (slabs = 0: plane f).
template <typename T>
cudaError_t scan_columns(T* g, long long F, int rows, long long width,
                         cudaStream_t st) {
  const long long colblocks = (width + 31) / 32;
  if (F * colblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (F * colblocks > 0)
    col_scan_kernel<T><<<(unsigned)(F * colblocks), dim3(32, 32), 0, st>>>(
        g, rows, width, colblocks, 0);
  return cudaSuccess;
}

}  // namespace
