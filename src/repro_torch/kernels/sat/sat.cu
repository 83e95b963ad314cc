// K1: the 2D summed-area table, written straight into the exclusive Gamma.
//
// Replaces the Pallas kernel src/repro/kernels/sat/sat.py::sat_pallas
// (_row_scan_kernel, _col_scan_kernel) plus the zero-border embedding of
// src/repro/kernels/sat/ref.py::gamma_from_sat, fused: the output is the
// (B, n1+1, n2+1) Gamma with its zero row and column.
//
// What bounds it on the card: bytes.  Each input element is read once and
// each Gamma entry written once by the row pass; the column pass reads
// and writes each entry twice (a few adds per element in all).
//
// Design.  The TPU kernel carried a running edge sum from one sequential
// grid step to the next; on the card blocks run in no order, so each scan
// direction becomes a loop inside one thread group instead:
//   * row pass: one warp per (frame, row).  The warp walks the row in
//     chunks of 32: an inclusive shuffle scan of the chunk plus the carry
//     from the previous chunk.  Loads and stores are coalesced.
//   * column pass: a block per (frame, 32 columns), a warp's lanes on
//     neighbouring columns so every row step is one coalesced load and
//     store.  The rows are cut into 32 groups: each thread scans its
//     group in place from zero, one warp per column scans the 32 group
//     totals, and each thread adds its group's offset.  A single running
//     sum down 512 rows would round at the frame total's magnitude on
//     every step; this way each entry sees at most one such rounding.
// The accumulator is the input dtype, as in the TPU kernel (int32 on the
// exact path, float32 on the heuristic path).  float32 sums are taken in
// another order than torch.cumsum's: below a frame total of 2**24 every
// partial sum is an exact integer and the two agree bit for bit; above it
// they may differ in the last places.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void row_scan_kernel(const T* __restrict__ a, T* __restrict__ g,
                                int B, int n1, int n2) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)B * n1) return;  // warp-uniform
  const long long b = row / n1, i = row % n1;
  const T* src = a + (b * n1 + i) * (long long)n2;
  T* dst = g + (b * (n1 + 1) + i + 1) * (long long)(n2 + 1);
  if (lane == 0) dst[0] = T(0);  // Gamma's zero column
  T carry = T(0);
  for (int j0 = 0; j0 < n2; j0 += 32) {
    const int j = j0 + lane;
    T v = j < n2 ? src[j] : T(0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (j < n2) dst[1 + j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

template <typename T>
__global__ void col_scan_kernel(T* __restrict__ g, int n1, int n2) {
  // block (32, 32): 32 columns of one frame; threadIdx.y is a group of
  // ceil(n1 / 32) consecutive rows
  __shared__ T part[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  const bool live = j <= n2;
  T* col = g + (long long)blockIdx.y * (n1 + 1) * (n2 + 1) + j;
  const int rows = (n1 + 31) / 32;
  const int r0 = 1 + ty * rows;
  const int r1 = min(r0 + rows, n1 + 1);
  // 1. scan of the group's rows, in place, from zero
  T acc = T(0);
  if (live) {
    if (ty == 0) col[0] = T(0);  // Gamma's zero row
    for (int i = r0; i < r1; ++i) {
      T* e = col + (long long)i * (n2 + 1);
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
    for (int i = r0; i < r1; ++i) col[(long long)i * (n2 + 1)] += offset;
  }
}

template <typename T>
int gamma_launch(const T* a, T* g, int B, int n1, int n2, cudaStream_t st) {
  const int warps = 8;
  const long long rows = (long long)B * n1;
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + warps - 1) / warps);
    row_scan_kernel<T><<<blocks, warps * 32, 0, st>>>(a, g, B, n1, n2);
  }
  dim3 grid((n2 + 1 + 31) / 32, B);
  col_scan_kernel<T><<<grid, dim3(32, 32), 0, st>>>(g, n1, n2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_sat_gamma_f32(const void* a, void* g, int B, int n1,
                                   int n2, void* stream) {
  return gamma_launch<float>(static_cast<const float*>(a),
                             static_cast<float*>(g), B, n1, n2,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int repro_sat_gamma_i32(const void* a, void* g, int B, int n1,
                                   int n2, void* stream) {
  return gamma_launch<int>(static_cast<const int*>(a), static_cast<int*>(g),
                           B, n1, n2, static_cast<cudaStream_t>(stream));
}
