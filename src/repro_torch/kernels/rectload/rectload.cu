// K3: loads of every rectangle of a jagged partition, from Gamma.
//
// Replaces the Pallas kernel src/repro/kernels/rectload/rectload.py::
// jagged_loads_pallas (_kernel).  For frame b, stripe s and interval q:
//   stripe(c) = G[b, rc[b, s+1], c] - G[b, rc[b, s], c]
//   out[b, s, q] = stripe(cc[b, s, q+1]) - stripe(cc[b, s, q])
//
// What bounds it on the card: bytes.  Each rectangle needs its cut and
// writes one float, and each distinct cut column two Gamma entries; only
// the entries the cuts touch are read, never the whole table.  One plan
// (32 stripes x 994 cuts, about 0.26 MB) is far below what a launch costs,
// so a single plan's time is the launch and two dependent memory round
// trips (the cuts, then Gamma).
//
// Design.  The TPU kernel turned the gather into a one-hot-difference
// matrix product on the MXU, because a TPU dislikes arbitrary gathers.
// The card gathers natively.  A warp takes one stripe of one frame and a
// run of 32 consecutive cut columns: it reads the stripe's two row cuts
// once, each lane reads one cut column (coalesced) and computes stripe(c),
// and a lane gets its right neighbour's value by a shuffle, so no shared
// memory and no barrier stand between the gathers and the stores.  Every
// cut column is read once, not twice, and Gamma is gathered 2 (Q+1) times
// per stripe, not 4Q; neighbouring runs share one column, so a run of 32
// columns gives 31 intervals, and one plan (32 stripes x 994 cuts) gets
// 288 blocks, more than the card has SMs.  The frame base is 64-bit; all
// other indexing is 32-bit and nothing is divided.
//
// Order and dtype.  The differences are taken in Gamma's own dtype, in
// the order above, and only the result is cast to float32: exactly
// jagged_loads_ref(...).astype(float32), the oracle's order
// (src/repro/kernels/rectload/ops.py), so this kernel is bit-identical to
// the plain version for every input.  int32 differences are taken in
// uint32, so they wrap as the plain version's int32 arithmetic does.  The
// TPU kernel instead casts Gamma to float32 first (rectload.py:74), so on
// an int32 Gamma above 2**24 it rounds differently from its own oracle;
// this port follows the oracle.  On the planner's main path the two agree
// anyway, because pricing and the migration receipt hand the kernel a
// float32 Gamma.
//
// A cut outside the Gamma gives NaN in the rectangles that touch it: a row
// cut in its whole stripe, a column cut in its two neighbouring intervals
// (the kernel reads nothing out of range); callers validate cuts before
// pricing.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;  // warps of a block; a warp takes one run
constexpr int kRun = 32;   // cut columns of a warp's run
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float diff(float a, float b) { return a - b; }
__device__ __forceinline__ int diff(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rectload_kernel(const T* __restrict__ g, const int* __restrict__ rc,
                const int* __restrict__ cc, float* __restrict__ out, int B,
                int n1p, int n2p, int P, int Qp1, int runs) {
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (run >= runs) return;  // the whole warp
  const int Q = Qp1 - 1;
  const int q = run * (kRun - 1) + lane;  // this lane's cut column
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const T* G = g + (long long)b * n1p * n2p;
    for (int s = blockIdx.y; s < P; s += gridDim.y) {
      const int bs = b * P + s;
      const int r0 = rc[bs + b], r1 = rc[bs + b + 1];
      const bool rows_ok = r0 >= 0 && r0 < n1p && r1 >= 0 && r1 < n1p;
      const int c = q < Qp1 ? cc[(long long)bs * Qp1 + q] : 0;
      const bool ok = rows_ok && c >= 0 && c < n2p;
      const T hi = ok ? G[(rows_ok ? r1 : 0) * n2p + c] : T(0);
      const T lo = ok ? G[(rows_ok ? r0 : 0) * n2p + c] : T(0);
      const T v = diff(hi, lo);
      // the next cut column's stripe value, from the lane to the right
      const T nv = __shfl_down_sync(kFull, v, 1);
      const int nok = __shfl_down_sync(kFull, (int)ok, 1);
      if (lane < kRun - 1 && q < Q)
        out[(long long)bs * Q + q] =
            ok && nok ? (float)diff(nv, v) : CUDART_NAN_F;
    }
  }
}

template <typename T>
int rectload_launch(const T* g, const int* rc, const int* cc, float* out,
                    int B, int n1p, int n2p, int P, int Qp1,
                    cudaStream_t st) {
  if (B > 0 && P > 0 && Qp1 > 1) {
    const int runs = (Qp1 - 2) / (kRun - 1) + 1;  // over Q = Qp1 - 1
    const dim3 grid((runs + kWarps - 1) / kWarps, P < 65535 ? P : 65535,
                    B < 65535 ? B : 65535);
    rectload_kernel<T><<<grid, kWarps * 32, 0, st>>>(g, rc, cc, out, B, n1p,
                                                      n2p, P, Qp1, runs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_rectload_f32(const void* g, const void* rc,
                                  const void* cc, void* out, int B, int n1p,
                                  int n2p, int P, int Qp1, void* stream) {
  return rectload_launch<float>(static_cast<const float*>(g),
                                static_cast<const int*>(rc),
                                static_cast<const int*>(cc),
                                static_cast<float*>(out), B, n1p, n2p, P, Qp1,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_rectload_i32(const void* g, const void* rc,
                                  const void* cc, void* out, int B, int n1p,
                                  int n2p, int P, int Qp1, void* stream) {
  return rectload_launch<int>(static_cast<const int*>(g),
                              static_cast<const int*>(rc),
                              static_cast<const int*>(cc),
                              static_cast<float*>(out), B, n1p, n2p, P, Qp1,
                              static_cast<cudaStream_t>(stream));
}
