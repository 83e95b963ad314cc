// K3: loads of every rectangle of a jagged partition, from Gamma.
//
// Replaces the Pallas kernel src/repro/kernels/rectload/rectload.py::
// jagged_loads_pallas (_kernel).  For frame b, stripe s and interval q:
//   stripe(c) = G[b, rc[b, s+1], c] - G[b, rc[b, s], c]
//   out[b, s, q] = stripe(cc[b, s, q+1]) - stripe(cc[b, s, q])
//
// What bounds it on the card: bytes.  Each rectangle reads four Gamma
// entries and its cuts and writes one float; only the entries the cuts
// touch are read, never the whole table.
//
// Design.  The TPU kernel turned the gather into a one-hot-difference
// matrix product on the MXU, because a TPU dislikes arbitrary gathers.
// The card gathers natively: one thread per (b, s, q) does four gathers.
//
// Order and dtype.  The differences are taken in Gamma's own dtype, in
// the order above, and only the result is cast to float32: exactly
// jagged_loads_ref(...).astype(float32), the oracle's order
// (src/repro/kernels/rectload/ops.py), so this kernel is bit-identical to
// the plain version for every input.  The TPU kernel instead casts Gamma
// to float32 first (rectload.py:74), so on an int32 Gamma above 2**24 it
// rounds differently from its own oracle; this port follows the oracle.
// On the planner's main path the two agree anyway, because pricing and
// the migration receipt hand the kernel a float32 Gamma.
//
// A cut outside the Gamma gives NaN for its rectangle (the kernel reads
// nothing out of range); callers validate cuts before pricing.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <typename T>
__global__ void rectload_kernel(const T* __restrict__ g,
                                const int* __restrict__ rc,
                                const int* __restrict__ cc,
                                float* __restrict__ out, int B, int n1p,
                                int n2p, int P, int Qp1) {
  const int Q = Qp1 - 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P * Q) return;
  const int q = (int)(idx % Q);
  const long long bs = idx / Q;
  const int s = (int)(bs % P);
  const long long b = bs / P;
  const int r0 = rc[b * (P + 1) + s], r1 = rc[b * (P + 1) + s + 1];
  const int c0 = cc[bs * Qp1 + q], c1 = cc[bs * Qp1 + q + 1];
  if (r0 < 0 || r0 >= n1p || r1 < 0 || r1 >= n1p || c0 < 0 || c0 >= n2p ||
      c1 < 0 || c1 >= n2p) {
    out[idx] = CUDART_NAN_F;
    return;
  }
  const T* G = g + b * n1p * (long long)n2p;
  const T hi = G[(long long)r1 * n2p + c1] - G[(long long)r0 * n2p + c1];
  const T lo = G[(long long)r1 * n2p + c0] - G[(long long)r0 * n2p + c0];
  out[idx] = (float)(hi - lo);
}

template <typename T>
int rectload_launch(const T* g, const int* rc, const int* cc, float* out,
                    int B, int n1p, int n2p, int P, int Qp1,
                    cudaStream_t st) {
  const long long total = (long long)B * P * (Qp1 - 1);
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    rectload_kernel<T><<<blocks, threads, 0, st>>>(g, rc, cc, out, B, n1p,
                                                   n2p, P, Qp1);
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
