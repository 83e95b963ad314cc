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
// Design: the row scan and the grouped column scan of sat_scan.cuh, on a
// stack of B planes.  The accumulator is the input dtype, as in the TPU
// kernel (int32 on the exact path, float32 on the heuristic path).
// float32 sums are taken in another order than torch.cumsum's: below a
// frame total of 2**24 every partial sum is an exact integer and the two
// agree bit for bit; above it they may differ in the last places.

#include "sat_scan.cuh"

namespace {

template <typename T>
int gamma_launch(const T* a, T* g, int B, int n1, int n2, cudaStream_t st) {
  const cudaError_t e = scan_planes<T>(a, g, B, n1, n2, 0, st);
  if (e != cudaSuccess) return (int)e;
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
