// K1: the 2D summed-area table, written straight into the exclusive Gamma.
//
// Replaces the Pallas kernel src/repro/kernels/sat/sat.py::sat_pallas
// (_row_scan_kernel, _col_scan_kernel) plus the zero-border embedding of
// src/repro/kernels/sat/ref.py::gamma_from_sat, fused: the output is the
// (B, n1+1, n2+1) Gamma with its zero row and column.
//
// What bounds it on the card: bytes, one read of the frames and one write
// of Gamma (at (64, 512, 512) float32, 67.1 MB in and 67.4 MB out, 0.040
// ms at 3.35 TB/s); the operations are a few adds per entry.
//
// Design: "reduce, then scan" over bands of R rows (sat_scan.cuh): the
// reduce reads every band but the last and leaves the column sums above
// each band in scratch, float64 (uint32 for int32); the scan reads each
// band once more and writes its Gamma rows once, 16 x 256 tiles, three in
// flight.  At (64, 512, 512) with 4 bands of 128 rows it moves 192.7 MB,
// 1.43x the bound's bytes: 50.3 MB for the reduce, 7.9 MB of sums in
// scratch, 134.5 MB for the scan.  The row-then-column scans it replaces
// wrote and read Gamma three times, about 3x.
// int32: sums in uint32, which wrap mod 2**32 as torch.cumsum does; the
// int additions before overflowed, undefined behaviour in C++.
// float64: the same design at 8 bytes an entry, tiles of 16 x 128 (the
// same bytes as 16 x 256 of 4-byte entries), sums and carries in float64;
// at (64, 512, 512) it reads 134.2 MB and writes 134.7 MB, 0.0803 ms at
// 3.35 TB/s.

#include "sat_scan.cuh"

namespace {

template <typename T>
int gamma_launch(const T* a, T* g, void* scratch, int B, int n1, int n2,
                 int R, cudaStream_t st) {
  const Planes xp{(long long)n1 * n2, 0, n2, 0};
  const Planes gp{(long long)(n1 + 1) * (n2 + 1), 0, n2 + 1, 0};
  const cudaError_t e = gamma_planes<T>(
      a, xp, g, gp, B, n1, n2, R,
      static_cast<typename Sums<T>::Acc*>(scratch), st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: (B, (ceil(n1 / R) - 1) * ceil(R / 32), n2) float64 sums; R rows
// per band (ops.band_rows)
extern "C" int repro_sat_gamma_f32(const void* a, void* g, void* scratch,
                                   int B, int n1, int n2, int R,
                                   void* stream) {
  return gamma_launch<float>(static_cast<const float*>(a),
                             static_cast<float*>(g), scratch, B, n1, n2, R,
                             static_cast<cudaStream_t>(stream));
}

// scratch: as above, float64 sums
extern "C" int repro_sat_gamma_f64(const void* a, void* g, void* scratch,
                                   int B, int n1, int n2, int R,
                                   void* stream) {
  return gamma_launch<double>(static_cast<const double*>(a),
                              static_cast<double*>(g), scratch, B, n1, n2, R,
                              static_cast<cudaStream_t>(stream));
}

// scratch: as above, uint32 sums
extern "C" int repro_sat_gamma_i32(const void* a, void* g, void* scratch,
                                   int B, int n1, int n2, int R,
                                   void* stream) {
  return gamma_launch<int>(static_cast<const int*>(a), static_cast<int*>(g),
                           scratch, B, n1, n2, R,
                           static_cast<cudaStream_t>(stream));
}
