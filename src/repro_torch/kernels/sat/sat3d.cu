// K4: the 3D summed-area table, written straight into the exclusive Gamma3.
//
// Replaces the Pallas kernel src/repro/kernels/sat/sat3d.py::sat3_pallas
// (_scan3_kernel, _scan2_kernel, _scan1_kernel) plus the zero-border
// embedding of src/repro/kernels/sat/ref.py::gamma3_from_sat, fused: the
// output is the (B, n1+1, n2+1, n3+1) Gamma3 with its three zero planes.
//
// What bounds it on the card: bytes.  The least the work needs is one read
// of the input and one write of Gamma3 (at (16, 128, 128, 128) float32,
// 134.2 MB in and 137.4 MB out); the operations are a few adds per entry.
// This first version moves more than that: pass 1 writes Gamma3 and its
// column scan reads and writes it again, then pass 2 reads and writes it
// once more, about three times the bound's bytes.
//
// Design.  The TPU kernel walked each scan direction along a sequential
// grid axis with a carry in VMEM; on the card blocks run in no order, so
// the scans are loops inside thread groups (sat_scan.cuh):
//   * pass 1: a 2D summed-area table of every (frame, slab) plane — K1's
//     row scan (a warp per row, shuffle scans) and grouped column scan —
//     written into plane s + 1 of its frame's Gamma3;
//   * pass 2: the grouped column scan again, down the slab axis, with one
//     "column" per (frame, j, k) entry: neighbouring threads take
//     neighbouring k, so every slab step is a coalesced load and store.
//     The n1 slabs are cut into 32 groups scanned from zero, and each
//     entry gets one offset added.
// float32 accuracy above 2**24.  A frame total above 2**24 (the 3D PIC
// stream reaches 4.2e8 at 128^3) makes float32 partial sums round.  The
// grouped scans keep each entry to a few roundings at the total's
// magnitude (the 2D planner found one running sum down 512 rows 1.12e-6
// of the frame total off the exact prefix, above its 1e-6 limit).  On
// integer loads with a frame total below 2**24 every partial sum is an
// exact integer and the result is bit-identical to the plain version's
// cumsums.  The accumulator is the input dtype (int32 wraps as
// torch.cumsum does).

#include "sat_scan.cuh"

namespace {

template <typename T>
int gamma3_launch(const T* a, T* g, int B, int n1, int n2, int n3,
                  cudaStream_t st) {
  // pass 1: B * n1 planes of (n2, n3), slab s of frame b into plane
  // b * (n1 + 1) + s + 1
  cudaError_t e = scan_planes<T>(a, g, (long long)B * n1, n2, n3, n1, st);
  if (e != cudaSuccess) return (int)e;
  // pass 2: down the n1 slabs of each frame; row 0 is the zero plane
  e = scan_columns<T>(g, B, n1, (long long)(n2 + 1) * (n3 + 1), st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_sat3_gamma_f32(const void* a, void* g, int B, int n1,
                                    int n2, int n3, void* stream) {
  return gamma3_launch<float>(static_cast<const float*>(a),
                              static_cast<float*>(g), B, n1, n2, n3,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int repro_sat3_gamma_i32(const void* a, void* g, int B, int n1,
                                    int n2, int n3, void* stream) {
  return gamma3_launch<int>(static_cast<const int*>(a), static_cast<int*>(g),
                            B, n1, n2, n3, static_cast<cudaStream_t>(stream));
}
