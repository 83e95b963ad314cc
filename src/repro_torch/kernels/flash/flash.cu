// K5: flash attention — online-softmax attention over (BH, S, d), with a
// causal mask, a sliding window, a tanh softcap and ragged lengths.
//
// Replaces the Pallas kernel src/repro/kernels/flash/flash.py:94
// (flash_attention, its body _kernel).  Same function: for each (bh, i)
//   s_ij = q_i . k_j * scale;  s_ij = softcap * tanh(s_ij / softcap) if
//   softcap > 0;  kept where j < Skv, i < Sq, (j <= i if causal) and
//   (i - j < window if window > 0);  out_i = sum_j p_ij v_j / sum_j p_ij,
// accumulated in float32 and written in the input dtype.  The TPU
// kernel's subtle points are kept: masked scores are NEG_INF = -1e30 (not
// -inf); p is zeroed where masked after the exp, so a row that has seen no
// valid key yet adds nothing; corr = exp(m_prev - m_new); out = acc /
// max(l, 1e-30); whole key tiles that the mask empties are skipped.
//
// What bounds it on the card: operations.  4 * d operations per unmasked
// (i, j) pair (two products of 2 * d); against one read of q, k, v and one
// write of out in bf16 that is S / 4 operations per byte under a causal
// mask, 2,048 at S = 8192, far above the H100's bf16 ridge of about 295.
//
// Every kernel owns one (query tile, bh) and loops over the key tiles
// itself, with m, l and the output accumulator in registers; the TPU's
// sequential kv grid axis becomes that loop.  The grid is (query tiles x
// BH) flattened into one dimension (BH reaches 16 x batch; a y dimension
// would stop at 65,535), heaviest query tiles first so the causal tail
// does not run alone.  The key-tile loop starts at the first tile the
// window can reach and stops after the last tile the causal mask allows.
// No padded copies: rows past Sq and Skv arrive as zeros, and only Sq rows
// are written.
//
// Three kernels, chosen by dtype and shape in the C entry points:
//
// * bfloat16 on Hopper (flash_wgmma_kernel; launch key "flash"), for
//   d % 8 == 0 and 16-byte aligned tensors — what TMA can describe.  384
//   threads: one producer warpgroup (trimmed to 24 registers by
//   setmaxnreg; one thread issues every load) and two consumer warpgroups
//   (raised to 240), each owning 64 of the block's 128 query rows.
//   Against what held the mma.sync kernel back:
//   - synchronous staging: Q is loaded once per block, and K and V each
//     through a ring of 2 slots, all by TMA (cp.async.bulk.tensor on 3D
//     (d, S, BH) tensor maps encoded per call, 128-byte swizzle, rows and
//     columns out of bounds read as zeros); every slot has a full and an
//     empty mbarrier, and K's slot is freed once S is done, before P V,
//     so the loads of the next tiles overlap this tile's math and no
//     consumer thread spends an instruction on a copy;
//   - operands re-read from shared memory by the threads: S = Q K^T is
//     wgmma m64nBKk16 with Q and K both read by the tensor cores from
//     shared memory (K-major as stored, d contiguous), and O += P V is
//     wgmma with P from registers (the f32 score accumulators rounded to
//     bf16 A fragments: wgmma's accumulator layout per 8 columns is
//     mma.sync's m16n8 layout) and V from shared memory as the MN-major
//     B operand — no ldmatrix, no scalar fragment loads;
//   - mma.sync m16n8k16: replaced by wgmma, the only way to the card's
//     full tensor-core rate.  Each warpgroup issues S of tile i together
//     with P V of tile i - 1 and runs tile i's softmax while that P V
//     runs; the two warpgroups overlap each other on their own (an
//     explicit ping-pong on named barriers and a third ring slot were no
//     faster on an H100, so neither is here);
//   - a mask and an accurate expf/tanhf on every element: each key tile is
//     classified per warpgroup; only tiles that cross the causal diagonal,
//     the window's edge or the end of the keys evaluate keep(), interior
//     tiles skip it; log2(e) is folded into the scale, so p is one FMA and
//     one ex2.approx an element; under a softcap tanh is tanh.approx.f32,
//     one MUFU operation, held by chip_smoke.py's bf16 checks (including
//     the one that the softcap matters) at Gemma-2's widths;
//   - d = 256 occupancy: 64-key tiles, 128 + 32 accumulators and 16 P
//     registers a consumer thread within its 240, one block of 193 KB
//     shared memory an SM (Q 64 KB, K and V 2 x 32 KB each); d = 64 and
//     128 take 128-key tiles.
//   p is rounded to bf16 before P V while l sums the float32 p, as in the
//   mma.sync kernel below.  The epilogue writes acc / l as bf16 into the
//   warpgroup's own Q rows in the same swizzle and TMA stores them; TMA
//   writes no row past Sq and no column past d.
// * bfloat16, general (flash_mma_kernel; launch key "flash_mma"), for the
//   shapes TMA cannot describe (d % 8 != 0, an unaligned base, Skv = 0):
//   mma.sync m16n8k16 with float32 accumulation, 4 warps of 16 query rows,
//   K and V staged by the threads.  The score fragments become P V's A
//   fragments in registers, so p is rounded to bf16 (8 bits of mantissa)
//   before P V while l sums the float32 p: each output is a p-weighted
//   mean of v with weights off by at most 2**-9 relative, far inside the
//   bf16 contract of 2e-2.
// * float32 (flash_fma_kernel; launch key "flash_fma"): products by FMA on
//   CUDA cores — no TF32, no tensor cores — with expf and tanhf (no
//   approximations, no --use_fast_math), so it keeps tests/test_flash.py's
//   2e-5.  Thread (tx, ty) of a 16 x 8 layout owns rows ty + 8i and key
//   columns tx + 16j of the score tile and output columns tx + 16j; p goes
//   through shared memory to the P V product.
// All bf16 <-> float conversions go through the intrinsics (the build
// defines __CUDA_NO_BFLOAT16_CONVERSIONS__).
//
// Widths: compiled D = 64, 128, 256; a smaller d takes the next width
// with the columns past d zero in shared memory and never written, so
// every 1 <= d <= 256 works (the wrapper raises above 256).  Above 48 KB
// of shared memory every launch first raises the kernel's dynamic limit
// (cudaFuncSetAttribute; at most 227 KB).  A refused launch or tensor map
// returns a CUDA error code and the wrapper raises; it never returns
// zeros.
//
// nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -Xptxas -v (CUDA 12.9,
// on an NVIDIA H100 80GB HBM3), with the dynamic shared memory each launch
// asks for:
//   flash_wgmma_kernel<256>, <128>, <64>: 168 registers a thread at launch
//     (setmaxnreg then gives the producer 24 and the consumers 240), no
//     spills; 197,704, 164,936 and 83,016 bytes of shared memory;
//   flash_mma_kernel<256, 32>, <128, 64>, <64, 64>: 211, 167 and 128
//     registers (20 bytes of spill stores at <64, 64>); 67,584, 52,224 and
//     27,648 bytes;
//   flash_fma_kernel<256, 32, 32>, <128, 64, 32>, <64, 64, 64>: 158, 165
//     and 163 registers, no spills; 102,912, 74,496 and 66,560 bytes.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads a block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int BH, Sq, Skv, d, causal, window;
  float softcap, scale;
  int nq;   // query tiles
  int vec;  // 16-byte global loads allowed
};

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(bf16& x) {
  x = __ushort_as_bfloat16(0);
}

// block -> (query tile, bh), heaviest query tiles first
__device__ __forceinline__ void tile_of(const Params& p, int& qt, int& bh) {
  const int b = blockIdx.x;
  qt = p.nq - 1 - b / p.BH;
  bh = b % p.BH;
}

// key tiles [kb, ke) that hold a key some row of [q0, q0 + BQ) keeps
__device__ __forceinline__ void kv_range(const Params& p, int q0, int BQ,
                                         int BK, int& kb, int& ke) {
  kb = 0;
  ke = (p.Skv + BK - 1) / BK;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  if (p.causal) ke = min(ke, q_last / BK + 1);
  if (p.window > 0) {
    const int j_min = q0 - p.window + 1;  // first key row q0 keeps
    if (j_min > 0) kb = j_min / BK;
  }
}

__device__ __forceinline__ bool keep(const Params& p, int i, int j) {
  bool ok = i < p.Sq && j < p.Skv;
  if (p.causal) ok = ok && j <= i;
  if (p.window > 0) ok = ok && i - j < p.window;
  return ok;
}

__device__ __forceinline__ float logit(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// Rows [r0, r0 + ROWS) of a (len, d) matrix into s[ROWS][LD], zero past
// len and past d.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage(T* s, const T* g, int r0, int len,
                                      int d, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {  // d % VEC == 0 and g 16-byte aligned
    constexpr int CH = D / VEC;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
      const int r = idx / CH, c = (idx % CH) * VEC;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < len && c < d)
        u = *reinterpret_cast<const uint4*>(g + (long long)(r0 + r) * d + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < VEC; ++x) s[r * LD + c + x] = e[x];
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      T x;
      set_zero(x);
      if (r0 + r < len && c < d) x = g[(long long)(r0 + r) * d + c];
      s[r * LD + c] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NT) flash_fma_kernel(Params p) {
  constexpr int LD = D + 1, LP = BK + 1;  // odd strides: no bank conflicts
  constexpr int RM = BQ / 8, CN = BK / 16, DN = D / 16;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  const float* q = static_cast<const float*>(p.q) + (long long)bh * p.Sq * p.d;
  const float* k = static_cast<const float*>(p.k) + (long long)bh * p.Skv * p.d;
  const float* v = static_cast<const float*>(p.v) + (long long)bh * p.Skv * p.d;
  float* o = static_cast<float*>(p.o) + (long long)bh * p.Sq * p.d;
  stage<float, D, BQ, LD>(Qs, q, q0, p.Sq, p.d, p.vec);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  for (int kt = kb; kt < ke; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged; the last tile's K, V and P reads done
    stage<float, D, BK, LD>(Ks, k, k0, p.Skv, p.d, p.vec);
    stage<float, D, BK, LD>(Vs, v, k0, p.Skv, p.d, p.vec);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty + 8 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float x = keep(p, row, k0 + tx + 16 * j) ? logit(p, s[i][j])
                                                       : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = tx + 16 * j;
        float e = expf(s[i][j] - m_new);
        e = keep(p, row, k0 + col) ? e : 0.f;
        Ps[(ty + 8 * i) * LP + col] = e;
        ps += e;
      }
      l[i] = l[i] * corr + ps;  // this thread's share of the row sum
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty + 8 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + ty + 8 * i;
    if (row < p.Sq) {
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int col = tx + 16 * j;
        if (col < p.d) o[(long long)row * p.d + col] = acc[i][j] / lt;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16 tensor cores, float32 accumulation

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two consecutive bf16 in shared memory (the lower index in the low half)
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int BK>
__global__ void __launch_bounds__(NT) flash_mma_kernel(Params p) {
  constexpr int BQ = 64, LD = D + 8;  // 16-byte rows, conflict-free frags
  constexpr int NS = BK / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row, column pair
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  const bf16* q = static_cast<const bf16*>(p.q) + (long long)bh * p.Sq * p.d;
  const bf16* k = static_cast<const bf16*>(p.k) + (long long)bh * p.Skv * p.d;
  const bf16* v = static_cast<const bf16*>(p.v) + (long long)bh * p.Skv * p.d;
  bf16* o = static_cast<bf16*>(p.o) + (long long)bh * p.Sq * p.d;
  stage<bf16, D, BQ, LD>(Qs, q, q0, p.Sq, p.d, p.vec);

  // this thread's rows: r (fragment values 0, 1) and r + 8 (values 2, 3)
  const int r = warp * 16 + g;
  const int rows[2] = {q0 + r, q0 + r + 8};
  const int kd = (p.d + 15) / 16;  // k-steps of q.k that hold real columns
  float acc[NO][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  for (int kt = kb; kt < ke; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged; the last tile's K and V reads done
    stage<bf16, D, BK, LD>(Ks, k, k0, p.Skv, p.d, p.vec);
    stage<bf16, D, BK, LD>(Vs, v, k0, p.Skv, p.d, p.vec);
    __syncthreads();

    // S = Q K^T: s[j] is the 16 x 8 tile of keys k0 + 8j ..
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk < kd) {
        const bf16* qa = Qs + r * LD + kk * 16 + 2 * t;
        const uint32_t a0 = ld2(qa), a1 = ld2(qa + 8 * LD), a2 = ld2(qa + 8),
                       a3 = ld2(qa + 8 * LD + 8);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const bf16* kp = Ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(s[j], a0, a1, a2, a3, ld2(kp), ld2(kp + 8));
        }
      }
    }

    // online softmax on rows[0] (values 0, 1) and rows[1] (values 2, 3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        const float x = keep(p, rows[h], col) ? logit(p, s[j][e]) : NEG_INF;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 4 lanes of a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        const float pe = expf(s[j][e] - m[h]);
        s[j][e] = keep(p, rows[h], col) ? pe : 0.f;
        l[h] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V: score tiles 2kk and 2kk + 1 are P's A fragment of keys
    // 16kk .. 16kk + 15 (p rounded to bf16 here)
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t a0 = pack_f(s[2 * kk][0], s[2 * kk][1]),
                     a1 = pack_f(s[2 * kk][2], s[2 * kk][3]),
                     a2 = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                     a3 = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n * 8 < p.d) {
          const bf16* vp = Vs + (kk * 16 + 2 * t) * LD + n * 8 + g;
          mma_bf16(acc[n], a0, a1, a2, a3, pack(vp[0], vp[LD]),
                   pack(vp[8 * LD], vp[9 * LD]));
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = n * 8 + 2 * t + (e & 1);
      if (rows[h] < p.Sq && col < p.d)
        o[(long long)rows[h] * p.d + col] = __float2bfloat16(acc[n][e] / l[h]);
    }
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA ring, wgmma, one producer and two consumer
// warpgroups

namespace hop {

constexpr int NC = 2;                // consumer warpgroups, 64 rows each
constexpr int NTH = 128 * (NC + 1);  // and one producer warpgroup
constexpr int BQ = 64 * NC;
constexpr int ST = 2;                // K and V ring depth
constexpr float LOG2E = 1.4426950408889634f;

// key-tile rows by compiled head width
template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;
};

// shared memory: Q (BQ rows), the K and V rings, the barriers; every tile
// is stored as D / 64 chunks of (rows x 64) bf16, rows of 128 bytes in
// TMA's 128-byte swizzle, each chunk 1024-byte aligned
template <int D>
constexpr int smem_bytes() {
  return 2 * D * (BQ + 2 * ST * Tile<D>::BK) + 8 * (1 + 4 * ST) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity ``parity`` of ``bar`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 x rows) box of a (d, S, BH) tensor map into shared memory at
// ``dst``; completion is counted on ``bar`` (columns past d and rows past
// S arrive as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int row, int bh,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(row), "r"(bh),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at ``addr``:
// ``lbo`` and ``sbo`` in bytes (for K-major operands sbo is the stride of
// 8-row groups and lbo is unused; for MN-major ones lbo is the stride of
// 64-column chunks and sbo that of 8-row groups)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one MUFU operation (relative error about 2^-11); held by the bf16
// checks, including the one that the softcap matters
__device__ __forceinline__ float tanh_fast(float x) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// S = Q K^T, m64n64k16: A (Q) and B (K) K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// S = Q K^T, m64n128k16: A (Q) and B (K) K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// O += P V, m64n64k16: A (P) from registers, B (V) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V, m64n128k16: A (P) from registers, B (V) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V, m64n256k16: A (P) from registers, B (V) MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the compiler may not hoist what is computed from this value out of a loop
// (it would keep every loop-invariant wgmma descriptor live in registers)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// The K and V rings: slot i % ST of each, and barriers after Q's: K full,
// V full, K empty, V empty, ST of each.  phase(i) is the parity of the
// i-th use of a slot.
struct Ring {
  uint32_t bar;
  __device__ uint32_t kfull(int i) const { return bar + 8 * (1 + i % ST); }
  __device__ uint32_t vfull(int i) const {
    return bar + 8 * (1 + ST + i % ST);
  }
  __device__ uint32_t kempty(int i) const {
    return bar + 8 * (1 + 2 * ST + i % ST);
  }
  __device__ uint32_t vempty(int i) const {
    return bar + 8 * (1 + 3 * ST + i % ST);
  }
  static __device__ uint32_t phase(int i) { return (i / ST) & 1; }
};

// Online softmax of one score tile in place: sc holds q.k on entry and p
// on exit; m and l are updated and corr returned.  EDGE: the tile crosses
// the diagonal, the window's edge or the end of the keys, so keep() runs;
// CAP: the softcap.  Logits are in log2 units (log2(e) folded in).
template <int BK, bool EDGE, bool CAP>
__device__ __forceinline__ void softmax(const Params& p, float (&sc)[BK / 2],
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2],
                                        const int (&rows)[2], int k0, int t,
                                        float sl, float cs, float cl) {
  // where neither applies, the max is taken on the raw dots and p is one
  // FMA and one ex2 an element
  constexpr bool RAW = !EDGE && !CAP;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = sc[4 * j + e];
      if (CAP)
        x = cl * tanh_fast(x * cs);
      else if (EDGE)
        x *= sl;
      if (EDGE && !keep(p, rows[h], k0 + 8 * j + 2 * t + (e & 1)))
        x = NEG_INF;
      sc[4 * j + e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 lanes of a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    if (RAW) mx[h] *= sl;
    mx[h] = fmaxf(m[h], mx[h]);
    corr[h] = ex2(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float x = sc[4 * j + e];
      float pe = RAW ? ex2(fmaf(x, sl, -m[h])) : ex2(x - m[h]);
      if (EDGE && x == NEG_INF) pe = 0.f;
      sc[4 * j + e] = pe;
      l[h] += pe;
    }
}

template <int D>
__device__ __forceinline__ void consume(const Params& p,
                                        const CUtensorMap* to, int q0, int bh,
                                        int kb, int ke, uint32_t sQ,
                                        uint32_t sK, uint32_t sV,
                                        uint32_t bar) {
  constexpr int BK = Tile<D>::BK, CH = D / 64, KV = BK * D * 2;
  const Ring ring{bar};
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int r0 = q0 + 64 * wg;  // this warpgroup's first query row
  const int row = r0 + 16 * warp + lane / 4;
  const int rows[2] = {row, row + 8};
  const bool cap = p.softcap > 0.f;
  const float sl = p.scale * LOG2E;
  const float cs = p.scale / p.softcap, cl = p.softcap * LOG2E;
  float o[D / 2], sc[BK / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float corr[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  auto scores = [&](int i) {  // issue S = Q K_i^T over D / 16 slices
    const uint32_t qs = opaque(sQ + wg * 64 * 128);
    const uint32_t ks = sK + (i % ST) * KV;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, desc(qs + c * BQ * 128 + kk * 32, 16, 1024),
                 desc(ks + c * BK * 128 + kk * 32, 16, 1024),
                 (c | kk) != 0);
    wg_commit();
  };
  auto values = [&](int i) {  // issue O += P V_i over BK / 16 slices
    const uint32_t vs = sV + (i % ST) * KV;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc(vs + kk * 16 * 128, BK * 128, 1024));
    wg_commit();
  };
  auto soft = [&](int i) {
    const int k0 = (kb + i) * BK;
    const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > r0) ||
                      (p.window > 0 && r0 + 63 - k0 >= p.window);
    if (cap) {
      if (edge)
        softmax<BK, true, true>(p, sc, m, l, corr, rows, k0, t, sl, cs, cl);
      else
        softmax<BK, false, true>(p, sc, m, l, corr, rows, k0, t, sl, cs, cl);
    } else {
      // the max of the raw dots is the max of the logits only for a
      // positive scale: any other scale takes the path that scales first
      if (edge || !(sl > 0.f))
        softmax<BK, true, false>(p, sc, m, l, corr, rows, k0, t, sl, cs, cl);
      else
        softmax<BK, false, false>(p, sc, m, l, corr, rows, k0, t, sl, cs,
                                  cl);
    }
  };
  auto pack = [&]() {  // P's A fragments, p rounded to bf16: score tiles
    // 2kk and 2kk + 1 are the fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      pa[j / 2][2 * (j % 2)] = pack_f(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_f(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };
  auto hold_p = [&]() {  // P stays live until the wgmma reading it is done
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa[kk][x])::"memory");
  };

  const int n = ke - kb;
  mbar_wait(bar, 0);  // Q has landed
  if (n > 0) {
    // the first tile's S alone; then each step issues S of tile i and
    // P V of tile i - 1 together and runs tile i's softmax while P V runs
    mbar_wait(ring.kfull(0), ring.phase(0));
    wg_fence();
    scores(0);
    wg_wait<0>();
    fence_regs(sc);
    mbar_arrive(ring.kempty(0));
    soft(0);
    pack();
    for (int i = 1; i < n; ++i) {
      mbar_wait(ring.kfull(i), ring.phase(i));
      mbar_wait(ring.vfull(i - 1), ring.phase(i - 1));
      wg_fence();
      scores(i);
      values(i - 1);
      wg_wait<1>();  // S done, P V may still run
      fence_regs(sc);
      mbar_arrive(ring.kempty(i));
      soft(i);
      wg_wait<0>();
      fence_regs(o);
      hold_p();
      mbar_arrive(ring.vempty(i - 1));
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        o[4 * x] *= corr[0];
        o[4 * x + 1] *= corr[0];
        o[4 * x + 2] *= corr[1];
        o[4 * x + 3] *= corr[1];
      }
      pack();
    }
    mbar_wait(ring.vfull(n - 1), ring.phase(n - 1));
    fence_regs(o);
    wg_fence();
    values(n - 1);
    wg_wait<0>();
    fence_regs(o);
    hold_p();
    mbar_arrive(ring.vempty(n - 1));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  // Epilogue: acc / l as bf16 into this warpgroup's own Q rows (free now:
  // only its products read them), in the 128-byte swizzle, then one TMA
  // store a 64-column chunk; TMA writes no row past Sq, no column past d.
  const uint32_t so = sQ + wg * 64 * 128;
  const int r = 16 * warp + lane / 4;  // row within the warpgroup
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      const uint32_t at = so + (x / 8) * BQ * 128 + (r + 8 * h) * 128 +
                          ((x % 8) ^ ((r + 8 * h) % 8)) * 16 + t * 4;
      const uint32_t v2 = pack_f(o[4 * x + 2 * h] / l[h],
                                 o[4 * x + 2 * h + 1] / l[h]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v2)
                   : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
          " [%0, {%1, %2, %3}], [%4];\n" ::"l"(
              reinterpret_cast<uint64_t>(to)),
          "r"(64 * c), "r"(r0), "r"(bh), "r"(so + c * BQ * 128)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_wgmma_kernel(const __grid_constant__ Params p,
                       const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to) {
  constexpr int BK = Tile<D>::BK, CH = D / 64;
  constexpr uint32_t KV = BK * D * 2;
  extern __shared__ unsigned char smem_h[];
  const uint32_t sQ = (smem_u32(smem_h) + 1023u) & ~1023u;
  const uint32_t sK = sQ + BQ * D * 2, sV = sK + ST * KV;
  const uint32_t bar = sV + ST * KV;  // Q full, then the rings'
  const Ring ring{bar};
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ring.kfull(s), 1);
      mbar_init(ring.vfull(s), 1);
      mbar_init(ring.kempty(s), 128 * NC);
      mbar_init(ring.vempty(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {  // producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 128 * NC) {
      mbar_expect_tx(bar, BQ * D * 2);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load(sQ + c * BQ * 128, &tq, 64 * c, q0, bh, bar);
      for (int i = 0; i < ke - kb; ++i) {
        const int row = (kb + i) * BK;
        const uint32_t ks = sK + (i % ST) * KV;
        const uint32_t vs = sV + (i % ST) * KV;
        mbar_wait(ring.kempty(i), ring.phase(i) ^ 1);
        mbar_expect_tx(ring.kfull(i), KV);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(ks + c * BK * 128, &tk, 64 * c, row, bh, ring.kfull(i));
        mbar_wait(ring.vempty(i), ring.phase(i) ^ 1);
        mbar_expect_tx(ring.vfull(i), KV);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load(vs + c * BK * 128, &tv, 64 * c, row, bh, ring.vfull(i));
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(p, &to, q0, bh, kb, ke, sQ, sK, sV, bar);
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                                  &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// the (d, S, BH) bf16 tensor at ``ptr`` in boxes of 64 columns x ``rows``,
// 128-byte swizzle; loads read zeros out of bounds, stores skip it
bool encode(CUtensorMap* map, const void* ptr, int d, int S, int BH,
            int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.BH;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, p.q, p.d, p.Sq, p.BH, BQ) ||
      !encode(&tk, p.k, p.d, p.Skv, p.BH, Tile<D>::BK) ||
      !encode(&tv, p.v, p.d, p.Skv, p.BH, Tile<D>::BK) ||
      !encode(&to, p.o, p.d, p.Sq, p.BH, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  flash_wgmma_kernel<D><<<(unsigned)blocks, NTH, smem, st>>>(p, tq, tk, tv,
                                                              to);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ---------------------------------------------------------------------------
// launch

template <typename K>
int launch(K kernel, int BQ, int smem, Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.BH;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int BK>
int launch_fma(const Params& p, cudaStream_t st) {
  const int smem = ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4;
  return launch(flash_fma_kernel<D, BQ, BK>, BQ, smem, p, st);
}

template <int D, int BK>
int launch_mma(const Params& p, cudaStream_t st) {
  const int smem = (64 + 2 * BK) * (D + 8) * 2;
  return launch(flash_mma_kernel<D, BK>, 64, smem, p, st);
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Skv, int d, int causal, int window,
                   float softcap, float scale, int elem_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.BH = BH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.nq = 0;
  p.vec = (addr % 16 == 0) && (d % (16 / elem_bytes) == 0);
  return p;
}

}  // namespace

extern "C" int repro_flash_attn_f32(const void* q, const void* k,
                                    const void* v, void* o, int BH, int Sq,
                                    int Skv, int d, int causal, int window,
                                    float softcap, float scale,
                                    void* stream) {
  const Params p = make_params(q, k, v, o, BH, Sq, Skv, d, causal, window,
                               softcap, scale, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch_fma<64, 64, 64>(p, st);
  if (d <= 128) return launch_fma<128, 64, 32>(p, st);
  return launch_fma<256, 32, 32>(p, st);
}

// The bf16 entry point returns 0 after launching the Hopper kernel and
// -1 after launching the general mma.sync kernel (the wrapper counts the
// launch under that kernel's key), or a CUDA error code.  The Hopper
// kernel takes what TMA can describe: 16-byte aligned bases, rows of a
// multiple of 16 bytes (d % 8 == 0) and at least one key row; the general
// kernel takes the rest.  A choice by shape, not a fallback.
extern "C" int repro_flash_attn_bf16(const void* q, const void* k,
                                     const void* v, void* o, int BH, int Sq,
                                     int Skv, int d, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  const Params p = make_params(q, k, v, o, BH, Sq, Skv, d, causal, window,
                               softcap, scale, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (d % 8 == 0 && addr % 16 == 0 && Skv > 0) {
    if (d <= 64) return hop::launch<64>(p, st);
    if (d <= 128) return hop::launch<128>(p, st);
    return hop::launch<256>(p, st);
  }
  const int e = d <= 64    ? launch_mma<64, 64>(p, st)
                : d <= 128 ? launch_mma<128, 64>(p, st)
                           : launch_mma<256, 32>(p, st);
  return e != 0 ? e : -1;
}
