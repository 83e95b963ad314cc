// K5: flash attention — online-softmax attention over (BH, S, d), with a
// causal mask, a sliding window, a tanh softcap and ragged lengths.
//
// Replaces the Pallas kernel src/repro/kernels/flash/flash.py::
// flash_attention (its body _kernel).  Same function: for each (bh, i)
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
// Design.  The TPU walked the kv axis as a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here one block of 128 threads owns one
// (query tile, bh) and loops over the key/value tiles itself: K and V
// tiles are staged in shared memory, m, l and acc stay in registers, and
// the output is written once.  The grid is (query tiles x BH) flattened
// into one dimension (BH reaches 16 x batch; a y dimension would stop at
// 65,535), heaviest query tiles first so the causal tail does not run
// alone.  There are no padded copies: rows past Sq and Skv are zero in
// shared memory and masked, and only Sq rows are written.  The key-tile
// loop starts at the first tile the window can reach and stops after the
// last tile the causal mask allows (the TPU's whole-tile skip, for this
// kernel's own tiles).
//
// Two instantiations:
//   * float32 (flash_fma_kernel): products by FMA on CUDA cores — no TF32,
//     no tensor cores — with expf and tanhf (no approximations, no
//     --use_fast_math), so it keeps tests/test_flash.py's 2e-5.  Thread
//     (tx, ty) of a 16 x 8 layout owns rows ty + 8i and key columns
//     tx + 16j of the score tile and output columns tx + 16j; p goes
//     through shared memory to the P.V product.
//   * bfloat16 (flash_mma_kernel): mma.sync m16n8k16 bf16 tensor-core
//     products with float32 accumulation; each of the 4 warps owns 16
//     query rows.  The score fragments become P.V's A fragments in
//     registers, so p is rounded to bf16 (8 bits of mantissa) before P.V
//     while l sums the float32 p: each output is a p-weighted mean of v
//     with weights off by at most 2**-9 relative, far inside the bf16
//     contract of 2e-2.  All bf16 <-> float conversions go through the
//     intrinsics (the build defines __CUDA_NO_BFLOAT16_CONVERSIONS__).
//     wgmma, TMA and warp specialisation are later work.
//
// Where trouble was expected:
//   * head dim up to 256 (Gemma-2).  Compiled widths D = 64, 128, 256;
//     a smaller d takes the next width with the columns past d zero in
//     shared memory and never written, so every 1 <= d <= 256 works (the
//     wrapper raises above 256).  At D = 256 the tiles pass 48 KB of
//     shared memory, so every launch first raises the kernel's dynamic
//     shared memory limit (cudaFuncSetAttribute; at most 227 KB).
//   * registers: a 64 x 256 float32 accumulator does not fit 128 threads.
//     The float32 kernel takes 32 query rows at D = 256 (64 accumulators
//     a thread); the bf16 kernel keeps 16 rows x 256 columns a warp (128
//     accumulators a thread) with 32-key tiles so the score fragments stay
//     small.
//   * a refused launch (shared memory, grid size) returns its
//     cudaGetLastError() code and the wrapper raises; it never returns
//     zeros.
//   * 16-byte global loads only when every pointer is 16-byte aligned and
//     d fills whole vectors; otherwise element loads.

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

extern "C" int repro_flash_attn_bf16(const void* q, const void* k,
                                     const void* v, void* o, int BH, int Sq,
                                     int Skv, int d, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  const Params p = make_params(q, k, v, o, BH, Sq, Skv, d, causal, window,
                               softcap, scale, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch_mma<64, 64>(p, st);
  if (d <= 128) return launch_mma<128, 64>(p, st);
  return launch_mma<256, 32>(p, st);
}
