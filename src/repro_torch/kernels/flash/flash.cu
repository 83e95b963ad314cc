// K5: flash attention — online-softmax attention over (BH, S, d), with a
// causal mask, a sliding window, a tanh softcap and ragged lengths.
//
// Replaces the Pallas kernel src/repro/kernels/flash/flash.py:94
// (flash_attention, its body _kernel).  Same function: for each (bh, i)
//   s_ij = q_i . k_j * scale;  s_ij = softcap * tanh(s_ij / softcap) if
//   softcap > 0;  kept where j < Skv, i < Sq, (j <= i if causal) and
//   (i - j < window if window > 0);  out_i = sum_j p_ij v_j / sum_j p_ij,
// accumulated in float32 and written in the input dtype (float32,
// bfloat16 or float16; any d >= 1, as the reference takes).  The TPU
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
// Every kernel owns one (query tile, bh) (the general wide kernel one
// output slice of it; a cluster kernel's block one share of d's columns,
// its cluster the whole tile) and loops over the key tiles itself, with
// m, l and the output accumulator in registers; the TPU's sequential kv
// grid axis becomes that loop.  The grid is (query tiles x BH) flattened into one
// dimension (BH reaches 16 x batch; a y dimension would stop at 65,535),
// heaviest query tiles first so the causal tail does not run alone.  The
// key-tile loop starts at the first tile the window can reach and stops
// after the last tile the causal mask allows.
// No padded copies here: rows past Sq and Skv arrive as zeros, and only Sq
// rows are written.  (Above d = 256 the wrapper, ops.flash_attention, may
// copy a tensor into padded, aligned scratch first: realign.cu.)
//
// Eight kernels, chosen by dtype and shape in the C entry points; above
// d = 256 four routes, the third one the wrapper's:
//   flash_wide  d <= 576, 16-byte aligned bases, d % 8 == 0, Skv > 0
//               (tma_shape): flash_wide_wgmma_kernel<T> at 16 bits,
//               flash_wide_f32_kernel at float32;
//   flash_wide_cluster  the same shapes with 576 < d <= CLUSTER_MAXD
//               (4096): flash_wide_cluster_kernel<T> at 16 bits,
//               flash_wide_cluster_f32_kernel at float32;
//   flash_realign, then flash_wide or flash_wide_cluster: the other
//               shapes with Skv > 0 and d <= 4096 after padding d to a
//               multiple of 8: the wrapper copies each tensor TMA cannot
//               describe into aligned scratch of that width (realign.cu)
//               and calls this entry point on it, which takes a kernel by
//               the rules above;
//   flash_wide_general  the rest, d > 4096 and Skv = 0:
//               flash_wide_kernel<T> at every dtype.
//
// * bfloat16 and float16 on Hopper (flash_wgmma_kernel<T, D>; launch keys
//   "flash" and "flash_f16"), for d <= 256, d % 8 == 0 and 16-byte aligned
//   tensors — what TMA can describe.  The two types share the code: the
//   wgmma instructions' operand type (.bf16 or .f16), the tensor maps'
//   element type, P's rounding and the epilogue's stores follow T.  384
//   threads: one producer warpgroup (trimmed to 24 registers by
//   setmaxnreg; one thread issues every load) and two consumer warpgroups
//   (raised to 240), each owning 64 of the block's 128 query rows.
//   - staging: Q is loaded once per block, and K and V each through a ring
//     of 2 slots, all by TMA (cp.async.bulk.tensor on 3D (d, S, BH) tensor
//     maps encoded per call, 128-byte swizzle, rows and columns out of
//     bounds read as zeros); every slot has a full and an empty mbarrier,
//     and K's slot is freed once S is done, before P V, so the loads of the
//     next tiles overlap this tile's math and no consumer thread spends an
//     instruction on a copy;
//   - products (consume<T, D>, shared with the general kernel): S = Q K^T
//     is wgmma m64nBKk16 with Q and K both read by the tensor cores from
//     shared memory (K-major as stored, d contiguous), and O += P V is
//     wgmma with P from registers (the f32 score accumulators rounded to
//     bf16 A fragments: wgmma's accumulator layout per 8 columns is
//     mma.sync's m16n8 layout; float16 A fragments at float16) and V
//     from shared memory as the MN-major
//     B operand.  Each warpgroup issues S of tile i together with P V of
//     tile i - 1 and runs tile i's softmax while that P V runs; the two
//     warpgroups overlap each other on their own (an explicit ping-pong on
//     named barriers and a third ring slot were no faster on an H100);
//   - the mask and the exponentials: each key tile is classified per
//     warpgroup; only tiles that cross the causal diagonal, the window's
//     edge or the end of the keys evaluate keep(), interior tiles skip it;
//     log2(e) is folded into the scale, so p is one FMA and one ex2.approx
//     an element; under a softcap tanh is, at bf16, tanh.approx.f32, one
//     MUFU operation, held by chip_smoke.py's bf16 checks (including the
//     one that the softcap matters) at Gemma-2's widths; at float16
//     1 - 2 / (2^(2x log2(e)) + 1) by ex2.approx and a fast division, two
//     MUFU operations (tanh.approx's 2^-11 moves a logit of 50 by 0.025,
//     past float16's contract);
//   - d = 256: 64-key tiles, 128 + 32 accumulators and 16 P registers a
//     consumer thread, one block of 193 KB shared memory an SM (Q 64 KB,
//     K and V 2 x 32 KB each); d = 64 and 128 take 128-key tiles.
//   p is rounded to T before P V while l sums the float32 p: each output
//   is a p-weighted mean of v with weights off by at most 2**-9 relative
//   at bf16 (8 bits of mantissa), far inside its contract of 2e-2, and
//   2**-11 at float16 (11 bits), inside its 5e-3
//   (tests/test_torch_flash.py emulates both against the plain version).
//   The epilogue writes acc / l as T into the warpgroup's own Q rows in the
//   same swizzle and TMA stores them; TMA writes no row past Sq and no
//   column past d.
// * bfloat16 and float16, general (flash_general_kernel<T, D>; launch
//   keys "flash_general" and "flash_f16_general"), for the shapes up to
//   d = 256 that TMA cannot describe (d % 8 != 0, a base that is not
//   16-byte aligned, Skv = 0): the same consumer warpgroups, tiles, ring
//   and shared-memory layout, behind a producer warpgroup of 128 threads
//   (setmaxnreg 56 for the producer, 224 for the consumers: 128 x 56 +
//   256 x 224 = 168 x 384, the registers at launch).  A bf16 row may start
//   (or float16 one) at any even byte, and when d % 8 != 0 the offset
//   changes from row to
//   row, so no 16-byte load of a row's elements is aligned.  The rows of
//   a piece (up to 32 KB: the whole K or V tile at d <= 128, half of it
//   at d = 256; Q in 1-4 pieces) are contiguous in global memory: one
//   thread copies the 16-byte segments that hold the piece's bytes (and
//   no segment that holds none, so every read stays inside the
//   allocation) by one cp.async.bulk into a raw staging slot, counted on
//   the slot's mbarrier; 2 slots at d = 128 (the next piece's copy runs
//   while this one is realigned), 1 at d = 256, 4 at d = 64, as shared
//   memory allows.  Then each producer thread takes 16-byte units (row,
//   8 columns): two aligned 16-byte shared loads, a shift by the row's
//   offset in registers, and one 16-byte store in TMA's 128-byte swizzle,
//   columns past d and rows past Sq / Skv zeroed as TMA's out-of-bounds
//   fill does.  Where d % 8 == 0 every row has the base's offset, so the
//   shift is one of four compiled variants (a constant word shift, then
//   four funnel shifts) and a thread keeps one column unit for the whole
//   piece; elsewhere each unit selects its words by its own offset.  The
//   loads of 2 units are issued before their shifts.  Every producer
//   thread runs fence.proxy.async.shared::cta after its stores (wgmma
//   reads shared memory through the async proxy), the threads meet on a
//   named barrier (the staging slot is free again), and each arrives on
//   the tile's full mbarrier, which counts 128 arrivals.  The epilogue
//   stores acc / l from the registers (o may be unaligned: 4-byte stores
//   where a column pair is 4-byte aligned, else 2-byte), no row past Sq,
//   no column past d; Skv = 0 leaves l = 0 and writes zeros, as the plain
//   version's acc / max(l, 1e-30) does.
// * float32 up to d = 256 (flash_f32_kernel; launch key "flash_f32"):
//   both products on
//   the tensor cores in 3xTF32.  Each float32 operand x is split in
//   registers into hi = rna(x) and lo = rna(x - hi), rna rounding to tf32
//   as cvt.rna.tf32.f32 does (to nearest, ties away from zero) in two
//   integer operations (cvt.rna itself compiles to several), and
//   a b is summed as lo(a) hi(b) + hi(a) lo(b), then hi(a) hi(b), in
//   float32 accumulators (the dropped lo x lo term is about 2**-22
//   relative; tests/test_torch_flash.py emulates the design against the
//   plain version at 2e-5 and a relative L2 of 1e-5).  Each 8-wide
//   slice's three products go into fresh accumulators, added to S (or O)
//   rounded to nearest: the tensor cores' float32 sums do not round to
//   nearest, and summed there over a whole row (S at d = 256: 96
//   products) outputs were 5.2e-5 off float64 at Gemma-2's softcap with
//   logits near 40, 8.3e-6 with the fresh sums, which cost 6% (an H100).
//   4 warps, each
//   owning 16 of the block's 64 query rows; K and V through a ring of 2
//   slots staged by cp.async (16-byte copies where the bases are 16-byte
//   aligned and d % 4 == 0, 4-byte copies elsewhere: a float32 base is
//   always 4-byte aligned), so the next tile's copies overlap this tile's
//   math; 64-key tiles at d <= 64, 32-key tiles above (shared memory at
//   d = 256: Q 66 KB, K and V 2 x 33 KB each).  The products are
//   mma.sync m16n8k8 tf32, not wgmma: wgmma reads a tf32 operand from
//   shared memory as it is stored, so 3xTF32 by wgmma needs the hi and lo
//   halves of Q and K as four shared-memory tiles (Q's alone 132 KB at
//   d = 256, beside the ring) and V stored transposed (wgmma takes tf32
//   only K-major), while mma.sync takes fragments from registers, where
//   the split costs five instructions an element and no shared memory.
//   (32-key tiles and 2 blocks of 4 warps an SM were the fastest of the
//   tilings tried on an H100; the splits are most of its instructions.)
//   Within each 8-wide slice of a product's sum the fragments' k index t
//   stands for element 2t and t + 4 for 2t + 1 (the same in A and B, so
//   the sum is unchanged): Q's and K's fragment pairs are then one 64-bit
//   load each, and S's accumulators are P's A fragments as they stand, so
//   p never leaves the registers and V's B fragment reads rows 2t and
//   2t + 1 of the V tile (rows padded to d + 4 floats: no bank conflicts).
//   Tiles are classified per warp as in the Hopper kernel; a warp skips a
//   tile its rows keep no key of.  expf and tanhf (no approximations, no
//   --use_fast_math).
// * d > 256 at 16 bits where TMA can describe the tensors (d % 8 == 0,
//   16-byte aligned bases, Skv > 0) and d <= 576
//   (flash_wide_wgmma_kernel<T>; launch key "flash_wide"): one block a
//   64-row query tile of one bh with every output column, so that
//   S = Q K^T is computed once a key tile for all of them: the bound's
//   4 d operations a pair.  384 threads: a producer warpgroup (24
//   registers; one thread loads Q once and then streams K, another
//   streams V, by TMA in boxes of 64 rows x 64 columns, 128-byte
//   swizzle) and two consumer warpgroups (240 registers), which share
//   the tile's work by d, not by keys: warpgroup 0 computes S over
//   chunks [0, ceil(CH / 2)) of the CH 64-column chunks, warpgroup 1
//   over the rest, each for all 64 keys (wgmma m64n64k16 with Q,
//   resident in shared memory, and K's boxes both read by the tensor
//   cores); each writes its float32 partial S to shared memory (32
//   floats a thread), the two meet on a named barrier and each adds the
//   other's, so both hold the same S (the sum commutes) and run the same
//   online softmax (the Hopper kernel's, tiles of 64 keys), with no
//   exchange of maxima, l or P.  P stays in registers as the A operand
//   of O += P V (wgmma with V's boxes MN-major), each warpgroup on its
//   own output chunks: warpgroup 0 chunks [0, floor(CH / 2)), warpgroup 1
//   the rest, so each does CH chunks' products a tile (d = 576: S over 5
//   and 4 chunks, O on 4 and 5; 160 accumulators at most).  Q takes 72
//   KB at d = 576; K streams through a ring of 6 boxes, each freed as
//   soon as its product is done (one chunk's product in flight while the
//   next issues); V through a ring of a whole tile's 9 boxes (a
//   warpgroup's P V waits for all its boxes at once, and a smaller ring
//   would wait on the other warpgroup's release behind the exchange's
//   barrier); the partial sums 32 KB; a named barrier pair tells a
//   warpgroup that the other has read its last partial.  Each step
//   issues S of tile i, then P V of tile i - 1, and runs tile i's
//   exchange and softmax while P V runs.  Sharing the tile's keys instead
//   (each warpgroup S of 32 keys over the whole d, m64n32; the row
//   maxima, P and l exchanged) ran 4-7% slower on an H100: Q's reads by
//   the tensor cores fall from 216 to 144 KB a tile with the split by d
//   (PERF.md).  The tile range skips the key tiles the mask empties; no
//   tile inside it is empty for the whole block.  The epilogue writes
//   acc / l as T from the registers, a column pair a 4-byte store.
// * d > 256 at float32 where the same shapes hold and d <= 576
//   (flash_wide_f32_kernel; launch key "flash_wide"): one block a 64-row
//   query tile with every output column, 12 warps: warp w owns rows
//   16 (w % 4) .. + 15 and output slice w / 4 (three slices, 192 columns
//   and 96 accumulators a thread at d = 576).  A key tile has 96 keys,
//   and each warp computes S for its rows and 32 of them, so the three
//   warps of a row group share the tile's keys and S is computed once;
//   3xTF32 on mma.sync m16n8k8 as flash_f32_kernel, each 8-wide slice's
//   three products in fresh accumulators added to S or O rounded to
//   nearest (P22).  The row group's maxima and P (float32) meet in
//   shared memory behind a named barrier of its 3 warps; each warp adds
//   P V on its slice, the splits of Q and K paid twice a pair, not four
//   times.  Q and K stream in chunks of 64 columns and V in 32 rows of
//   every column a step, by 16-byte cp.async through 2 slots of 74 KB,
//   one __syncthreads a step (a resident Q would take 147 KB).  A warp
//   skips its S of a tile where its rows keep none of its keys, its P V
//   where they keep none of the tile's.
// * 576 < d <= 4096 where the same shapes hold, every dtype
//   (flash_wide_cluster_kernel<T>, flash_wide_cluster_f32_kernel; launch
//   key "flash_wide_cluster"): what one SM cannot hold (at d = 640 Q and
//   a whole V tile alone take 160 KB at 16 bits), spread over a
//   thread-block cluster of C blocks a query tile (cudaLaunchKernelEx
//   with a cluster dimension; C the fewest blocks whose shares hold NB =
//   8 chunks each, at most 8, a portable cluster: 2 at d = 640 and 1024,
//   3 at 1032, 4 at 2048; at 16 bits 6 and 7 are taken as 8, whose
//   reduce-scatter slots fit; cudaOccupancyMaxActiveClusters checks that
//   a cluster can be placed, and a refusal returns its error).  Block r
//   owns d's 64-column chunks [r CH / C, (r + 1) CH / C) and is
//   flash_wide's block on them: it loads only its columns of Q, K and V,
//   writes only its columns of O, and computes its partial S of each key
//   tile over them (at 16 bits its two warpgroups' halves added through
//   shared memory, as flash_wide's).  The cluster then sums the partials
//   through distributed shared memory (namespace cl), by st.async stores
//   of 16 bytes into a peer's shared memory, counted in bytes on the
//   peer's mbarrier, whose waiters acquire at cluster scope.  A cluster of
//   2 at 16 bits in one round: each block sends its partial to the other
//   into one of two tiles' buffers, and every thread adds the two in rank
//   order itself.  Wider clusters (and float32) in two: each thread holds
//   its scores in units of 4 (8 units a thread of a warpgroup at 16 bits,
//   4 a lane at float32), dealt to the blocks in ranges; each block sends
//   each unit it does not own to its owner's slot for the sender (the
//   reduce-scatter); the owner adds the C partials of its units in
//   ascending rank (at 16 bits the warpgroup of the unit's half) and
//   sends the sum to every block (the all-gather).  Each score is summed
//   in one order, so every block holds the same S bit for bit and runs
//   the same online softmax (redundantly, on the whole tile) before P V on
//   its own columns: S computed once, not once a slice, and Q, K, V and O
//   each cross device memory once.  One buffer a round suffices for two
//   rounds (two tiles' buffers for one): a block sends tile i's partials
//   only after it has every block's tile i - 1 sums (or partials), which
//   each block sends only after reading its tile i - 1 slots (at 16 bits
//   its two warpgroups meet on the in-block exchange's barrier between);
//   a slot a thread reads is read, and its sum sent, by the same thread.
//   A cluster barrier (barrier.cluster) after the mbarriers'
//   initialisation and one before a block exits.  Shared memory at 16
//   bits: Q 8 boxes, the K ring 4, the V ring 8 (a whole tile's share),
//   the in-block exchange 32 KB, the exchange 32 KB (230,616 bytes; K's
//   ring of 4 makes the room); a warpgroup holds O on at most 4 chunks
//   (128 accumulators).  At float32 fw's 2 slots with V rows of at most
//   512 columns and P, then 24 KB of slots and 24 KB of gathered S
//   (208,656 bytes).
// * d > 256, every dtype, every shape the three above do not take: bases
//   not 16-byte aligned, d % 8 != 0, Skv = 0, d > 4096; through the
//   wrapper's route only d > 4096 after padding and Skv = 0, the rest
//   reaching flash_wide or flash_wide_cluster on realigned scratch
//   (flash_wide_kernel<T>; launch key "flash_wide_general"): what no
//   register tile of the others holds (an output row of d float32
//   accumulators).  8 warps, each owning 16 of the block's 128 query
//   rows (4 warps a block, 2 blocks an SM, ran 4% slower on an H100);
//   a block computes one output slice of at most 256 columns (the slices
//   balanced: ceil(d / 256) of them, d = 576 as 3 x 192), so its
//   accumulators are those of a d = 256 tile.  Q and K stream through a
//   ring of 2 slots in chunks of 64 columns (a Q chunk and a K chunk a
//   slot), V's slice through one slot, all by cp.async (16-byte copies
//   where the bases are 16-byte aligned and d is a multiple of 16 bytes;
//   else 4-byte copies at float32 and 2-byte loads and stores through the
//   registers at 16 bits): shared memory does not depend on d (89,088
//   bytes at 16 bits, 125,440 at float32; one block an SM, as its 255
//   registers a thread allow).  Step j = (key
//   tile, chunk) computes while step j + 1's copies are in flight, one
//   barrier a step; a tile's V slice is issued at its first step, nc - 1
//   steps before its P V.  S sums in registers over a tile's chunks,
//   then the online softmax (expf, tanhf, as flash_f32_kernel) and
//   O += P V_slice.  The products: at 16 bits mma.sync m16n8k16 with
//   float32 accumulators (Q's and K's fragments by ldmatrix, V's B
//   fragments transposed by ldmatrix.trans, P's A fragments S's
//   accumulators rounded to T); at
//   float32 flash_f32_kernel's 3xTF32 on m16n8k8, each 8-column slice of
//   S into fresh accumulators then added rounded to nearest (the tensor
//   cores' float32 sums truncate: over a long chain that bias passes
//   float32's contract).  The cost of the slices: S = Q K^T is recomputed
//   for each, ns = ceil(d / 256) times the product, so 2 d (ns + 1)
//   operations a pair instead of 4 d (2x at d = 576).  Key tiles of 64
//   (32 at float32); a warp skips a tile its rows keep no key of.
// All bf16 and float16 <-> float conversions go through the intrinsics
// (the build defines __CUDA_NO_BFLOAT16_CONVERSIONS__ and
// __CUDA_NO_HALF_CONVERSIONS__).
//
// Widths: compiled D = 64, 128, 256; a smaller d takes the next width
// with the columns past d zero in shared memory and never written, so
// every 1 <= d <= 256 works; above 256 the wide kernels take any d up to
// 576 in 64-column chunks (columns past d zero), the cluster kernels up to
// 4096 likewise, the general wide kernel any d (its columns past d zero,
// its last slice narrower).  Above 48 KB
// of shared memory every launch first raises the kernel's dynamic limit
// (cudaFuncSetAttribute; at most 227 KB).  A refused launch or tensor map
// returns a CUDA error code and the wrapper raises; it never returns
// zeros.
//
// nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -Xptxas -v (CUDA 12.9,
// on an NVIDIA H100 80GB HBM3), with the dynamic shared memory each launch
// asks for:
//   flash_wgmma_kernel<T, 256>, <T, 128>, <T, 64>, T bf16 and float16:
//     168 registers a thread at launch (setmaxnreg then gives the
//     producer 24 and the consumers 240), no spills; 197,704, 164,936 and
//     83,016 bytes of shared memory (bf16: the parent commit's SASS,
//     kernels/flash/compare.py);
//   flash_general_kernel<T, 256>, <T, 128>, <T, 64>, T bf16 and float16:
//     168 registers a thread at launch (setmaxnreg then gives the producer
//     56 and the consumers 224), no spills; 230,512, 230,552 and 148,712
//     bytes (bf16: the parent's SASS);
//   flash_f32_kernel<256>, <128>, <64>: 233, 162 and 128 registers, no
//     spills; 201,728, 103,424 and 90,112 bytes;
//   flash_wide_wgmma_kernel<T>, T bf16 and float16: 168 registers a
//     thread at launch (setmaxnreg then gives the producer 24 and the
//     consumers 240), 4 bytes of spill stores and 16 of spill loads a
//     thread; 230,648 bytes;
//   flash_wide_f32_kernel: 168 registers (one block of 384 threads), 44
//     bytes of spill stores and 52 of spill loads a thread; 175,872
//     bytes;
//   flash_wide_cluster_kernel<T>, T bf16 and float16: 168 registers a
//     thread at launch (setmaxnreg then gives the producer 24 and the
//     consumers 240), no spills; 230,616 bytes;
//   flash_wide_cluster_f32_kernel: 168 registers, 24 bytes of spill
//     stores and 32 of spill loads a thread; 208,656 bytes;
//   flash_wide_kernel<float>, <bf16>, <float16>: 255 registers, no
//     spills; 125,440, 89,088 and 89,088 bytes (the parent's SASS; every
//     kernel but the cluster kernels has the parent's SASS,
//     kernels/flash/compare.py).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// the 16-bit types: float16 (true) or bfloat16
template <typename T>
constexpr bool kF16 = std::is_same<T, f16>::value;

// two floats rounded to the 16-bit type T, as its 2-vector
template <typename T>
struct Vec2 {
  typedef __nv_bfloat162 type;
};
template <>
struct Vec2<f16> {
  typedef __half2 type;
};

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type to2(float lo, float hi) {
  if constexpr (kF16<T>)
    return __float22half2_rn(make_float2(lo, hi));
  else
    return __floats2bfloat162_rn(lo, hi);
}

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int BH, Sq, Skv, d, causal, window;
  float softcap, scale;
  int nq;   // query tiles
  int vec;  // float32: 16-byte copies allowed
};

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

// one block a (query tile, bh) (and output slice: ``slices`` of them),
// after raising the kernel's dynamic shared-memory limit
template <typename K>
int launch(K kernel, int BQ, int threads, int smem, Params p,
           cudaStream_t st, int slices = 1) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.BH * slices;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync m16n8k8)

namespace f32 {

constexpr int NW = 4;        // warps, 16 query rows each
constexpr int BQ = 16 * NW;  // query rows a block

// key-tile rows by compiled head width
template <int D>
struct Tile {
  static constexpr int BK = D == 64 ? 64 : 32;
  static constexpr int LQ = D + 8;  // Q and K rows in floats: 64-bit
  static constexpr int LV = D + 4;  // fragment loads and V's scalar ones
                                    // hit 32 distinct banks
};

// Q, then the K ring, then the V ring, 2 slots each
template <int D>
constexpr int smem_bytes() {
  return 4 * ((BQ + 2 * Tile<D>::BK) * Tile<D>::LQ +
              2 * Tile<D>::BK * Tile<D>::LV);
}

// tf32 of x rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero), as a float32 bit pattern with the low 13 bits zero: half of
// the dropped bits' unit added to the magnitude, then those bits cleared.
// For finite x (and infinities) this is cvt.rna's result in two integer
// operations; cvt.rna itself compiles to several (its checks of the
// exponent), and the kernel splits about 20 operands per mma.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 relative, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small terms first, then hi x hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a (len, d) float32 matrix into s[ROWS][LD] by
// cp.async, zero past len and past d: 16-byte copies where the bases are
// 16-byte aligned and d % 4 == 0, 4-byte copies elsewhere (a float32 base
// is always 4-byte aligned)
template <int D, int ROWS, int LD>
__device__ __forceinline__ void stage(uint32_t s, const float* g, int r0,
                                      int len, int d, bool vec) {
  if (vec) {
    constexpr int CH = D / 4;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += 32 * NW) {
      const int r = idx / CH, c = (idx % CH) * 4;
      const bool ok = r0 + r < len && c < d;
      cp_async16(s + 4 * (r * LD + c),
                 ok ? g + (long long)(r0 + r) * d + c : g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += 32 * NW) {
      const int r = idx / D, c = idx % D;
      const bool ok = r0 + r < len && c < d;
      cp_async4(s + 4 * (r * LD + c),
                ok ? g + (long long)(r0 + r) * d + c : g, ok);
    }
  }
}

// Online softmax of one 16 x BK score tile in place (sc holds q.k on entry
// and p on exit), with expf and tanhf; EDGE: the tile crosses the
// diagonal, the window's edge or the end of the keys, so keep() runs
template <int BK, bool EDGE>
__device__ __forceinline__ void softmax(const Params& p, float (&sc)[BK / 8][4],
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2],
                                        const int (&rows)[2], int k0,
                                        int t) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = logit(p, sc[j][e]);
      if (EDGE && !keep(p, rows[h], k0 + 8 * j + 2 * t + (e & 1)))
        x = NEG_INF;
      sc[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
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
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float x = sc[j][e];
      float pe = expf(x - m[h]);
      if (EDGE && x == NEG_INF) pe = 0.f;
      sc[j][e] = pe;
      l[h] += pe;
    }
}

template <int D>
__global__ void __launch_bounds__(32 * NW)
    flash_f32_kernel(const __grid_constant__ Params p) {
  constexpr int BK = Tile<D>::BK, LQ = Tile<D>::LQ, LV = Tile<D>::LV;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + BQ * LQ;        // 2 slots of BK * LQ
  float* Vs = Ks + 2 * BK * LQ;    // 2 slots of BK * LV
  const uint32_t sQ = static_cast<uint32_t>(__cvta_generic_to_shared(Qs));
  const uint32_t sK = sQ + 4 * BQ * LQ, sV = sK + 4 * 2 * BK * LQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row, column pair
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  const float* q = static_cast<const float*>(p.q) + (long long)bh * p.Sq * p.d;
  const float* k = static_cast<const float*>(p.k) + (long long)bh * p.Skv * p.d;
  const float* v = static_cast<const float*>(p.v) + (long long)bh * p.Skv * p.d;
  float* o = static_cast<float*>(p.o) + (long long)bh * p.Sq * p.d;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const bool vec = p.vec != 0;
  stage<D, BQ, LQ>(sQ, q, q0, p.Sq, p.d, vec);
  if (kb < ke) {
    stage<D, BK, LQ>(sK, k, kb * BK, p.Skv, p.d, vec);
    stage<D, BK, LV>(sV, v, kb * BK, p.Skv, p.d, vec);
  }
  cp_commit();

  const int w0 = q0 + 16 * warp;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const int kd = (p.d + 7) / 8;  // 8-column slices that hold real columns
  float acc[D / 8][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kb; kt < ke; ++kt) {
    const int i = kt - kb, k0 = kt * BK;
    if (kt + 1 < ke) {  // the next tile into the other slot, in flight
      const int s = (i + 1) % 2;  // while this one is used
      stage<D, BK, LQ>(sK + 4 * s * BK * LQ, k, k0 + BK, p.Skv, p.d, vec);
      stage<D, BK, LV>(sV + 4 * s * BK * LV, v, k0 + BK, p.Skv, p.d, vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile i (and Q) in shared memory for every thread
    // a warp whose 16 rows keep no key of the tile skips it
    const bool dead = (p.causal && k0 > w0 + 15) ||
                      (p.window > 0 && w0 - (k0 + BK - 1) >= p.window);
    if (!dead) {
      const float* Kt = Ks + (i % 2) * BK * LQ;
      const float* Vt = Vs + (i % 2) * BK * LV;
      // S = Q K^T.  Within a slice of 8 columns the fragments' k index t
      // is column 2t and t + 4 is 2t + 1 (the same in A and B, so the sum
      // is unchanged), which makes every operand pair one 64-bit load.
      // Each slice's three products go into fresh accumulators, added to
      // S in float32 rounded to nearest (see the header: summed on the
      // tensor cores, a row of d = 256 missed float32's 2e-5).
      float sc[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        if (kk < kd) {
          const float2 q0v =
              *reinterpret_cast<const float2*>(Qs + (16 * warp + g) * LQ +
                                               8 * kk + 2 * t);
          const float2 q1v = *reinterpret_cast<const float2*>(
              Qs + (16 * warp + g + 8) * LQ + 8 * kk + 2 * t);
          uint32_t ah[4], al[4];
          split(q0v.x, ah[0], al[0]);
          split(q1v.x, ah[1], al[1]);
          split(q0v.y, ah[2], al[2]);
          split(q1v.y, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const float2 kv = *reinterpret_cast<const float2*>(
                Kt + (8 * j + g) * LQ + 8 * kk + 2 * t);
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, ah, al, kv.x, kv.y);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] += part[e];
          }
        }
      }
      const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > w0) ||
                        (p.window > 0 && w0 + 15 - k0 >= p.window);
      float corr[2];
      if (edge)
        softmax<BK, true>(p, sc, m, l, corr, rows, k0, t);
      else
        softmax<BK, false>(p, sc, m, l, corr, rows, k0, t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P V.  Score tile j is P's A fragment of keys 8j .. 8j + 7
      // with k index t as key 2t and t + 4 as key 2t + 1, so V's B
      // fragment reads rows 2t and 2t + 1; p is split in registers.  As
      // for S, each 8 keys' three products go into fresh accumulators,
      // added to acc rounded to nearest.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t ah[4], al[4];
        split(sc[j][0], ah[0], al[0]);
        split(sc[j][2], ah[1], al[1]);
        split(sc[j][1], ah[2], al[2]);
        split(sc[j][3], ah[3], al[3]);
        const float* vp = Vt + (8 * j + 2 * t) * LV + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          if (n < kd) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(part, ah, al, vp[8 * n], vp[LV + 8 * n]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
          }
        }
      }
    }
    __syncthreads();  // every read of slot i % 2 done before its refill
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = 8 * n + 2 * t + (e & 1);
      if (rows[h] < p.Sq && col < p.d)
        o[(long long)rows[h] * p.d + col] = acc[n][e] / l[h];
    }
}

}  // namespace f32

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

// unit (row tr, 8-column group u) of a tile of R rows in TMA's 128-byte
// swizzle: 64-column chunks of R x 128 bytes, 16-byte units permuted by
// the row
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int R, int tr,
                                             int u) {
  return tile + (u / 8) * R * 128 + tr * 128 + ((u % 8) ^ (tr % 8)) * 16;
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

template <typename T>
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  const typename Vec2<T>::type h = to2<T>(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
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

// tanh(x) = 1 - 2 / (2^(2 x log2(e)) + 1) by ex2.approx and a fast
// division, two MUFU operations: an absolute error of a few 2^-23 over
// the whole range (2^x overflows to inf for large x and gives 1), which
// the softcap scales by at most softcap in the logits.  float16's
// contract (5e-3) is tighter than tanh.approx's 2^-11 at Gemma-2's
// softcap of 50 (logits off by up to 0.025).
__device__ __forceinline__ float tanh_acc(float x) {
  return 1.f - __fdividef(2.f, ex2(2.f * LOG2E * x) + 1.f);
}

// wgmma's accumulator operands d[i .. i + 7], and the register lists of
// 32, 64 and 128 of them
#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_D128                                                           \
  WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96),          \
      WG_D8(104), WG_D8(112), WG_D8(120)
#define WG_R32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                    \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                    \
  "%30, %31"
#define WG_R64                                                            \
  WG_R32                                                                  \
  ", %32, %33, %34, %35, %36, %37, %38, %39, "                            \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                    \
  "%60, %61, %62, %63"
#define WG_R128                                                           \
  WG_R64                                                                  \
  ", %64, %65, %66, %67, %68, %69, "                                      \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "                    \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "                    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "          \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "          \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// S = Q K^T, m64nNk16 (N = 64, 128): A (Q) and B (K) K-major in shared
// memory; TY is the operands' type, bf16 or f16
#define WG_SS(N, R, D, A, B, PRED, TY)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"         \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY \
               " {" R "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"              \
               : D                                                        \
               : "l"(da), "l"(db), "r"(acc))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (kF16<T>)
    WG_SS("64", WG_R32, WG_D32, "%32", "%33", "%34", "f16");
  else
    WG_SS("64", WG_R32, WG_D32, "%32", "%33", "%34", "bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (kF16<T>)
    WG_SS("128", WG_R64, WG_D64, "%64", "%65", "%66", "f16");
  else
    WG_SS("128", WG_R64, WG_D64, "%64", "%65", "%66", "bf16");
}

// O += P V, m64nNk16 (N = 64, 128, 256): A (P) from registers, B (V)
// MN-major in shared memory
#define WG_RS(N, R, D, A, B, PRED, TY)                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"         \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY \
               " {" R "}, {" A "}, " B ", p, 1, 1, 1;\n}\n"               \
               : D                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                 "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16<T>)
    WG_RS("64", WG_R32, WG_D32, "%32, %33, %34, %35", "%36", "%37", "f16");
  else
    WG_RS("64", WG_R32, WG_D32, "%32, %33, %34, %35", "%36", "%37", "bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16<T>)
    WG_RS("128", WG_R64, WG_D64, "%64, %65, %66, %67", "%68", "%69", "f16");
  else
    WG_RS("128", WG_R64, WG_D64, "%64, %65, %66, %67", "%68", "%69",
          "bf16");
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kF16<T>)
    WG_RS("256", WG_R128, WG_D128, "%128, %129, %130, %131", "%132", "%133",
          "f16");
  else
    WG_RS("256", WG_R128, WG_D128, "%128, %129, %130, %131", "%132", "%133",
          "bf16");
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
template <typename T, int BK, bool EDGE, bool CAP>
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
      if (CAP) {
        if constexpr (kF16<T>)
          x = cl * tanh_acc(x * cs);
        else
          x = cl * tanh_fast(x * cs);
      } else if (EDGE) {
        x *= sl;
      }
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

// TMA_OUT: the epilogue stores through TMA (the Hopper kernel); else the
// threads store to global memory directly (the general kernel, whose o
// may be unaligned)
template <typename T, int D, bool TMA_OUT>
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
        wgmma_ss<T>(sc, desc(qs + c * BQ * 128 + kk * 32, 16, 1024),
                 desc(ks + c * BK * 128 + kk * 32, 16, 1024),
                 (c | kk) != 0);
    wg_commit();
  };
  auto values = [&](int i) {  // issue O += P V_i over BK / 16 slices
    const uint32_t vs = sV + (i % ST) * KV;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<T>(o, pa[kk], desc(vs + kk * 16 * 128, BK * 128, 1024));
    wg_commit();
  };
  auto soft = [&](int i) {
    const int k0 = (kb + i) * BK;
    const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > r0) ||
                      (p.window > 0 && r0 + 63 - k0 >= p.window);
    if (cap) {
      if (edge)
        softmax<T, BK, true, true>(p, sc, m, l, corr, rows, k0, t, sl, cs,
                                   cl);
      else
        softmax<T, BK, false, true>(p, sc, m, l, corr, rows, k0, t, sl, cs,
                                    cl);
    } else {
      // the max of the raw dots is the max of the logits only for a
      // positive scale: any other scale takes the path that scales first
      if (edge || !(sl > 0.f))
        softmax<T, BK, true, false>(p, sc, m, l, corr, rows, k0, t, sl, cs,
                                    cl);
      else
        softmax<T, BK, false, false>(p, sc, m, l, corr, rows, k0, t, sl, cs,
                                     cl);
    }
  };
  auto pack = [&]() {  // P's A fragments, p rounded to T: score tiles
    // 2kk and 2kk + 1 are the fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      pa[j / 2][2 * (j % 2)] = pack_f<T>(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_f<T>(sc[4 * j + 2], sc[4 * j + 3]);
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
  if constexpr (TMA_OUT) {
    // acc / l as T into this warpgroup's own Q rows (free now: only its
    // products read them), in the 128-byte swizzle, then one TMA store a
    // 64-column chunk; TMA writes no row past Sq, no column past d.
    const uint32_t so = sQ + wg * 64 * 128;
    const int r = 16 * warp + lane / 4;  // row within the warpgroup
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        const uint32_t at = swizzled(so, BQ, r + 8 * h, x) + t * 4;
        const uint32_t v2 = pack_f<T>(o[4 * x + 2 * h] / l[h],
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
  } else {
    // acc / l as T straight from the registers: no row past Sq, no
    // column past d; a pair of columns is one 4-byte store where it is
    // 4-byte aligned
    T* og = static_cast<T*>(p.o) + (long long)bh * p.Sq * p.d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= p.Sq) continue;
      T* orow = og + (long long)rows[h] * p.d;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        const int col = 8 * x + 2 * t;
        if (col >= p.d) continue;
        const typename Vec2<T>::type v2 =
            to2<T>(o[4 * x + 2 * h] / l[h], o[4 * x + 2 * h + 1] / l[h]);
        if (col + 1 < p.d &&
            reinterpret_cast<uintptr_t>(orow + col) % 4 == 0) {
          *reinterpret_cast<typename Vec2<T>::type*>(orow + col) = v2;
        } else {
          orow[col] = v2.x;
          if (col + 1 < p.d) orow[col + 1] = v2.y;
        }
      }
    }
  }
}

template <typename T, int D>
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
    consume<T, D, true>(p, &to, q0, bh, kb, ke, sQ, sK, sV, bar);
  }
}

// The general kernel: the same consumers behind a producer warpgroup of
// threads, for what TMA cannot describe.  Each piece (PR rows of Q, K or
// V) arrives by one cp.async.bulk of the 16-byte segments that hold its
// bytes (its rows are contiguous in global memory) into a raw staging
// slot; the 128 producer threads realign it into its tile in TMA's
// 128-byte swizzle, zero past d and past the rows.  NSTG - 1 pieces'
// copies are in flight while one is realigned.

// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = 168 x 384,
// the registers at launch (the producer's batches of 2 units need 56)
constexpr int GEN_PREG = 56, GEN_CREG = 224;
constexpr int GEN_PIECE = 32768;  // bytes of a piece, at most
constexpr int GEN_NB = 2;         // units a batch: loads issued together

template <int D>
struct Gen {
  static constexpr int PR = GEN_PIECE / (2 * D) < Tile<D>::BK
                                ? GEN_PIECE / (2 * D)
                                : Tile<D>::BK;  // rows a piece
  // bytes a slot: the piece's segments and 16 more, so that a unit's
  // second load never leaves the slot
  static constexpr int SLOT = PR * D * 2 + 32;
  // as many slots as the block's 227 KB leave room for, at most 4
  static constexpr int FREE = 232448 - 2 * D * (BQ + 2 * ST * Tile<D>::BK) -
                              1024 - 8 * (1 + 4 * ST + 4);
  static constexpr int NSTG = FREE / SLOT < 4 ? FREE / SLOT : 4;
  static_assert(Tile<D>::BK % PR == 0 && NSTG >= 1, "staging");
  static_assert((PR * D / 8 / 128) % GEN_NB == 0, "batches");
};

template <int D>
constexpr int smem_bytes_general() {
  return 2 * D * (BQ + 2 * ST * Tile<D>::BK) + Gen<D>::NSTG * Gen<D>::SLOT +
         8 * (1 + 4 * ST + Gen<D>::NSTG) + 1024;
}

__device__ __forceinline__ void ld_v4(uint32_t a, uint32_t (&x)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void st_v4(uint32_t a, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}

// A piece whose rows all start o0 bytes past a 16-byte boundary (d % 8 ==
// 0): each thread takes one unit u of rows r0, r0 + 128 / U, ...; QW =
// o0 / 4 is a constant, b = (o0 % 4) * 8 the bits of the funnel shift.  A
// unit: two aligned 16-byte loads, four funnel shifts, one store.
template <int D, int QW>
__device__ __forceinline__ void copy_rows(uint32_t stg, uint32_t dst, int R,
                                          int sub, int rows, int d,
                                          uint32_t b, int pt) {
  constexpr int U = D / 8, RS = 128 / U, PR = Gen<D>::PR, NB = GEN_NB;
  const int u = pt % U, r0 = pt / U;
  const uint32_t src = stg + r0 * 2 * d + 16 * u;
#pragma unroll 2  // whole, the 16 steps' addresses spill the 56 registers
  for (int k0 = 0; k0 < PR / RS; k0 += NB) {
    uint32_t lo[NB][4], hi[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint32_t a = src + (k0 + i) * RS * 2 * d;
      ld_v4(a, lo[i]);
      ld_v4(a + 16, hi[i]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int r = r0 + (k0 + i) * RS;
      const bool ok = 8 * u < d && r < rows;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = QW + e;  // a constant: no register is indexed
        const uint32_t w0 = x < 4 ? lo[i][x] : hi[i][x - 4];
        const uint32_t w1 = x + 1 < 4 ? lo[i][x + 1] : hi[i][x - 3];
        w[e] = ok ? __funnelshift_r(w0, w1, b) : 0u;
      }
      st_v4(swizzled(dst, R, sub + r, u), w);
    }
  }
}

// A piece whose rows start at offsets that change from row to row (d % 8
// != 0): the same per unit, with the shift taken from each unit's offset
// (word selects, then a funnel shift) and the columns past d cleared.
template <int D>
__device__ __forceinline__ void copy_units(uint32_t stg, uint32_t dst, int R,
                                           int sub, int rows, int d, int o0,
                                           int pt) {
  constexpr int U = D / 8, PR = Gen<D>::PR, NB = GEN_NB;
  for (int b0 = pt; b0 < PR * U; b0 += 128 * NB) {
    uint32_t lo[NB][4], hi[NB][4];
    int sh[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = b0 + 128 * i, r = idx / U, u = idx % U;
      const int off = o0 + r * 2 * d + 16 * u, a = off & ~15;
      sh[i] = off & 15;
      if (r < rows && 8 * u < d) {
        ld_v4(stg + a, lo[i]);
        ld_v4(stg + a + 16, hi[i]);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) lo[i][w] = hi[i][w] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int idx = b0 + 128 * i, r = idx / U, u = idx % U;
      const int nv = d - 8 * u;  // columns of this unit that exist
      uint32_t x[6] = {lo[i][0], lo[i][1], lo[i][2], lo[i][3], hi[i][0],
                       hi[i][1]};
      if (sh[i] & 8) {  // by two words
        x[0] = lo[i][2];
        x[1] = lo[i][3];
        x[2] = hi[i][0];
        x[3] = hi[i][1];
        x[4] = hi[i][2];
        x[5] = hi[i][3];
      }
      if (sh[i] & 4) {  // by one word
        x[0] = x[1];
        x[1] = x[2];
        x[2] = x[3];
        x[3] = x[4];
        x[4] = x[5];
      }
      const uint32_t b = (sh[i] & 2) * 8;  // and by half a word
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t keep = r >= rows || 2 * e >= nv ? 0u
                              : 2 * e + 1 < nv         ? 0xffffffffu
                                                       : 0x0000ffffu;
        w[e] = __funnelshift_r(x[e], x[e + 1], b) & keep;
      }
      st_v4(swizzled(dst, R, sub + r, u), w);
    }
  }
}

template <int D>
__device__ __forceinline__ void produce(const Params& p, int q0, int bh,
                                        int kb, int ke, uint32_t sQ,
                                        uint32_t sK, uint32_t sV,
                                        uint32_t sS, uint32_t bar) {
  constexpr int BK = Tile<D>::BK, KV = BK * D * 2;
  constexpr int PR = Gen<D>::PR, NSTG = Gen<D>::NSTG, SLOT = Gen<D>::SLOT;
  constexpr int QP = BQ / PR, TP = BK / PR;  // pieces of Q, of a K/V tile
  const Ring ring{bar};
  const uint32_t sbar = bar + 8 * (1 + 4 * ST);  // staging barriers
  const int pt = threadIdx.x - 128 * NC;
  const int d = p.d;
  const long long row_bytes = 2LL * d;
  const uintptr_t q = reinterpret_cast<uintptr_t>(p.q) +
                      (uintptr_t)((long long)bh * p.Sq * row_bytes);
  const uintptr_t k = reinterpret_cast<uintptr_t>(p.k) +
                      (uintptr_t)((long long)bh * p.Skv * row_bytes);
  const uintptr_t v = reinterpret_cast<uintptr_t>(p.v) +
                      (uintptr_t)((long long)bh * p.Skv * row_bytes);
  // pieces: Q's, then for each key tile K's and V's
  const int n = QP + 2 * TP * max(ke - kb, 0);

  // piece j: its first row's address, its rows that exist, its first row
  // in its tile
  auto piece = [&](int j, uintptr_t& start, int& rows, int& sub) {
    if (j < QP) {
      const int r0 = q0 + j * PR;
      start = q + (uintptr_t)((long long)r0 * row_bytes);
      rows = min(max(p.Sq - r0, 0), PR);
      sub = j * PR;
    } else {
      const int jj = j - QP, i = jj / (2 * TP);
      sub = (jj % TP) * PR;
      const int r0 = (kb + i) * BK + sub;
      start = ((jj / TP) % 2 ? v : k) + (uintptr_t)((long long)r0 * row_bytes);
      rows = min(max(p.Skv - r0, 0), PR);
    }
  };
  // the 16-byte segments that hold piece j's bytes
  auto span = [&](uintptr_t start, int rows) -> uint32_t {
    return rows > 0 ? (uint32_t)(((start + rows * row_bytes + 15) &
                                  ~(uintptr_t)15) -
                                 (start & ~(uintptr_t)15))
                    : 0u;
  };
  // piece j's segments into its staging slot (an empty piece completes
  // its barrier's phase with no bytes)
  auto issue = [&](int j) {
    if (pt != 0 || j >= n) return;
    uintptr_t start;
    int rows, sub;
    piece(j, start, rows, sub);
    const uint32_t bytes = span(start, rows);
    const uint32_t b = sbar + 8 * (j % NSTG);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(b, bytes);
    if (bytes > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(sS + (j % NSTG) * SLOT),
          "l"((uint64_t)(start & ~(uintptr_t)15)), "r"(bytes), "r"(b)
          : "memory");
  };

  for (int j = 0; j < NSTG - 1; ++j) issue(j);
  for (int j = 0; j < n; ++j) {
    // the slot of piece j - 1 is free: every thread passed its bar.sync
    issue(j + NSTG - 1);
    uintptr_t start;
    int rows, sub;
    piece(j, start, rows, sub);
    uint32_t dst, full = 0;
    int R;  // the tile's rows
    if (j < QP) {
      dst = sQ;
      R = BQ;
      if (j == QP - 1) full = bar;
    } else {
      const int jj = j - QP, i = jj / (2 * TP);
      const bool isv = (jj / TP) % 2;
      dst = (isv ? sV : sK) + (i % ST) * KV;
      R = BK;
      if (sub == 0)  // a tile's first piece waits for its ring slot
        mbar_wait(isv ? ring.vempty(i) : ring.kempty(i), ring.phase(i) ^ 1);
      if (sub == BK - PR) full = isv ? ring.vfull(i) : ring.kfull(i);
    }
    const int o0 = (int)(start & 15);
    const uint32_t stg = sS + (j % NSTG) * SLOT;
    mbar_wait(sbar + 8 * (j % NSTG), (j / NSTG) & 1);
    if (d % 8 == 0) {  // one offset for every row: a constant shift
      const uint32_t b = (o0 & 2) * 8;
      switch (o0 / 4) {
        case 0:
          copy_rows<D, 0>(stg, dst, R, sub, rows, d, b, pt);
          break;
        case 1:
          copy_rows<D, 1>(stg, dst, R, sub, rows, d, b, pt);
          break;
        case 2:
          copy_rows<D, 2>(stg, dst, R, sub, rows, d, b, pt);
          break;
        default:
          copy_rows<D, 3>(stg, dst, R, sub, rows, d, b, pt);
      }
    } else {
      copy_units<D>(stg, dst, R, sub, rows, d, o0, pt);
    }
    // the tensor cores read the tile through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // every thread's reads of the staging slot are done before its refill
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
    if (full != 0) mbar_arrive(full);  // a tile's barrier after its last piece
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
    flash_general_kernel(const __grid_constant__ Params p) {
  constexpr int BK = Tile<D>::BK;
  constexpr uint32_t KV = BK * D * 2;
  extern __shared__ unsigned char smem_g[];
  const uint32_t sQ = (smem_u32(smem_g) + 1023u) & ~1023u;
  const uint32_t sK = sQ + BQ * D * 2, sV = sK + ST * KV;
  const uint32_t sS = sV + ST * KV;  // staging slots
  const uint32_t bar = sS + Gen<D>::NSTG * Gen<D>::SLOT;
  const Ring ring{bar};
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  if (threadIdx.x == 0) {
    mbar_init(bar, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(ring.kfull(s), 128);
      mbar_init(ring.vfull(s), 128);
      mbar_init(ring.kempty(s), 128 * NC);
      mbar_init(ring.vempty(s), 128 * NC);
    }
    for (int s = 0; s < Gen<D>::NSTG; ++s)
      mbar_init(bar + 8 * (1 + 4 * ST + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {  // producer warpgroup: 128 threads load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GEN_PREG));
    produce<D>(p, q0, bh, kb, ke, sQ, sK, sV, sS, bar);
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(GEN_CREG));
    consume<T, D, false>(p, nullptr, q0, bh, kb, ke, sQ, sK, sV, bar);
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

// the (d, S, BH) tensor of 16-bit ``type`` at ``ptr`` in boxes of 64
// columns x ``rows``, 128-byte swizzle; loads read zeros out of bounds,
// stores skip it
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            int d, int S, int BH, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.BH;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  constexpr CUtensorMapDataType ty = kF16<T>
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, ty, p.q, p.d, p.Sq, p.BH, BQ) ||
      !encode(&tk, ty, p.k, p.d, p.Skv, p.BH, Tile<D>::BK) ||
      !encode(&tv, ty, p.v, p.d, p.Skv, p.BH, Tile<D>::BK) ||
      !encode(&to, ty, p.o, p.d, p.Sq, p.BH, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  flash_wgmma_kernel<T, D><<<(unsigned)blocks, NTH, smem, st>>>(p, tq, tk,
                                                                 tv, to);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_general(const Params& p, cudaStream_t st) {
  return ::launch(flash_general_kernel<T, D>, BQ, NTH,
                  smem_bytes_general<D>(), p, st);
}

}  // namespace hop

// ---------------------------------------------------------------------------
// d > 256, every dtype: Q and K streamed in chunks of 64 columns, S summed
// in registers over the chunks, the output in slices of at most 256
// columns, one slice a block

namespace wide {

constexpr int NW = 8;        // warps, 16 query rows each
constexpr int BQ = 16 * NW;  // query rows a block
constexpr int CW = 64;       // columns of Q and K a chunk
constexpr int DV = 256;      // output columns a slice, at most
// chunk slots: a deeper ring (3 or 4 slots at 16 bits) spilled registers
// and ran 17-18% slower on an H100 (kernels/flash/compare.py)
constexpr int NA = 2;

template <typename T>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BK = F32 ? 32 : 64;  // keys a tile
  // chunk rows and V rows in elements: the fragment loads of a warp hit
  // 32 distinct banks (and V's rows stay 16-byte aligned for ldmatrix)
  static constexpr int LC = CW + 8;
  static constexpr int LV = DV + (F32 ? 4 : 8);
  // NA slots of (a Q chunk, then a K chunk), then one of a V slice
  static constexpr int SMEM =
      (int)sizeof(T) * (NA * (BQ + BK) * LC + BK * LV);
};

// the output slices of head width d: ns slices of sw columns (a multiple of
// 8, at most DV), the last one narrower; balanced, so that no slice
// recomputes S for a few columns
__host__ __device__ inline void slices(int d, int& ns, int& sw) {
  const int n0 = (d + DV - 1) / DV;
  sw = ((d + n0 - 1) / n0 + 7) / 8 * 8;
  ns = (d + sw - 1) / sw;
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a (len, d) matrix into
// s[ROWS][LD], zero at rows past len and columns past cend: 16-byte
// cp.async where the bases are 16-byte aligned and d is a multiple of 16
// bytes (c0 and cend then are too), else 4-byte cp.async for float32 and
// 2-byte loads and stores through the registers for a 16-bit type (whose
// base may lie at any even byte)
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage(T* s, const T* g, int r0, int len,
                                      int c0, int cend, int d, bool vec) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T), CH = COLS / E;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += 32 * NW) {
      const int r = idx / CH, c = (idx % CH) * E;
      const bool ok = r0 + r < len && c0 + c < cend;
      f32::cp_async16(sa + (int)sizeof(T) * (r * LD + c),
                      ok ? g + (long long)(r0 + r) * d + c0 + c : g, ok);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += 32 * NW) {
      const int r = idx / COLS, c = idx % COLS;
      const bool ok = r0 + r < len && c0 + c < cend;
      f32::cp_async4(sa + 4 * (r * LD + c),
                     ok ? g + (long long)(r0 + r) * d + c0 + c : g, ok);
    }
  } else {
    const uint16_t* gs = reinterpret_cast<const uint16_t*>(g);
    uint16_t* ss = reinterpret_cast<uint16_t*>(s);
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += 32 * NW) {
      const int r = idx / COLS, c = idx % COLS;
      const bool ok = r0 + r < len && c0 + c < cend;
      ss[r * LD + c] = ok ? gs[(long long)(r0 + r) * d + c0 + c] : 0;
    }
  }
}

// c += a b, m16n8k16 with 16-bit operands and float32 accumulators
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (kF16<T>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 16-bit matrices from shared memory: lanes 8i .. 8i + 7 give
// the rows of matrix i, and r[i] is this lane's pair of it (row lane / 4,
// columns 2 (lane % 4) and + 1; transposed, column lane / 4 and rows
// 2 (lane % 4) and + 1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// S += Q_c K_c^T over one chunk: Qw the warp's 16 rows, Kc the tile's BK
// rows, cols the chunk's columns below d (Q's and K's columns past d are
// zero, so a partial slice adds nothing)
template <typename T>
__device__ __forceinline__ void chunk_scores(
    float (&sc)[Cfg<T>::BK / 8][4], const T* Qw, const T* Kc, int cols,
    int g, int t, int lane) {
  constexpr int BK = Cfg<T>::BK, LC = Cfg<T>::LC;
  if constexpr (Cfg<T>::F32) {
    // 3xTF32 on m16n8k8; within a slice of 8 columns the fragments' k
    // index t is column 2t and t + 4 is 2t + 1 (the same in A and B).
    // Each slice's three products go into fresh accumulators, added to S
    // in float32 rounded to nearest: summed on the tensor cores over the
    // hundreds of products of a wide row (d = 2048: 768), S was off by
    // enough to move outputs by 5e-5, past float32's 2e-5 (measured on an
    // H100; the tensor cores' float32 sums do not round to nearest)
#pragma unroll
    for (int kk = 0; kk < CW / 8; ++kk) {
      if (8 * kk < cols) {
        const float2 q0v =
            *reinterpret_cast<const float2*>(Qw + g * LC + 8 * kk + 2 * t);
        const float2 q1v = *reinterpret_cast<const float2*>(
            Qw + (g + 8) * LC + 8 * kk + 2 * t);
        uint32_t ah[4], al[4];
        f32::split(q0v.x, ah[0], al[0]);
        f32::split(q1v.x, ah[1], al[1]);
        f32::split(q0v.y, ah[2], al[2]);
        f32::split(q1v.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Kc + (8 * j + g) * LC + 8 * kk + 2 * t);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          f32::mma3(part, ah, al, kv.x, kv.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += part[e];
        }
      }
    }
  } else {
    // m16n8k16 with fragments by ldmatrix: A (Q) the 4 matrices rows
    // 0-7 / 8-15 x columns 0-7 / 8-15 of the warp's 16 x 16 slice (lanes
    // 0-7, 8-15, 16-23, 24-31); B (K^T) of key tiles j and j + 1 the
    // matrices keys 8j .. 8j + 7 x columns 0-7, 8-15, then the same of
    // tile j + 1
    const uint32_t qs = static_cast<uint32_t>(__cvta_generic_to_shared(Qw)) +
                        2 * ((lane % 8 + 8 * ((lane / 8) % 2)) * LC +
                             8 * (lane / 16));
    const uint32_t ks = static_cast<uint32_t>(__cvta_generic_to_shared(Kc)) +
                        2 * ((lane % 8 + 8 * (lane / 16)) * LC +
                             8 * ((lane / 8) % 2));
#pragma unroll
    for (int kk = 0; kk < CW / 16; ++kk) {
      if (16 * kk < cols) {
        uint32_t a[4];
        ldsm_x4(a, qs + 2 * 16 * kk);
#pragma unroll
        for (int j = 0; j < BK / 8; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, ks + 2 * (8 * j * LC + 16 * kk));
          mma16<T>(sc[j], a, b[0], b[1]);
          mma16<T>(sc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// O += P V_slice: sc holds the tile's p, Vt the tile's V slice (BK x LV),
// nd the 8-column tiles of the slice that hold real columns
template <typename T>
__device__ __forceinline__ void values(float (&acc)[DV / 8][4],
                                       const float (&sc)[Cfg<T>::BK / 8][4],
                                       const T* Vt, int nd, int g, int t,
                                       int lane) {
  constexpr int BK = Cfg<T>::BK, LV = Cfg<T>::LV;
  if constexpr (Cfg<T>::F32) {
    // score tile j is P's A fragment of keys 8j .. 8j + 7 with k index t
    // as key 2t and t + 4 as 2t + 1, so V's B fragment reads rows 2t and
    // 2t + 1; p is split in registers.  As in chunk_scores, each 8 keys'
    // three products go into fresh accumulators, added to acc rounded to
    // nearest (a row's acc takes Skv / 8 of them)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ah[4], al[4];
      f32::split(sc[j][0], ah[0], al[0]);
      f32::split(sc[j][2], ah[1], al[1]);
      f32::split(sc[j][1], ah[2], al[2]);
      f32::split(sc[j][3], ah[3], al[3]);
      const float* vp = Vt + (8 * j + 2 * t) * LV + g;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        if (n < nd) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          f32::mma3(part, ah, al, vp[8 * n], vp[LV + 8 * n]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
        }
      }
    }
  } else {
    // score tiles 2kk and 2kk + 1, rounded to T, are P's A fragment of
    // keys 16kk .. 16kk + 15 (m16n8's accumulator layout is m16n8k16's A
    // layout per 8 columns); V's B fragments of two 8-column tiles come
    // from one transposed ldmatrix: lanes 0-7 keys 0-7, lanes 8-15 keys
    // 8-15 of the first tile's columns, lanes 16-31 the same of the next
    const uint32_t vs = static_cast<uint32_t>(__cvta_generic_to_shared(Vt)) +
                        2 * ((lane % 8 + 8 * ((lane / 8) % 2)) * LV +
                             8 * (lane / 16));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          hop::pack_f<T>(sc[2 * kk][0], sc[2 * kk][1]),
          hop::pack_f<T>(sc[2 * kk][2], sc[2 * kk][3]),
          hop::pack_f<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          hop::pack_f<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        if (2 * n2 < nd) {
          uint32_t b[4];
          ldsm_x4_t(b, vs + 2 * (16 * kk * LV + 16 * n2));
          mma16<T>(acc[2 * n2], a, b[0], b[1]);
          mma16<T>(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else if constexpr (kF16<T>)
    return __float2half_rn(x);
  else
    return __float2bfloat16_rn(x);
}

// One block: query tile qt, head bh, output slice sl.  Steps j = (key
// tile i, chunk c) in order; step j + 1's copies (with V's slice at a
// tile's first chunk) are in flight while step j computes.  S is
// recomputed for every slice: ns times the Q K^T product.
template <typename T>
__global__ void __launch_bounds__(32 * NW, 1)
    flash_wide_kernel(const __grid_constant__ Params p) {
  constexpr int BK = Cfg<T>::BK, LC = Cfg<T>::LC, LV = Cfg<T>::LV;
  extern __shared__ __align__(16) unsigned char smem_w[];
  T* As = reinterpret_cast<T*>(smem_w);  // NA slots of BQ + BK chunk rows
  T* Vs = As + NA * (BQ + BK) * LC;      // BK slice rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int ns, sw;
  slices(p.d, ns, sw);
  // block -> (query tile, bh, slice), heaviest query tiles first, the
  // slices of one (query tile, bh) side by side
  const int per = p.BH * ns;
  const int qt = p.nq - 1 - blockIdx.x / per;
  const int bh = (blockIdx.x % per) / ns, c0 = (blockIdx.x % ns) * sw;
  const int cw = min(sw, p.d - c0);
  const int q0 = qt * BQ, d = p.d;
  const T* q = static_cast<const T*>(p.q) + (long long)bh * p.Sq * d;
  const T* k = static_cast<const T*>(p.k) + (long long)bh * p.Skv * d;
  const T* v = static_cast<const T*>(p.v) + (long long)bh * p.Skv * d;
  T* o = static_cast<T*>(p.o) + (long long)bh * p.Sq * d;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const int nc = (d + CW - 1) / CW;
  const int n = ke > kb ? (ke - kb) * nc : 0;
  const bool vec = p.vec != 0;

  // step j's Q and K chunks into slot j % NA; tile i's V slice
  auto chunks = [&](int j) {
    const int c = j % nc, k0 = (kb + j / nc) * BK;
    T* a = As + (j % NA) * (BQ + BK) * LC;
    stage<T, BQ, CW, LC>(a, q, q0, p.Sq, c * CW, d, d, vec);
    stage<T, BK, CW, LC>(a + BQ * LC, k, k0, p.Skv, c * CW, d, d, vec);
  };
  auto slice = [&](int i) {
    stage<T, BK, DV, LV>(Vs, v, (kb + i) * BK, p.Skv, c0, c0 + cw, d, vec);
  };

  const int w0 = q0 + 16 * warp;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};
  const int nd = (cw + 7) / 8;  // 8-column tiles that hold real columns
  float acc[DV / 8][4], sc[BK / 8][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < DV / 8; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;

  // Copy groups: G_s holds step s's chunks (and V's slice of the tile
  // that starts at step s - NA + 1, once the last P V has read the slot);
  // G_0 .. G_{NA-2} first, then G_{j + NA - 1} at step j, so step j waits
  // for G_j with NA - 2 groups still in flight.  A tile's V slice is
  // needed nc - 1 >= NA - 1 steps after its group is issued.
  for (int s = 0; s < NA - 1; ++s) {
    if (s < n) chunks(s);
    if (s == 0 && n > 0) slice(0);
    f32::cp_commit();
  }
  for (int j = 0; j < n; ++j) {
    const int i = j / nc, c = j % nc, k0 = (kb + i) * BK;
    f32::cp_wait<NA - 2>();
    // step j's chunks (and V's slice) landed for every thread, and every
    // thread is done with step j - 1, whose slot (and, after a tile's
    // last step, V's) is refilled now
    __syncthreads();
    if (j + NA - 1 < n) chunks(j + NA - 1);
    if (c == 0 && i > 0) slice(i);
    f32::cp_commit();
    // a warp whose 16 rows keep no key of the tile skips it
    const bool dead = (p.causal && k0 > w0 + 15) ||
                      (p.window > 0 && w0 - (k0 + BK - 1) >= p.window);
    if (!dead) {
      if (c == 0) {
#pragma unroll
        for (int x = 0; x < BK / 8; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[x][e] = 0.f;
      }
      const T* a = As + (j % NA) * (BQ + BK) * LC;
      chunk_scores<T>(sc, a + 16 * warp * LC, a + BQ * LC, d - c * CW, g, t,
                      lane);
      if (c == nc - 1) {
        const bool edge = k0 + BK > p.Skv ||
                          (p.causal && k0 + BK - 1 > w0) ||
                          (p.window > 0 && w0 + 15 - k0 >= p.window);
        float corr[2];
        if (edge)
          f32::softmax<BK, true>(p, sc, m, l, corr, rows, k0, t);
        else
          f32::softmax<BK, false>(p, sc, m, l, corr, rows, k0, t);
#pragma unroll
        for (int x = 0; x < DV / 8; ++x) {
          acc[x][0] *= corr[0];
          acc[x][1] *= corr[0];
          acc[x][2] *= corr[1];
          acc[x][3] *= corr[1];
        }
        values<T>(acc, sc, Vs, nd, g, t, lane);
      }
    }
  }
  f32::cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < DV / 8; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = 8 * x + 2 * t + (e & 1);
      if (rows[h] < p.Sq && col < cw)
        o[(long long)rows[h] * d + c0 + col] = from_f32<T>(acc[x][e] / l[h]);
    }
}

template <typename T>
int launch(const Params& p, cudaStream_t st) {
  int ns, sw;
  slices(p.d, ns, sw);
  return ::launch(flash_wide_kernel<T>, BQ, 32 * NW, Cfg<T>::SMEM, p, st,
                  ns);
}

}  // namespace wide

// ---------------------------------------------------------------------------
// d > 256 at 16 bits on Hopper: one block a 64-row query tile with every
// output column; S = Q K^T once a key tile, its columns of d split
// between the two consumer warpgroups and the partial sums exchanged
// through shared memory

namespace hw {

constexpr int NC = 2;                // consumer warpgroups
constexpr int NTH = 128 * (NC + 1);  // and one producer warpgroup
constexpr int BQ = 64;               // query rows a block: one m64 tile
constexpr int BK = 64;               // keys a tile
constexpr int MAXD = 576;            // widest head a block holds (ops.WIDE_MAXD)
constexpr int MAXCH = MAXD / 64;     // 64-column chunks of Q, K, V
constexpr int MAXC = (MAXCH + 1) / 2;  // chunks of O a warpgroup, at most
constexpr int RK = 6;                // K boxes in flight
constexpr int RV = MAXCH;            // V boxes in flight: a whole tile's
constexpr int BOX = 64 * 128;        // (64 rows x 64 columns) of 16 bits
// shared memory, from a 1024-byte aligned base: Q (MAXCH boxes), the K
// ring, the V ring, the warpgroups' partial S (32 floats a thread each),
// the barriers (Q full; K full and empty; V full and empty)
constexpr int SK = MAXCH * BOX, SV = SK + RK * BOX, SX = SV + RV * BOX;
constexpr int SB = SX + NC * BQ * BK * 4;
constexpr int SMEM = SB + 8 * (1 + 2 * RK + 2 * RV) + 1024;
static_assert(SMEM <= 232448, "shared memory");
// registers after setmaxnreg: 128 x 24 + 256 x 240 = 168 x 384
constexpr int PREG = 24, CREG = 240;

struct Bars {
  uint32_t bar;  // Q full; K full, K empty (RK each); V full, V empty
  __device__ uint32_t q() const { return bar; }
  __device__ uint32_t kfull(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t kempty(int s) const { return bar + 8 * (1 + RK + s); }
  __device__ uint32_t vfull(int s) const {
    return bar + 8 * (1 + 2 * RK + s);
  }
  __device__ uint32_t vempty(int s) const {
    return bar + 8 * (1 + 2 * RK + RV + s);
  }
};

// The chunks of a head of CH chunks: warpgroup 0 computes S over chunks
// [0, sa) and O on [0, ob), warpgroup 1 S over [sa, CH) and O on
// [ob, CH); each does CH chunks' products a tile
struct Split {
  int sa, ob;
  __device__ explicit Split(int CH) : sa((CH + 1) / 2), ob(CH / 2) {}
};

// The K boxes stream in the order both warpgroups consume them: for each
// tile, warpgroup 0's j-th S chunk, then warpgroup 1's, j = 0, 1, ...;
// the position of warpgroup wg's j-th chunk within its tile
__device__ __forceinline__ int kpos(int wg, int j) { return 2 * j + wg; }

// a ring position: box b of a ring of R slots lives in slot b % R, its
// use's parity (b / R) & 1
template <int R>
struct Pos {
  int s = 0;
  uint32_t ph = 0;
  __device__ void next() {
    if (++s == R) {
      s = 0;
      ph ^= 1;
    }
  }
};

// One producer thread streams a ring's boxes: chunk c of key tile kb + i
// for each (i, c) that ``chunk`` lists in order (c < 0: none)
template <int R, typename F>
__device__ __forceinline__ void produce(const CUtensorMap* map,
                                        uint32_t ring, uint32_t full0,
                                        uint32_t empty0, int kb, int n,
                                        int per, F chunk, int bh) {
  Pos<R> at;
  for (int i = 0; i < n; ++i)
    for (int x = 0; x < per; ++x) {
      const int c = chunk(x);
      if (c < 0) continue;
      hop::mbar_wait(empty0 + 8 * at.s, at.ph ^ 1);
      hop::mbar_expect_tx(full0 + 8 * at.s, BOX);
      hop::tma_load(ring + at.s * BOX, map, 64 * c, (kb + i) * BK, bh,
                    full0 + 8 * at.s);
      at.next();
    }
}

// O += P V over a warpgroup's NCH chunks: P's A fragments from
// registers, each chunk's V box MN-major in shared memory
template <typename T, int NCH>
__device__ __forceinline__ void values(float (&o)[MAXC][32],
                                       const uint32_t (&pa)[BK / 16][4],
                                       const uint32_t (&vs)[MAXC]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      hop::wgmma_rs<T>(o[j], pa[kk],
                       hop::desc(vs[j] + kk * 16 * 128, BOX, 1024));
}

// A consumer warpgroup.  Each tile: S over its chunks of d (a partial
// sum of the 64 x 64 scores), written to shared memory and added to the
// other warpgroup's, so that both hold the tile's S; the online softmax
// (the same in both); O += P V on its own chunks of the output.  Each
// step issues S of tile i, then P V of tile i - 1, and runs tile i's
// exchange and softmax while P V runs.
template <typename T>
__device__ __forceinline__ void consume(const Params& p, int q0, int bh,
                                        int kb, int n, int CH, uint32_t base,
                                        unsigned char* gbase) {
  const Bars bars{base + SB};
  const uint32_t sQ = base, sK = base + SK, sV = base + SV;
  float* xs = reinterpret_cast<float*>(gbase + SX);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row = q0 + 16 * warp + lane / 4;
  const int rows[2] = {row, row + 8};
  const Split sp(CH);
  const int s0 = wg == 0 ? 0 : sp.sa, sn = wg == 0 ? sp.sa : CH - sp.sa;
  const int cb = wg == 0 ? 0 : sp.ob, nch = wg == 0 ? sp.ob : CH - sp.ob;
  // this thread's partial S in shared memory and the other warpgroup's:
  // element r of a thread at [r][thread], so both warpgroups' threads of
  // one index hold the same scores
  float* mine = xs + wg * BQ * BK + tid;
  const float* other = xs + (1 - wg) * BQ * BK + tid;
  const bool cap = p.softcap > 0.f;
  const float sl = p.scale * hop::LOG2E;
  const float cs = p.scale / p.softcap, cl = p.softcap * hop::LOG2E;
  float o[MAXC][32], sc[BK / 2], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[j][x] = 0.f;

  hop::mbar_wait(bars.q(), 0);
  for (int i = 0; i <= n; ++i) {
    if (i < n) {
      // S over this warpgroup's chunks, each K box freed once its product
      // is done (one chunk's product stays in flight while the next
      // issues)
      const uint32_t qs = hop::opaque(sQ);
      for (int j = 0; j < sn; ++j) {
        const int b = i * CH + kpos(wg, j), s = b % RK;
        hop::mbar_wait(bars.kfull(s), (b / RK) & 1);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<T>(sc, hop::desc(qs + (s0 + j) * BOX + kk * 32, 16,
                                         1024),
                           hop::desc(sK + s * BOX + kk * 32, 16, 1024),
                           (j | kk) != 0);
        hop::wg_commit();
        if (j > 0) {
          hop::wg_wait<1>();
          if (lane == 0)
            hop::mbar_arrive(bars.kempty((i * CH + kpos(wg, j - 1)) % RK));
        }
      }
    }
    if (i > 0) {  // O += P_{i-1} V_{i-1} on this warpgroup's chunks
      uint32_t vs[MAXC];
      const int b0 = (i - 1) * CH + cb;  // its first V box
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int s = (b0 + j) % RV;
        vs[j] = sV + s * BOX;
        if (j < nch) hop::mbar_wait(bars.vfull(s), ((b0 + j) / RV) & 1);
      }
#pragma unroll
      for (int j = 0; j < MAXC; ++j) hop::fence_regs(o[j]);
      hop::wg_fence();
      switch (nch) {
        case 2:
          values<T, 2>(o, pa, vs);
          break;
        case 3:
          values<T, 3>(o, pa, vs);
          break;
        case 4:
          values<T, 4>(o, pa, vs);
          break;
        default:
          values<T, 5>(o, pa, vs);
      }
      hop::wg_commit();
    }
    if (i < n) {
      if (i > 0)
        hop::wg_wait<1>();  // S done, P V may still run
      else
        hop::wg_wait<0>();
      hop::fence_regs(sc);
      if (lane == 0)
        hop::mbar_arrive(bars.kempty((i * CH + kpos(wg, sn - 1)) % RK));
      // the tile's S: this warpgroup's partial sum and the other's (the
      // other has read this one's last partial: bar 2 + wg)
      if (i > 0)
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128 * NC)
                     : "memory");
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) mine[r * 128] = sc[r];
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) sc[r] += other[r * 128];
      if (i + 1 < n)  // this warpgroup has read the other's partial
        asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - wg), "n"(128 * NC)
                     : "memory");
      const int k0 = (kb + i) * BK;
      const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > q0) ||
                        (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
      // the max of the raw dots is the max of the logits only for a
      // positive scale: any other scale takes the path that scales first
      if (cap) {
        if (edge)
          hop::softmax<T, BK, true, true>(p, sc, m, l, corr, rows, k0, t, sl,
                                          cs, cl);
        else
          hop::softmax<T, BK, false, true>(p, sc, m, l, corr, rows, k0, t,
                                           sl, cs, cl);
      } else if (edge || !(sl > 0.f)) {
        hop::softmax<T, BK, true, false>(p, sc, m, l, corr, rows, k0, t, sl,
                                         cs, cl);
      } else {
        hop::softmax<T, BK, false, false>(p, sc, m, l, corr, rows, k0, t, sl,
                                          cs, cl);
      }
    }
    if (i > 0) {
      hop::wg_wait<0>();
#pragma unroll
      for (int j = 0; j < MAXC; ++j) hop::fence_regs(o[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          asm volatile("" : "+r"(pa[kk][x])::"memory");
      const int b0 = (i - 1) * CH + cb;
      if (lane == 0)
        for (int j = 0; j < nch; ++j)
          hop::mbar_arrive(bars.vempty((b0 + j) % RV));
    }
    if (i < n) {
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          o[j][4 * x] *= corr[0];
          o[j][4 * x + 1] *= corr[0];
          o[j][4 * x + 2] *= corr[1];
          o[j][4 * x + 3] *= corr[1];
        }
      // P's A fragments, p rounded to T: score tiles 2kk and 2kk + 1 are
      // the fragment of keys 16kk .. 16kk + 15
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][2 * (j % 2)] = hop::pack_f<T>(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][2 * (j % 2) + 1] =
            hop::pack_f<T>(sc[4 * j + 2], sc[4 * j + 3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  // acc / l as T from the registers, a column pair a 4-byte store (d % 8
  // == 0 and a 16-byte aligned o): no row past Sq, no column past d
  T* og = static_cast<T*>(p.o) + (long long)bh * p.Sq * p.d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.Sq) continue;
    T* orow = og + (long long)rows[h] * p.d;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j >= nch) continue;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int col = (cb + j) * 64 + 8 * x + 2 * t;
        if (col < p.d)
          *reinterpret_cast<typename Vec2<T>::type*>(orow + col) =
              to2<T>(o[j][4 * x + 2 * h] / l[h],
                     o[j][4 * x + 2 * h + 1] / l[h]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH, 1)
    flash_wide_wgmma_kernel(const __grid_constant__ Params p,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_hw[];
  const uint32_t raw = hop::smem_u32(smem_hw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Bars bars{base + SB};
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const int n = max(ke - kb, 0), CH = (p.d + 63) / 64;
  if (threadIdx.x == 0) {
    hop::mbar_init(bars.q(), 1);
    for (int s = 0; s < RK; ++s) {
      hop::mbar_init(bars.kfull(s), 1);
      hop::mbar_init(bars.kempty(s), 4);  // the reading warpgroup's warps
    }
    for (int s = 0; s < RV; ++s) {
      hop::mbar_init(bars.vfull(s), 1);
      hop::mbar_init(bars.vempty(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {  // producer warpgroup: two threads load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREG));
    const int pt = threadIdx.x - 128 * NC;
    if (pt == 0) {  // Q once, then the K boxes
      hop::mbar_expect_tx(bars.q(), CH * BOX);
      for (int c = 0; c < CH; ++c)
        hop::tma_load(base + c * BOX, &tq, 64 * c, q0, bh, bars.q());
      const Split sp(CH);
      produce<RK>(&tk, base + SK, bars.kfull(0), bars.kempty(0), kb, n,
                  2 * sp.sa, [&](int x) {  // position x: kpos(x % 2, x / 2)
                    const int c = x % 2 == 0 ? x / 2 : sp.sa + x / 2;
                    return c < CH ? c : -1;
                  }, bh);
    } else if (pt == 32) {  // the V boxes, in order
      produce<RV>(&tv, base + SV, bars.vfull(0), bars.vempty(0), kb, n, CH,
                  [](int x) { return x; }, bh);
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREG));
    consume<T>(p, q0, bh, kb, n, CH, base, smem_hw + (base - raw));
  }
}

template <typename T>
int launch(Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const long long blocks = (long long)p.nq * p.BH;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  constexpr CUtensorMapDataType ty = kF16<T>
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!hop::encode(&tq, ty, p.q, p.d, p.Sq, p.BH, BQ) ||
      !hop::encode(&tk, ty, p.k, p.d, p.Skv, p.BH, BK) ||
      !hop::encode(&tv, ty, p.v, p.d, p.Skv, p.BH, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  flash_wide_wgmma_kernel<T><<<(unsigned)blocks, NTH, SMEM, st>>>(p, tq, tk,
                                                                   tv);
  return (int)cudaGetLastError();
}

}  // namespace hw

// ---------------------------------------------------------------------------
// Thread-block clusters: what the two cluster kernels below share.  A
// cluster of C blocks takes one (query tile, bh); block r owns a share of
// d's 64-column chunks, computes a partial S over it, and the cluster sums
// the partials through distributed shared memory: in two rounds, each
// block sends each unit (4 scores a thread) of its partial to the block
// that owns the unit (st.async, counted in bytes on the owner's mbarrier),
// the owner adds the C partials in ascending rank and sends the sum to
// every block (the 16-bit kernel's pairs swap their partials in one
// round).  Every S element is summed in one order, so every block holds
// the same S bit for bit.

// widest head flash_wide_cluster takes (ops.CLUSTER_MAXD)
constexpr int CLUSTER_MAXD = 4096;

namespace cl {

__device__ __forceinline__ int rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// the blocks a cluster the last cluster launch ran with, as its grid's
// first block read them (repro_flash_cluster_seen)
__device__ int seen;

__device__ __forceinline__ void record(int C) {
  if (blockIdx.x == 0 && threadIdx.x == 0) seen = C;
}

// this block's shared-memory address ``addr`` in block ``r`` of the cluster
__device__ __forceinline__ uint32_t peer(uint32_t addr, int r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(addr), "r"(r));
  return a;
}

// 16 bytes to ``addr`` (from peer()), counted on the mbarrier ``bar`` of
// the same block
__device__ __forceinline__ void send(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// until the phase of parity ``parity`` of this block's ``bar`` has
// completed, with what the cluster's blocks sent to it visible
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// every thread of every block of the cluster
__device__ __forceinline__ void sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// N units dealt to the C blocks of a cluster in ranges: block r sums
// units [first(r), first(r + 1)); at most most() units a block
template <int N>
struct Deal {
  int C, rank;
  __device__ int first(int r) const { return r * N / C; }
  __device__ int owner(int u) const { return ((u + 1) * C - 1) / N; }
  __device__ int most() const { return (N + C - 1) / C; }
};

// The slot of unit u from block j among block r's (u's owner's)
// reduce-scatter slots: the other blocks' in rank order, most() a block
template <int N>
__device__ __forceinline__ int slot(const Deal<N>& dl, int j, int r, int u) {
  return (j < r ? j : j - 1) * dl.most() + u - dl.first(r);
}

// The sum of unit u: the partial ``mine`` of this block and those the
// other blocks sent (from ``rs``, slot() of 16 x ``lanes`` bytes, this
// thread's at ``lane``), added in ascending rank
template <int N>
__device__ __forceinline__ float4 total(const Deal<N>& dl, float4 mine,
                                        const unsigned char* rs, int u,
                                        int lanes, int lane) {
  float4 s = mine;
  for (int j = 0; j < dl.C; ++j) {
    const float4 x =
        j == dl.rank ? mine
                     : *reinterpret_cast<const float4*>(
                           rs + (slot(dl, j, dl.rank, u) * lanes + lane) * 16);
    s = j == 0 ? x : add(s, x);
  }
  return s;
}

// ``blocks`` blocks in clusters of C after raising the kernel's dynamic
// shared memory; a cluster that cannot be placed, or a refused launch,
// returns its CUDA error (no other kernel is tried)
template <typename K, typename... A>
int launch(K kernel, int blocks, int threads, int smem, int C,
           cudaStream_t st, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int placed = 0;
  e = cudaOccupancyMaxActiveClusters(&placed, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (placed < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cl

// ---------------------------------------------------------------------------
// 576 < d <= CLUSTER_MAXD at 16 bits on Hopper: flash_wide's block on a
// share of d, C blocks a query tile in a cluster, S summed once through
// distributed shared memory (a pair in one round, wider clusters in two)

namespace hc {

using hw::BK;
using hw::BOX;
using hw::BQ;
using hw::NC;
using hw::NTH;
using hw::PREG;
using hw::CREG;
constexpr int MAXCL = 8;              // blocks a cluster (portable)
constexpr int NB = 8;                 // 64-column chunks a block owns, at most
constexpr int MAXC = NB / 2;          // chunks of O a warpgroup, at most
constexpr int RK = 4;                 // K boxes in flight
constexpr int RV = NB;                // V boxes in flight: a whole tile's
constexpr int NG = BK / 2 / 4;        // units of a thread's scores: 4 each
constexpr int GB = 128 * 16;          // bytes of a unit over a warpgroup
// shared memory, from a 1024-byte aligned base: Q (NB boxes), the K ring,
// the V ring, the warpgroups' partial S, the exchange's 32 KB, the
// barriers (Q full; K full and empty; V full and empty; the exchange's
// two).  A cluster of 2 blocks sums in one round and takes the 32 KB as
// two tiles' buffers of the other block's partial; wider ones sum in two,
// into the reduce-scatter's slots ((C - 1) x ceil(NG / C) units, at most
// 8: C = 6 and 7 would need 10 and 12, so the kernel takes 8 blocks
// there) and the all-gathered S (NG units)
constexpr int SK = NB * BOX, SV = SK + RK * BOX, SX = SV + RV * BOX;
constexpr int SR = SX + NC * BQ * BK * 4;
constexpr int SA = SR + 8 * GB;
constexpr int SB = SA + NG * GB;
constexpr int SMEM = SB + 8 * (3 + 2 * RK + 2 * RV) + 1024;
static_assert(SMEM <= 232448, "shared memory");
static_assert(MAXCL * NB * 64 >= CLUSTER_MAXD, "reach");
static_assert(MAXCL <= NG, "every block sums at least one unit");

struct Bars {
  uint32_t bar;
  __device__ uint32_t q() const { return bar; }
  __device__ uint32_t kfull(int s) const { return bar + 8 * (1 + s); }
  __device__ uint32_t kempty(int s) const {
    return bar + 8 * (1 + RK + s);
  }
  __device__ uint32_t vfull(int s) const {
    return bar + 8 * (1 + 2 * RK + s);
  }
  __device__ uint32_t vempty(int s) const {
    return bar + 8 * (1 + 2 * RK + RV + s);
  }
  __device__ uint32_t rs() const {
    return bar + 8 * (1 + 2 * RK + 2 * RV);
  }
  __device__ uint32_t ag() const { return rs() + 8; }
};

// blocks a cluster for head dim d: the fewest whose shares of d's chunks
// hold NB each, 6 and 7 taken as 8 (their slots would not fit)
// (repro_flash_cluster_blocks)
inline int blocks_for(int d) {
  const int C = ((d + 63) / 64 + NB - 1) / NB;
  return C == 6 || C == 7 ? 8 : C;
}

template <typename T, int NCH>
__device__ __forceinline__ void values(float (&o)[MAXC][32],
                                       const uint32_t (&pa)[BK / 16][4],
                                       const uint32_t (&vs)[MAXC]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      hop::wgmma_rs<T>(o[j], pa[kk],
                       hop::desc(vs[j] + kk * 16 * 128, BOX, 1024));
}

// The cluster's S of a tile in two rounds, from this block's (in ``sc``,
// the same in both warpgroups): warpgroup wg sends units [4 wg, 4 wg + 4)
// of it to their owners, sums those it owns itself (C partials in
// ascending rank) and sends each sum to every block, itself included;
// then every thread reads the whole S.  Race-free with one buffer a
// round: a block sends tile i's partials only after it has all of tile
// i - 1's sums, so every block has read its tile i - 1 slots (its
// warpgroups met on the in-block exchange's barrier of tile i in
// between).
__device__ __forceinline__ void exchange(const cl::Deal<NG>& dl,
                                         float (&sc)[BK / 2], uint32_t base,
                                         const unsigned char* gbase, int wg,
                                         int tid, int i) {
  const Bars bars{base + SB};
  const int me = dl.rank, ob = dl.first(me), oe = dl.first(me + 1);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int r = dl.owner(g);
    if (g / (NG / 2) != wg || r == me) continue;
    cl::send(cl::peer(base + SR + (cl::slot(dl, me, r, g) * 128 + tid) * 16,
                      r),
             make_float4(sc[4 * g], sc[4 * g + 1], sc[4 * g + 2],
                         sc[4 * g + 3]),
             cl::peer(bars.rs(), r));
  }
  if (threadIdx.x == 0)
    hop::mbar_expect_tx(bars.rs(), (dl.C - 1) * (oe - ob) * GB);
  cl::wait(bars.rs(), i & 1);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g / (NG / 2) != wg || g < ob || g >= oe) continue;
    const float4 s = cl::total(
        dl,
        make_float4(sc[4 * g], sc[4 * g + 1], sc[4 * g + 2], sc[4 * g + 3]),
        gbase + SR, g, 128, tid);
    for (int r = 0; r < dl.C; ++r)
      cl::send(cl::peer(base + SA + (g * 128 + tid) * 16, r), s,
               cl::peer(bars.ag(), r));
  }
  if (threadIdx.x == 0) hop::mbar_expect_tx(bars.ag(), NG * GB);
  cl::wait(bars.ag(), i & 1);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(
        gbase + SA + (g * 128 + tid) * 16);
    sc[4 * g] = x.x;
    sc[4 * g + 1] = x.y;
    sc[4 * g + 2] = x.z;
    sc[4 * g + 3] = x.w;
  }
}

// The S of a tile of a cluster of 2 blocks in one round: each block sends
// its partial (warpgroup wg units [4 wg, 4 wg + 4)) to the other, into
// tile i's buffer (i % 2; counted on that buffer's mbarrier, bars.rs() or
// bars.ag()), and every thread adds the two partials in rank order
// itself: the same sum of the same bits in both blocks.  Two buffers
// suffice: a block sends tile i's partial only after it has the other's
// tile i - 1 partial, which that block sends only after both its
// warpgroups met on the in-block exchange's barrier of tile i - 1, past
// their reads of tile i - 2.
__device__ __forceinline__ void exchange_pair(int me, float (&sc)[BK / 2],
                                              uint32_t base,
                                              const unsigned char* gbase,
                                              int wg, int tid, int i) {
  const Bars bars{base + SB};
  const int b = i & 1;
  const uint32_t bar = b == 0 ? bars.rs() : bars.ag();
  const int buf = SR + b * NG * GB;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g / (NG / 2) != wg) continue;
    cl::send(cl::peer(base + buf + (g * 128 + tid) * 16, 1 - me),
             make_float4(sc[4 * g], sc[4 * g + 1], sc[4 * g + 2],
                         sc[4 * g + 3]),
             cl::peer(bar, 1 - me));
  }
  if (threadIdx.x == 0) hop::mbar_expect_tx(bar, NG * GB);
  cl::wait(bar, (i >> 1) & 1);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float4 mine =
        make_float4(sc[4 * g], sc[4 * g + 1], sc[4 * g + 2], sc[4 * g + 3]);
    const float4 other = *reinterpret_cast<const float4*>(
        gbase + buf + (g * 128 + tid) * 16);
    const float4 s = me == 0 ? cl::add(mine, other) : cl::add(other, mine);
    sc[4 * g] = s.x;
    sc[4 * g + 1] = s.y;
    sc[4 * g + 2] = s.z;
    sc[4 * g + 3] = s.w;
  }
}

// A consumer warpgroup: hw::consume on the block's CH chunks from chunk c0
// of d, the cluster's exchange after the in-block one
template <typename T>
__device__ __forceinline__ void consume(const Params& p, int q0, int bh,
                                        int kb, int n, int c0, int CH,
                                        const cl::Deal<NG>& dl,
                                        uint32_t base, unsigned char* gbase) {
  const Bars bars{base + SB};
  const uint32_t sQ = base, sK = base + SK, sV = base + SV;
  float* xs = reinterpret_cast<float*>(gbase + SX);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row = q0 + 16 * warp + lane / 4;
  const int rows[2] = {row, row + 8};
  const hw::Split sp(CH);
  const int s0 = wg == 0 ? 0 : sp.sa, sn = wg == 0 ? sp.sa : CH - sp.sa;
  const int cb = wg == 0 ? 0 : sp.ob, nch = wg == 0 ? sp.ob : CH - sp.ob;
  float* mine = xs + wg * BQ * BK + tid;
  const float* other = xs + (1 - wg) * BQ * BK + tid;
  const bool cap = p.softcap > 0.f;
  const float sl = p.scale * hop::LOG2E;
  const float cs = p.scale / p.softcap, lc = p.softcap * hop::LOG2E;
  float o[MAXC][32], sc[BK / 2], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[j][x] = 0.f;

  hop::mbar_wait(bars.q(), 0);
  for (int i = 0; i <= n; ++i) {
    if (i < n) {
      const uint32_t qs = hop::opaque(sQ);
      for (int j = 0; j < sn; ++j) {
        const int b = i * CH + hw::kpos(wg, j), s = b % RK;
        hop::mbar_wait(bars.kfull(s), (b / RK) & 1);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma_ss<T>(sc, hop::desc(qs + (s0 + j) * BOX + kk * 32, 16,
                                         1024),
                           hop::desc(sK + s * BOX + kk * 32, 16, 1024),
                           (j | kk) != 0);
        hop::wg_commit();
        if (j > 0) {
          hop::wg_wait<1>();
          if (lane == 0)
            hop::mbar_arrive(
                bars.kempty((i * CH + hw::kpos(wg, j - 1)) % RK));
        }
      }
    }
    if (i > 0) {  // O += P_{i-1} V_{i-1} on this warpgroup's chunks
      uint32_t vs[MAXC];
      const int b0 = (i - 1) * CH + cb;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int s = (b0 + j) % RV;
        vs[j] = sV + s * BOX;
        if (j < nch) hop::mbar_wait(bars.vfull(s), ((b0 + j) / RV) & 1);
      }
#pragma unroll
      for (int j = 0; j < MAXC; ++j) hop::fence_regs(o[j]);
      hop::wg_fence();
      if (nch == 2)
        values<T, 2>(o, pa, vs);
      else if (nch == 3)
        values<T, 3>(o, pa, vs);
      else
        values<T, 4>(o, pa, vs);
      hop::wg_commit();
    }
    if (i < n) {
      if (i > 0)
        hop::wg_wait<1>();
      else
        hop::wg_wait<0>();
      hop::fence_regs(sc);
      if (lane == 0)
        hop::mbar_arrive(bars.kempty((i * CH + hw::kpos(wg, sn - 1)) % RK));
      if (i > 0)
        asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(128 * NC)
                     : "memory");
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) mine[r * 128] = sc[r];
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) sc[r] += other[r * 128];
      if (i + 1 < n)
        asm volatile("bar.arrive %0, %1;\n" ::"r"(3 - wg), "n"(128 * NC)
                     : "memory");
      if (dl.C == 2)
        exchange_pair(dl.rank, sc, base, gbase, wg, tid, i);
      else
        exchange(dl, sc, base, gbase, wg, tid, i);
      const int k0 = (kb + i) * BK;
      const bool edge = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > q0) ||
                        (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
      if (cap) {
        if (edge)
          hop::softmax<T, BK, true, true>(p, sc, m, l, corr, rows, k0, t, sl,
                                          cs, lc);
        else
          hop::softmax<T, BK, false, true>(p, sc, m, l, corr, rows, k0, t,
                                           sl, cs, lc);
      } else if (edge || !(sl > 0.f)) {
        hop::softmax<T, BK, true, false>(p, sc, m, l, corr, rows, k0, t, sl,
                                         cs, lc);
      } else {
        hop::softmax<T, BK, false, false>(p, sc, m, l, corr, rows, k0, t, sl,
                                          cs, lc);
      }
    }
    if (i > 0) {
      hop::wg_wait<0>();
#pragma unroll
      for (int j = 0; j < MAXC; ++j) hop::fence_regs(o[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          asm volatile("" : "+r"(pa[kk][x])::"memory");
      const int b0 = (i - 1) * CH + cb;
      if (lane == 0)
        for (int j = 0; j < nch; ++j)
          hop::mbar_arrive(bars.vempty((b0 + j) % RV));
    }
    if (i < n) {
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          o[j][4 * x] *= corr[0];
          o[j][4 * x + 1] *= corr[0];
          o[j][4 * x + 2] *= corr[1];
          o[j][4 * x + 3] *= corr[1];
        }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        pa[j / 2][2 * (j % 2)] = hop::pack_f<T>(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][2 * (j % 2) + 1] =
            hop::pack_f<T>(sc[4 * j + 2], sc[4 * j + 3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  T* og = static_cast<T*>(p.o) + (long long)bh * p.Sq * p.d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= p.Sq) continue;
    T* orow = og + (long long)rows[h] * p.d;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j >= nch) continue;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int col = (c0 + cb + j) * 64 + 8 * x + 2 * t;
        if (col < p.d)
          *reinterpret_cast<typename Vec2<T>::type*>(orow + col) =
              to2<T>(o[j][4 * x + 2 * h] / l[h],
                     o[j][4 * x + 2 * h + 1] / l[h]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTH, 1)
    flash_wide_cluster_kernel(const __grid_constant__ Params p,
                              const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_hc[];
  const uint32_t raw = hop::smem_u32(smem_hc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Bars bars{base + SB};
  const cl::Deal<NG> dl{cl::size(), cl::rank()};
  cl::record(dl.C);
  // this block's chunks of d: [c0, c0 + nc)
  const int CH = (p.d + 63) / 64;
  const int c0 = dl.rank * CH / dl.C, nc = (dl.rank + 1) * CH / dl.C - c0;
  // the cluster's (query tile, bh), heaviest query tiles first
  const int tile = blockIdx.x / dl.C;
  const int qt = p.nq - 1 - tile / p.BH, bh = tile % p.BH;
  const int q0 = qt * BQ;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const int n = max(ke - kb, 0);
  if (threadIdx.x == 0) {
    hop::mbar_init(bars.q(), 1);
    for (int s = 0; s < RK; ++s) {
      hop::mbar_init(bars.kfull(s), 1);
      hop::mbar_init(bars.kempty(s), 4);
    }
    for (int s = 0; s < RV; ++s) {
      hop::mbar_init(bars.vfull(s), 1);
      hop::mbar_init(bars.vempty(s), 4);
    }
    hop::mbar_init(bars.rs(), 1);
    hop::mbar_init(bars.ag(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl::sync();  // every block's barriers before any block sends

  if (threadIdx.x >= 128 * NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREG));
    const int pt = threadIdx.x - 128 * NC;
    if (pt == 0) {  // Q's chunks once, then the K boxes
      hop::mbar_expect_tx(bars.q(), nc * BOX);
      for (int c = 0; c < nc; ++c)
        hop::tma_load(base + c * BOX, &tq, 64 * (c0 + c), q0, bh, bars.q());
      const hw::Split sp(nc);
      hw::produce<RK>(&tk, base + SK, bars.kfull(0), bars.kempty(0),
                         kb, n, 2 * sp.sa, [&](int x) {
                           const int c = x % 2 == 0 ? x / 2 : sp.sa + x / 2;
                           return c < nc ? c0 + c : -1;
                         }, bh);
    } else if (pt == 32) {
      hw::produce<RV>(&tv, base + SV, bars.vfull(0), bars.vempty(0),
                         kb, n, nc, [&](int x) { return c0 + x; }, bh);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREG));
    consume<T>(p, q0, bh, kb, n, c0, nc, dl, base, smem_hc + (base - raw));
  }
  cl::sync();  // no block leaves while a peer may still send to it
}

template <typename T>
int launch(Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const int C = blocks_for(p.d);
  if (C < 2 || C > MAXCL) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)p.nq * p.BH * C;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  constexpr CUtensorMapDataType ty = kF16<T>
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  if (!hop::encode(&tq, ty, p.q, p.d, p.Sq, p.BH, BQ) ||
      !hop::encode(&tk, ty, p.k, p.d, p.Skv, p.BH, BK) ||
      !hop::encode(&tv, ty, p.v, p.d, p.Skv, p.BH, BK))
    return (int)cudaErrorInvalidValue;
  return cl::launch(flash_wide_cluster_kernel<T>, (int)blocks, NTH, SMEM, C,
                    st, p, tq, tk, tv);
}

}  // namespace hc

// ---------------------------------------------------------------------------
// d > 256 at float32: one block a 64-row query tile with every output
// column, S = Q K^T once a key tile, split by keys across the warps that
// own the same rows' output slices; 3xTF32 on mma.sync m16n8k8

namespace fw {

constexpr int RG = 4;            // row groups of 16 query rows
constexpr int CG = 3;            // column groups: a warp's output slice
constexpr int NW = RG * CG;      // warps; warp w: rows w % RG, slice w / RG
constexpr int NT = 32 * NW;
constexpr int BQ = 16 * RG;      // query rows a block
constexpr int KW = 32;           // keys of a tile a warp's S covers
constexpr int BK = KW * CG;      // keys a tile
constexpr int VK = 32;           // keys of V a step
constexpr int CW = 64;           // columns of Q and K a step
constexpr int MAXD = 576;        // widest head (ops.WIDE_MAXD)
constexpr int NV = MAXD / CG / 8;  // 8-column tiles of a slice, at most
constexpr int LC = CW + 8;       // chunk rows in floats: the fragment
constexpr int LV = MAXD + 4;     // loads of a warp hit 32 distinct banks
constexpr int LP = BK + 8;
// a step's slot: a Q chunk and a K chunk, or VK rows of V
constexpr int SLOT = (BQ + BK) * LC > VK * LV ? (BQ + BK) * LC : VK * LV;
// 2 slots, then P (BQ x BK), then the column groups' row maxima (and at
// the end their l)
constexpr int SMEM = 4 * (2 * SLOT + BQ * LP + CG * BQ);

// Rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a (len, d) float32
// matrix into s[ROWS][LD] by 16-byte cp.async (the bases are 16-byte
// aligned and d % 8 == 0), zero at rows past len and columns past d
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage(uint32_t s, const float* g, int r0,
                                      int len, int c0, int d) {
  constexpr int CH = COLS / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 4;
    const bool ok = r0 + r < len && c0 + c < d;
    f32::cp_async16(s + 4 * (r * LD + c),
                    ok ? g + (long long)(r0 + r) * d + c0 + c : g, ok);
  }
}

// the logits of a warp's 16 x 32 scores in place, with expf's and tanhf's
// softcap, and their row maxima over the 4 lanes of a row; EDGE: keep()
// runs
template <bool EDGE>
__device__ __forceinline__ void logits(const Params& p, float (&sc)[KW / 8][4],
                                       float (&mx)[2], const int (&rows)[2],
                                       int k0, int t) {
  mx[0] = mx[1] = NEG_INF;
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float x = logit(p, sc[j][e]);
      if (EDGE && !keep(p, rows[h], k0 + 8 * j + 2 * t + (e & 1)))
        x = NEG_INF;
      sc[j][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// One block: query tile qt of head bh, every column.  Steps in order: for
// each key tile, CH steps of (Q chunk, K chunk), each warp adding its 32
// keys' share of S, then BK / VK steps of VK rows of V, each warp adding
// P V on its slice; step s + 1's copies are in flight while step s
// computes, one barrier a step.  After a tile's last S step each warp
// writes its rows' maxima; the row group's three warps take the tile's
// from them, write their p into P and meet on a named barrier.
__global__ void __launch_bounds__(NT, 1)
    flash_wide_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem_fw[];
  float* Ps = smem_fw + 2 * SLOT;
  float* red = Ps + BQ * LP;
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_fw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % RG, cg = warp / RG;
  int qt, bh;
  tile_of(p, qt, bh);
  const int q0 = qt * BQ, d = p.d;
  const float* q = static_cast<const float*>(p.q) + (long long)bh * p.Sq * d;
  const float* k = static_cast<const float*>(p.k) + (long long)bh * p.Skv * d;
  const float* v = static_cast<const float*>(p.v) + (long long)bh * p.Skv * d;
  float* o = static_cast<float*>(p.o) + (long long)bh * p.Sq * d;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const int CH = (d + CW - 1) / CW, SPT = CH + BK / VK;  // steps a tile
  const int n = ke > kb ? (ke - kb) * SPT : 0;
  // this warp's output slice: columns [c0, c0 + cw), nd 8-column tiles
  const int sw = (d + 8 * CG - 1) / (8 * CG) * 8;
  const int c0 = cg * sw, cw = min(sw, d - c0), nd = (cw + 7) / 8;
  const int w0 = q0 + 16 * rg;  // this warp's first query row
  const int rows[2] = {w0 + g, w0 + g + 8};

  auto issue = [&](int s) {  // step s's copies into slot s % 2
    const int i = s / SPT, r = s % SPT, k0 = (kb + i) * BK;
    const uint32_t a = s0 + 4 * (s % 2) * SLOT;
    if (r < CH) {
      stage<BQ, CW, LC>(a, q, q0, p.Sq, r * CW, d);
      stage<BK, CW, LC>(a + 4 * BQ * LC, k, k0, p.Skv, r * CW, d);
    } else {
      stage<VK, MAXD, LV>(a, v, k0 + (r - CH) * VK, p.Skv, 0, d);
    }
  };

  float acc[NV][4], sc[KW / 8][4], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
  bool edge = false;

  if (n > 0) issue(0);
  f32::cp_commit();
  for (int s = 0; s < n; ++s) {
    const int i = s / SPT, r = s % SPT, k0 = (kb + i) * BK;
    f32::cp_wait<0>();
    // step s's copies landed for every thread, and every thread is done
    // with step s - 1, whose slot is refilled now
    __syncthreads();
    if (s + 1 < n) issue(s + 1);
    f32::cp_commit();
    const float* a = smem_fw + (s % 2) * SLOT;
    const int kw0 = k0 + KW * cg;  // this warp's first key of S
    if (r < CH) {
      // S += Q_c K_c^T on this warp's 16 rows and 32 keys, 3xTF32 as
      // flash_f32_kernel: within a slice of 8 columns the fragments' k
      // index t is column 2t and t + 4 is 2t + 1; each slice's three
      // products go into fresh accumulators, added to S rounded to
      // nearest
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      const bool dead = kw0 >= p.Skv || (p.causal && kw0 > w0 + 15) ||
                        (p.window > 0 && w0 - (kw0 + KW - 1) >= p.window);
      if (!dead) {
        const float* Qw = a + 16 * rg * LC;
        const float* Kc = a + BQ * LC + KW * cg * LC;
        const int cols = d - r * CW;
#pragma unroll
        for (int kk = 0; kk < CW / 8; ++kk) {
          if (8 * kk < cols) {
            const float2 q0v = *reinterpret_cast<const float2*>(
                Qw + g * LC + 8 * kk + 2 * t);
            const float2 q1v = *reinterpret_cast<const float2*>(
                Qw + (g + 8) * LC + 8 * kk + 2 * t);
            uint32_t ah[4], al[4];
            f32::split(q0v.x, ah[0], al[0]);
            f32::split(q1v.x, ah[1], al[1]);
            f32::split(q0v.y, ah[2], al[2]);
            f32::split(q1v.y, ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < KW / 8; ++j) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  Kc + (8 * j + g) * LC + 8 * kk + 2 * t);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              f32::mma3(part, ah, al, kv.x, kv.y);
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] += part[e];
            }
          }
        }
      }
      if (r == CH - 1) {  // this warp's row maxima over its keys
        edge = dead || kw0 + KW > p.Skv || (p.causal && kw0 + KW - 1 > w0) ||
               (p.window > 0 && w0 + 15 - kw0 >= p.window);
        float mx[2];
        if (edge)
          logits<true>(p, sc, mx, rows, kw0, t);
        else
          logits<false>(p, sc, mx, rows, kw0, t);
        if (t == 0) {
          red[cg * BQ + 16 * rg + g] = mx[0];
          red[cg * BQ + 16 * rg + g + 8] = mx[1];
        }
      }
    } else {
      const int vs = r - CH;
      // the row group's rows keep no key of the tile
      const bool dead = (p.causal && k0 > w0 + 15) ||
                        (p.window > 0 && w0 - (k0 + BK - 1) >= p.window);
      if (vs == 0) {
        // the tile's row maxima (written before this step's barrier),
        // then p, its l and P; the slice rescaled
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mn = m[h];
#pragma unroll
          for (int c = 0; c < CG; ++c)
            mn = fmaxf(mn, red[c * BQ + 16 * rg + g + 8 * h]);
          corr[h] = expf(m[h] - mn);
          m[h] = mn;
          l[h] *= corr[h];
        }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float x = sc[j][e];
            float pe = expf(x - m[h]);
            if (edge && x == NEG_INF) pe = 0.f;
            sc[j][e] = pe;
            l[h] += pe;
          }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Ps + (16 * rg + g + 8 * h) * LP +
                                       KW * cg + 8 * j + 2 * t) =
                make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          acc[x][0] *= corr[0];
          acc[x][1] *= corr[0];
          acc[x][2] *= corr[1];
          acc[x][3] *= corr[1];
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(32 * CG)
                     : "memory");
      }
      if (!dead) {
        // O += P[:, VK vs ..] V_step on this warp's slice: P's k index t
        // is key 2t and t + 4 is 2t + 1 within each 8 keys (as in S), so
        // V's B fragment reads rows 2t and 2t + 1; each 8 keys' three
        // products go into fresh accumulators, added rounded to nearest
        const float* Pw = Ps + 16 * rg * LP + VK * vs;
#pragma unroll
        for (int j = 0; j < VK / 8; ++j) {
          const float2 p0 =
              *reinterpret_cast<const float2*>(Pw + g * LP + 8 * j + 2 * t);
          const float2 p1 = *reinterpret_cast<const float2*>(
              Pw + (g + 8) * LP + 8 * j + 2 * t);
          uint32_t ah[4], al[4];
          f32::split(p0.x, ah[0], al[0]);
          f32::split(p1.x, ah[1], al[1]);
          f32::split(p0.y, ah[2], al[2]);
          f32::split(p1.y, ah[3], al[3]);
          const float* vp = a + (8 * j + 2 * t) * LV + c0 + g;
#pragma unroll
          for (int x = 0; x < NV; ++x) {
            if (x < nd) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              f32::mma3(part, ah, al, vp[8 * x], vp[LV + 8 * x]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[x][e] += part[e];
            }
          }
        }
      }
    }
  }
  f32::cp_wait<0>();

  // l over the tile's keys: the row group's three warps'
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every read of red done
  if (t == 0) {
    red[cg * BQ + 16 * rg + g] = l[0];
    red[cg * BQ + 16 * rg + g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) lt += red[c * BQ + 16 * rg + g + 8 * h];
    l[h] = fmaxf(lt, 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = 8 * x + 2 * t + (e & 1);
      if (rows[h] < p.Sq && col < cw)
        o[(long long)rows[h] * d + c0 + col] = acc[x][e] / l[h];
    }
}

int launch(const Params& p, cudaStream_t st) {
  return ::launch(flash_wide_f32_kernel, BQ, NT, SMEM, p, st);
}

}  // namespace fw

// ---------------------------------------------------------------------------
// 576 < d <= CLUSTER_MAXD at float32: flash_wide_f32_kernel's block on a
// share of d, C blocks a query tile in a cluster, S summed once through
// distributed shared memory

namespace fc {

using fw::BK;
using fw::BQ;
using fw::CG;
using fw::CW;
using fw::KW;
using fw::LC;
using fw::LP;
using fw::NT;
using fw::NW;
using fw::RG;
using fw::VK;
constexpr int NB = 8;                  // 64-column chunks a block owns, at most
constexpr int MAXCL = 8;               // blocks a cluster (portable)
constexpr int MAXW = NB * CW;          // columns a block owns, at most
constexpr int NV = (MAXW + 8 * CG - 1) / (8 * CG);  // 8-column tiles a slice
constexpr int LV = MAXW + 4;           // loads of a warp hit 32 distinct banks
constexpr int SLOT = (BQ + BK) * LC > VK * LV ? (BQ + BK) * LC : VK * LV;
constexpr int NU = NW * KW / 8;        // units of a tile's S: a warp's 8 keys
constexpr int UB = 32 * 16;            // bytes of a unit: 4 floats a lane
// bytes: 2 slots, P, the column groups' row maxima (fw's); the
// reduce-scatter's slots ((C - 1) x ceil(NU / C) units, at most NU), the
// all-gathered units, the two rounds' barriers
constexpr int SR = 4 * (2 * SLOT + BQ * LP + CG * BQ);
constexpr int SA = SR + NU * UB;
constexpr int SB = SA + NU * UB;
constexpr int SMEM = SB + 16;
static_assert(SMEM <= 232448, "shared memory");
static_assert(MAXCL * MAXW >= CLUSTER_MAXD, "reach");

// blocks a cluster for head dim d: the fewest whose shares of d's chunks
// hold NB each (repro_flash_cluster_blocks)
inline int blocks_for(int d) { return ((d + CW - 1) / CW + NB - 1) / NB; }

// rows [r0, r0 + VK) and columns [c0, c1) of a (len, d) float32 matrix
// into s[VK][LV] by 16-byte cp.async (the bases are 16-byte aligned, d and
// c1 - c0 multiples of 8), zero at rows past len; columns past c1 are
// never read
__device__ __forceinline__ void stage_v(uint32_t s, const float* g, int r0,
                                        int len, int c0, int c1, int d) {
  const int units = (c1 - c0) / 4;
  for (int idx = threadIdx.x; idx < VK * units; idx += NT) {
    const int r = idx / units, c = (idx % units) * 4;
    const bool ok = r0 + r < len;
    f32::cp_async16(s + 4 * (r * LV + c),
                    ok ? g + (long long)(r0 + r) * d + c0 + c : g, ok);
  }
}

// One block: flash_wide_f32_kernel on columns [col0, col0 + W) of d (its
// chunks), the cluster's exchange of S after each tile's last S step:
// warp w's lanes send their units (4 w + j: its scores of keys 8 j ..
// 8 j + 7) to the owners, sum those the block owns (C partials in
// ascending rank), send each sum to the other blocks and read the rest.
// Race-free with one buffer a round: each unit's slot is read, and its
// sum sent, by the same thread, and a block sends tile i's partials only
// after it has all of tile i - 1's sums.
__global__ void __launch_bounds__(NT, 1)
    flash_wide_cluster_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem_fc[];
  float* Ps = smem_fc + 2 * SLOT;
  float* red = Ps + BQ * LP;
  const unsigned char* bytes = reinterpret_cast<const unsigned char*>(smem_fc);
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_fc));
  const uint32_t rsb = s0 + SB, agb = s0 + SB + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % RG, cg = warp / RG;
  const cl::Deal<NU> dl{cl::size(), cl::rank()};
  cl::record(dl.C);
  const int me = dl.rank, ob = dl.first(me), oe = dl.first(me + 1);
  const int d = p.d, CHD = (d + CW - 1) / CW;
  // this block's columns of d: chunks [k0c, k0c + CH)
  const int k0c = me * CHD / dl.C, CH = (me + 1) * CHD / dl.C - k0c;
  const int col0 = CW * k0c, W = min(d, CW * (k0c + CH)) - col0;
  const int tile = blockIdx.x / dl.C;
  const int qt = p.nq - 1 - tile / p.BH, bh = tile % p.BH;
  const int q0 = qt * BQ;
  const float* q = static_cast<const float*>(p.q) + (long long)bh * p.Sq * d;
  const float* k = static_cast<const float*>(p.k) + (long long)bh * p.Skv * d;
  const float* v = static_cast<const float*>(p.v) + (long long)bh * p.Skv * d;
  float* o = static_cast<float*>(p.o) + (long long)bh * p.Sq * d;
  int kb, ke;
  kv_range(p, q0, BQ, BK, kb, ke);
  const int SPT = CH + BK / VK;  // steps a tile
  const int n = ke > kb ? (ke - kb) * SPT : 0;
  // this warp's output slice of the block's columns: [c0, c0 + cw)
  const int sw = (W + 8 * CG - 1) / (8 * CG) * 8;
  const int c0 = cg * sw, cw = min(sw, W - c0), nd = (cw + 7) / 8;
  const int w0 = q0 + 16 * rg;
  const int rows[2] = {w0 + g, w0 + g + 8};
  if (threadIdx.x == 0) {
    hop::mbar_init(rsb, 1);
    hop::mbar_init(agb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cl::sync();  // every block's barriers before any block sends

  auto issue = [&](int s) {  // step s's copies into slot s % 2
    const int i = s / SPT, r = s % SPT, k0 = (kb + i) * BK;
    const uint32_t a = s0 + 4 * (s % 2) * SLOT;
    if (r < CH) {
      fw::stage<BQ, CW, LC>(a, q, q0, p.Sq, col0 + r * CW, d);
      fw::stage<BK, CW, LC>(a + 4 * BQ * LC, k, k0, p.Skv, col0 + r * CW, d);
    } else {
      stage_v(a, v, k0 + (r - CH) * VK, p.Skv, col0, col0 + W, d);
    }
  };

  float acc[NV][4], sc[KW / 8][4], m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
  bool edge = false;

  if (n > 0) issue(0);
  f32::cp_commit();
  for (int s = 0; s < n; ++s) {
    const int i = s / SPT, r = s % SPT, k0 = (kb + i) * BK;
    f32::cp_wait<0>();
    __syncthreads();
    if (s + 1 < n) issue(s + 1);
    f32::cp_commit();
    const float* a = smem_fc + (s % 2) * SLOT;
    const int kw0 = k0 + KW * cg;
    if (r < CH) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      }
      const bool dead = kw0 >= p.Skv || (p.causal && kw0 > w0 + 15) ||
                        (p.window > 0 && w0 - (kw0 + KW - 1) >= p.window);
      if (!dead) {
        const float* Qw = a + 16 * rg * LC;
        const float* Kc = a + BQ * LC + KW * cg * LC;
        const int cols = d - (col0 + r * CW);
#pragma unroll
        for (int kk = 0; kk < CW / 8; ++kk) {
          if (8 * kk < cols) {
            const float2 q0v = *reinterpret_cast<const float2*>(
                Qw + g * LC + 8 * kk + 2 * t);
            const float2 q1v = *reinterpret_cast<const float2*>(
                Qw + (g + 8) * LC + 8 * kk + 2 * t);
            uint32_t ah[4], al[4];
            f32::split(q0v.x, ah[0], al[0]);
            f32::split(q1v.x, ah[1], al[1]);
            f32::split(q0v.y, ah[2], al[2]);
            f32::split(q1v.y, ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < KW / 8; ++j) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  Kc + (8 * j + g) * LC + 8 * kk + 2 * t);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              f32::mma3(part, ah, al, kv.x, kv.y);
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[j][e] += part[e];
            }
          }
        }
      }
      if (r == CH - 1) {
        // the cluster's S: units to their owners, the owned ones summed
        // and sent back, the rest read
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int u = 4 * warp + j, to = dl.owner(u);
          if (to != me)
            cl::send(cl::peer(s0 + SR + (cl::slot(dl, me, to, u) * 32 +
                                         lane) * 16, to),
                     make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]),
                     cl::peer(rsb, to));
        }
        if (threadIdx.x == 0)
          hop::mbar_expect_tx(rsb, (dl.C - 1) * (oe - ob) * UB);
        cl::wait(rsb, i & 1);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int u = 4 * warp + j;
          if (u < ob || u >= oe) continue;
          const float4 x = cl::total(
              dl, make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]),
              bytes + SR, u, 32, lane);
          sc[j][0] = x.x;
          sc[j][1] = x.y;
          sc[j][2] = x.z;
          sc[j][3] = x.w;
          for (int to = 0; to < dl.C; ++to)
            if (to != me)
              cl::send(cl::peer(s0 + SA + (u * 32 + lane) * 16, to), x,
                       cl::peer(agb, to));
        }
        if (threadIdx.x == 0)
          hop::mbar_expect_tx(agb, (NU - (oe - ob)) * UB);
        cl::wait(agb, i & 1);
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int u = 4 * warp + j;
          if (u >= ob && u < oe) continue;
          const float4 x = *reinterpret_cast<const float4*>(
              bytes + SA + (u * 32 + lane) * 16);
          sc[j][0] = x.x;
          sc[j][1] = x.y;
          sc[j][2] = x.z;
          sc[j][3] = x.w;
        }
        edge = dead || kw0 + KW > p.Skv || (p.causal && kw0 + KW - 1 > w0) ||
               (p.window > 0 && w0 + 15 - kw0 >= p.window);
        float mx[2];
        if (edge)
          fw::logits<true>(p, sc, mx, rows, kw0, t);
        else
          fw::logits<false>(p, sc, mx, rows, kw0, t);
        if (t == 0) {
          red[cg * BQ + 16 * rg + g] = mx[0];
          red[cg * BQ + 16 * rg + g + 8] = mx[1];
        }
      }
    } else {
      const int vs = r - CH;
      const bool dead = (p.causal && k0 > w0 + 15) ||
                        (p.window > 0 && w0 - (k0 + BK - 1) >= p.window);
      if (vs == 0) {
        float corr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mn = m[h];
#pragma unroll
          for (int c = 0; c < CG; ++c)
            mn = fmaxf(mn, red[c * BQ + 16 * rg + g + 8 * h]);
          corr[h] = expf(m[h] - mn);
          m[h] = mn;
          l[h] *= corr[h];
        }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float x = sc[j][e];
            float pe = expf(x - m[h]);
            if (edge && x == NEG_INF) pe = 0.f;
            sc[j][e] = pe;
            l[h] += pe;
          }
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Ps + (16 * rg + g + 8 * h) * LP +
                                       KW * cg + 8 * j + 2 * t) =
                make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          acc[x][0] *= corr[0];
          acc[x][1] *= corr[0];
          acc[x][2] *= corr[1];
          acc[x][3] *= corr[1];
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(32 * CG)
                     : "memory");
      }
      if (!dead) {
        const float* Pw = Ps + 16 * rg * LP + VK * vs;
#pragma unroll
        for (int j = 0; j < VK / 8; ++j) {
          const float2 p0 =
              *reinterpret_cast<const float2*>(Pw + g * LP + 8 * j + 2 * t);
          const float2 p1 = *reinterpret_cast<const float2*>(
              Pw + (g + 8) * LP + 8 * j + 2 * t);
          uint32_t ah[4], al[4];
          f32::split(p0.x, ah[0], al[0]);
          f32::split(p1.x, ah[1], al[1]);
          f32::split(p0.y, ah[2], al[2]);
          f32::split(p1.y, ah[3], al[3]);
          const float* vp = a + (8 * j + 2 * t) * LV + c0 + g;
#pragma unroll
          for (int x = 0; x < NV; ++x) {
            if (x < nd) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              f32::mma3(part, ah, al, vp[8 * x], vp[LV + 8 * x]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[x][e] += part[e];
            }
          }
        }
      }
    }
  }
  f32::cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();
  if (t == 0) {
    red[cg * BQ + 16 * rg + g] = l[0];
    red[cg * BQ + 16 * rg + g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c) lt += red[c * BQ + 16 * rg + g + 8 * h];
    l[h] = fmaxf(lt, 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < NV; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = 8 * x + 2 * t + (e & 1);
      if (rows[h] < p.Sq && col < cw)
        o[(long long)rows[h] * d + col0 + c0 + col] = acc[x][e] / l[h];
    }
  cl::sync();  // no block leaves while a peer may still send to it
}

int launch(Params p, cudaStream_t st) {
  p.nq = (p.Sq + BQ - 1) / BQ;
  const int C = blocks_for(p.d);
  if (C < 2 || C > MAXCL) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)p.nq * p.BH * C;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return cl::launch(flash_wide_cluster_f32_kernel, (int)blocks, NT, SMEM, C,
                    st, p);
}

}  // namespace fc

// ---------------------------------------------------------------------------
// launch

template <int D>
int launch_f32(const Params& p, cudaStream_t st) {
  return launch(f32::flash_f32_kernel<D>, f32::BQ, 32 * f32::NW,
                f32::smem_bytes<D>(), p, st);
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

// What TMA can describe: 16-byte aligned bases, rows of a multiple of 16
// bytes at 16 bits (d % 8 == 0; the float32 wide kernel asks the same)
// and at least one key row.
bool tma_shape(const void* q, const void* k, const void* v, const void* o,
               int Skv, int d) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return d % 8 == 0 && addr % 16 == 0 && Skv > 0;
}

// The 16-bit entry points' choice: up to d = 256 the Hopper kernel
// (returns 0) where TMA can describe the tensors and the general kernel
// (-1) for the rest; above, where TMA can describe them, the wide Hopper
// kernel (-2) up to d = 576 and the cluster kernel (-4) up to
// CLUSTER_MAXD, the general wide kernel (-3) for the rest.  A choice by
// shape, not a fallback: a refused launch returns its error.
template <typename T>
int attn16(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int d, int causal, int window, float softcap,
           float scale, void* stream) {
  const Params p = make_params(q, k, v, o, BH, Sq, Skv, d, causal, window,
                               softcap, scale, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1) return (int)cudaErrorInvalidValue;
  const bool tma = tma_shape(q, k, v, o, Skv, d);
  if (d > 256) {  // S once a tile where TMA can describe the tensors
    const int key = !tma                   ? 3
                    : d <= hw::MAXD        ? 2
                    : d <= CLUSTER_MAXD    ? 4
                                           : 3;
    const int e = key == 2   ? hw::launch<T>(p, st)
                  : key == 4 ? hc::launch<T>(p, st)
                             : wide::launch<T>(p, st);
    return e != 0 ? e : -key;
  }
  if (tma) {
    if (d <= 64) return hop::launch<T, 64>(p, st);
    if (d <= 128) return hop::launch<T, 128>(p, st);
    return hop::launch<T, 256>(p, st);
  }
  const int e = d <= 64    ? hop::launch_general<T, 64>(p, st)
                : d <= 128 ? hop::launch_general<T, 128>(p, st)
                           : hop::launch_general<T, 256>(p, st);
  return e != 0 ? e : -1;
}

}  // namespace

// The entry points return a CUDA error code (positive), or minus the
// index of the kernel they launched (the wrapper counts the launch under
// that kernel's key):
//   float32:  0 flash_f32_kernel (d <= 256), -1 flash_wide_f32_kernel
//             (256 < d <= 576, what TMA could describe), -2
//             flash_wide_kernel (the rest above 256), -3
//             flash_wide_cluster_f32_kernel (576 < d <= CLUSTER_MAXD,
//             what TMA could describe);
//   bfloat16: 0 flash_wgmma_kernel, -1 flash_general_kernel, -2
//             flash_wide_wgmma_kernel, -3 flash_wide_kernel, -4
//             flash_wide_cluster_kernel;
//   float16:  the same five kernels at float16.
extern "C" int repro_flash_attn_f32(const void* q, const void* k,
                                    const void* v, void* o, int BH, int Sq,
                                    int Skv, int d, int causal, int window,
                                    float softcap, float scale,
                                    void* stream) {
  const Params p = make_params(q, k, v, o, BH, Sq, Skv, d, causal, window,
                               softcap, scale, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (d <= 64) return launch_f32<64>(p, st);
  if (d <= 128) return launch_f32<128>(p, st);
  if (d <= 256) return launch_f32<256>(p, st);
  // S once a tile where TMA could describe the tensors
  const bool tma = tma_shape(q, k, v, o, Skv, d);
  const int key = !tma                 ? 2
                  : d <= fw::MAXD      ? 1
                  : d <= CLUSTER_MAXD  ? 3
                                       : 2;
  const int e = key == 1   ? fw::launch(p, st)
                : key == 3 ? fc::launch(p, st)
                           : wide::launch<float>(p, st);
  return e != 0 ? e : -key;
}

extern "C" int repro_flash_attn_bf16(const void* q, const void* k,
                                     const void* v, void* o, int BH, int Sq,
                                     int Skv, int d, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  return attn16<bf16>(q, k, v, o, BH, Sq, Skv, d, causal, window, softcap,
                      scale, stream);
}

extern "C" int repro_flash_attn_f16(const void* q, const void* k,
                                    const void* v, void* o, int BH, int Sq,
                                    int Skv, int d, int causal, int window,
                                    float softcap, float scale,
                                    void* stream) {
  return attn16<f16>(q, k, v, o, BH, Sq, Skv, d, causal, window, softcap,
                     scale, stream);
}

// blocks a cluster flash_wide_cluster launches for head dim d (a multiple
// of 8 up to CLUSTER_MAXD) at elements of elem_bytes: the launch's own
// rule (hc::blocks_for at 16 bits, fc::blocks_for at float32)
extern "C" int repro_flash_cluster_blocks(int d, int elem_bytes) {
  return elem_bytes == 4 ? fc::blocks_for(d) : hc::blocks_for(d);
}

// the blocks a cluster the last flash_wide_cluster launch ran with, as
// its grid's first block read them from %cluster_nctarank, into *out (0
// where none ran since the last call); then 0 again
extern "C" int repro_flash_cluster_seen(int* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, cl::seen, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(cl::seen, &zero, sizeof(int));
}
