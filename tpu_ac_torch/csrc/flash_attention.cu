// Flash (streaming-softmax) attention forward for Hopper: the ViT trunk's
// attention_impl="flash" path.
//
// Replaces tpu_ac/kernels/attention.py:26 `flash_attention_impl`, which calls
// JAX's stock Pallas TPU flash kernel on a sequence padded to a multiple of
// 128 (and a head dim padded to 128 lanes).  For q, k, v [B, H, S, Dh] and an
// optional int32 segment-id vector ids [S] shared by the batch:
//
//     out[b, h, i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] * scale) v[b,h,j]
//
// over the keys j < S with ids[j] == ids[i] (every key without ids).  These
// are the stock kernel's segment semantics: a padded query row sees only the
// padded keys, and no row is ever fully masked, since it sees itself.  Any S
// is taken: the ragged last key tile (S = 785 = 12 * 64 + 17) is masked here;
// the TPU's 128-multiple was a tiling rule of the Pallas kernel.  Rows are
// addressed by (batch, head, sequence) strides, so q, k, v may be the strided
// views of a packed qkv projection and out may be the [B, S, H, Dh] layout
// the output projection reads.
//
// Two pairs of kernels: flash_fwd_bf16 / flash_fwd_f32 for Dh = 64 (every
// dino_vit* name; the wrapper zero-pads Dh < 64 to 64), and flash_wide_bf16
// / flash_wide_f32 for head dims over 64 (ViT-H/14's 80, CLIP bigG's 104, a
// 6-head 768-wide ViT's 128), each described below.
//
// Design of the bf16 variant at Dh = 64 (FlashAttention-2 style, mma.sync):
//   - A block owns a 128-row Q tile of one (b, h): 4 warps of 32 rows (128
//     threads); 8 warps of 16 rows ran as fast on the card
//     (scripts/kernel_ab.py variant fa_rows16; PERF.md).  At [8, 12, 785,
//     64] that is 7 x 96 = 672 blocks; at 3 blocks an SM (168 registers a
//     thread, 64 KB of shared memory a block) the 132 SMs take them in 1.70
//     waves, against 2.36 waves of 1,248 64-row blocks before.  In the last
//     Q tile (S = 785 leaves 17 of 128 rows) the warps without a valid row
//     only help with the copies.
//   - Q and the K/V tiles of 64 keys arrive by cp.async.cg 16-byte copies
//     (rows >= S zero-filled by the copy's source size) into a ring of 3 K/V
//     stages: tiles t+1 and t+2 load while tile t computes; one barrier a
//     tile.
//   - Shared memory rows are 128 B, their eight 16-byte chunks XOR-swizzled by
//     row & 7, so the cp.async stores and every ldmatrix (8 rows of one
//     logical chunk) touch 32 distinct banks.  Q's A fragments (read again at
//     every tile, which keeps a thread within 168 registers), K's B
//     fragments (ldmatrix.x4) and V's B fragments (ldmatrix.x4.trans on V as
//     it is stored) come from there; no transposing stores.
//   - QK^T and P.V run as mma.sync m16n8k16 bf16 with f32 accumulation.  The
//     score fragments stay in registers and become P.V's A operand, so P is
//     rounded to bf16 before P.V while l sums the unrounded f32 P.  Each row
//     keeps its max m and sum l in the log2 domain (scale * log2(e) folded
//     into the FFMA before a one-instruction ex2) and rescales its
//     accumulator by exp2(m_old - m_new); out = O / l is written once, in
//     bf16.
//   - Only the ragged last tile, and every tile of a call with segment ids
//     (template SEG), test keys one by one; full tiles take no predicate.
//   - A row that has seen no visible key yet has m = -inf; the exponentials
//     then subtract 0 instead of m, so exp2(-inf - -inf) never makes a NaN.
//
// Design of the f32 variant at Dh = 64 (precision="default"/"highest"): the
// same FlashAttention-2 structure on the tensor cores, with f32 accuracy from
// 3xTF32 (the technique of CUTLASS's OpMultiplyAddFastF32, written out here).
//   - Each f32 operand x splits into hi, x truncated to tf32, and lo = x -
//     hi, which the tensor cores truncate to tf32 (split_tf32).  a.b is
//     then d += a_lo.b_hi + a_hi.b_lo, then d += a_hi.b_hi, each an
//     mma.sync m16n8k8 tf32 with f32 accumulation; a_lo.b_lo (under 2^-20
//     relative) is dropped.
//     QK^T and P.V both run so; P is split in registers after the
//     exponentials while l sums the unsplit f32 P.
//   - A block owns a 128-row Q tile of one (b, h): 4 warps of 32 rows (two
//     m16 tiles each, so every K and V fragment loaded and split feeds 6
//     mma); 96 KB of shared memory (Q, and K/V tiles of 64 keys in a ring
//     of 2 stages) and at most 255 registers a thread give 2 blocks an SM.
//     8 warps of 16 rows spill at their 128 registers and ran 2% slower
//     (scripts/kernel_ab.py variant fa32_rows16; PERF.md, PR 8).
//   - f32 rows are 256 B, their sixteen 16-byte chunks XOR-swizzled by row &
//     7.  Q's A fragments and K's B fragments (row g, column t of 8 x 4-float
//     blocks) are exactly what ldmatrix gives for 32-bit elements; V's B
//     fragment (key t, column g) is not, and ldmatrix.trans cannot transpose
//     32-bit elements, so V is read by plain 32-bit loads.  The C fragment
//     of QK^T holds keys 2t and 2t+1 where P.V's A fragment wants keys t and
//     t+4, so P.V's k index is permuted instead of the registers: logical
//     key t is key 2t, logical key t+4 is key 2t+1, and V's rows are read in
//     that order.  Under the swizzle every ldmatrix and every V load touches
//     32 distinct banks.
//   - K and V are split per warp, in registers, as they are loaded.  Split
//     once a tile in shared memory instead (hi in place, lo in tiles of
//     their own: 160 KB, 1 block an SM, a second barrier a tile) they ran
//     15% slower (variant fa32_smem_split).  The online softmax, SEG, the
//     m = -inf guard and the ragged tiles are the bf16 variant's.
//
// Design of the kernels for head dims over 64 (flash_wide_*).  A block owns
// a query tile of one (b, h), keeps it resident in shared memory with every
// column, and walks the key tiles once: per (query tile, key tile) it sums
// QK^T over the whole head dim, runs the softmax once and P.V once into an
// output accumulator of every column.  One launch a call for Dh <= 256;
// only over 256 (no public ViT has such a head dim) does the wrapper launch
// once per 256-column slice of V and the output, each launch recomputing S.
// What the design does about the per-64-column-slice design it replaces:
//   1. S once: S was recomputed once per 64-column slice of V (2 launches
//      at Dh 80 and 128, 4 at 200); now once a call.
//   2. No pad to a multiple of 64: the wrapper pads Dh only to a multiple
//      of 8 (16-byte rows; 80, 104, 128, 200 go in as they are).  The bf16
//      kernel's QK^T steps 16 columns at a time (wgmma's bf16 depth) and its
//      P.V issues N = 16, 32, 48 or 64 per 64-column chunk, so Dh 80 does
//      80 columns of work in both (the shared-memory rows are padded to 128
//      columns by TMA's zero fill, which costs shared memory but no
//      tensor-core work); the f32 kernel steps 8 columns (mma.sync m16n8k8
//      tf32's depth) in both products.
//   3. Q resident: loaded once per block, not once per key tile.
//   4. bf16 on wgmma with TMA (mma.sync caps the tensor cores near two
//      thirds of their peak); f32 on mma.sync with O over every column.
//
//   bf16 (flash_wide_bf16<NV, SEG>): consumer warpgroups of 64 query rows
//   (3 at NV = 2, 2 at NV = 4) and a producer warpgroup whose one thread
//   issues every TMA load; setmaxnreg gives the consumers 152 / 232
//   registers a thread and the producer 40 (a lone producer warp would
//   cost a warpgroup's registers all the same: ptxas sizes them per 128
//   threads, and capped the consumers at 128 / 168, which spilled).
//     - Q [64 w x Dh], K and V tiles [64 keys x Dh] arrive by TMA (4-D
//       tensor maps over the strided [B, H, S, Dh] views, boxes of 64
//       columns x 64 w or 64 rows, 128-byte swizzle) as chunks of 64
//       columns; rows >= S and columns >= Dh are TMA's zero fill.  K/V tiles
//       go through a ring of up to 3 stages, each with a full mbarrier
//       (expect_tx) and an empty one (an arrival per consumer warp once its
//       wgmmas on the stage completed): the warpgroups never wait for each
//       other, so one's softmax overlaps another's wgmma.
//     - QK^T: wgmma m64n64k16, A = Q and B = K from shared memory, both
//       K-major; ceil(Dh / 16) steps into S (32 f32 registers a thread).
//     - The online softmax runs on S's accumulator fragment (a thread holds
//       rows g and g + 8 of its warp's 16, columns 8 n + 2 t, + 1) exactly as
//       at Dh = 64: log2 domain with f32 m and l, scale * log2(e) folded into
//       one FFMA before ex2, the m = -inf guard, segment ids (SEG) and the
//       ragged last tile masked one key at a time.
//     - P.V: A = P from registers (S's fragment rounded to bf16: the A
//       fragment of keys 16 j.. is S's n-tiles 2 j and 2 j + 1, as with
//       mma.sync), B = V from shared memory as it is stored (N-major,
//       wgmma's transpose bit for 16-bit types), one wgmma a 64-column chunk
//       and 16-key step; l sums the unrounded P; out = O / l rounded to bf16
//       once.
//     - Registers: O is NV x 32 f32 a thread (NV = 2 up to 128 columns, 4 up
//       to 256), S 32, P 16; ptxas -v: 128 (NV = 2) and 168 (NV = 4) at
//       entry, no spill.
//     - Shared memory: Q 64 w Dh' x 2 B and 3 stages of 64 Dh' x 4 B (K and
//       V), Dh' = Dh rounded up to 64: 145 KB at Dh <= 128; at <= 256, 2
//       warpgroups and 2 stages, 193 KB; 1 block an SM.  Where that does not
//       fit (Dh over 256: the Q tile of every column), the host takes fewer
//       stages and 1 warpgroup; past 768 columns nothing fits and the call
//       returns cudaErrorInvalidValue, which the wrapper raises.
//   f32 (flash_wide_f32<NV, SEG, D8>): 3xTF32 as at Dh = 64 (the order of
//   mma_3xtf32; P and V split by split_tf32, q and k by split_tf32_rn, see
//   there), on mma.sync m16n8k8.  Of the two routes
//   (wgmma tf32 takes B K-major only, so V would be transposed into shared
//   memory and its hi and lo parts kept there, which ran 15% slower at Dh =
//   64), mma.sync is taken:
//     - 8 warps of 16 query rows (256 threads): O over every column in
//       registers (NV x 8 n-tiles x 4 f32 a thread: 64 at Dh <= 128, 128 at
//       <= 256); Q's A fragments are read from shared memory at every step
//       (held in registers they made 16-row warps spill at Dh = 64).  32-row
//       warps ran slower here.
//     - A step's fragments load while the step before computes, and the
//       mma of a step run pass by pass (lo.hi of every n-tile, then hi.lo,
//       then hi.hi: each sum in mma_3xtf32's order).
//     - Dh 80, ViT-H/14's (the head dim of the repo's wide flash path), is
//       compiled in (D8 = Dh / 8, a fixed trip count for the column loops);
//       any other Dh reads it from the call (D8 = 0), which ran slower
//       (Dh 128 ran about 1.2x slower so than compiled in; PERF.md).
//     - Key tiles of 64 at NV = 2 (S 32 registers a thread), 32 at NV = 4,
//       through a ring of 2 stages by cp.async with the Dh = 64 kernel's
//       swizzle (row & 7 on 16-byte chunks), rows >= S and columns >= Dh
//       zero-filled by the copy's source size; Q resident, loaded once.
//     - Shared memory: Q 128 Dh' x 4 B, a stage BN Dh' x 8 B: 192 KB at Dh
//       <= 128 (1 block of 8 warps an SM); 1 stage, then 64-row blocks,
//       where that does not fit (192 KB at 256); past 512 columns nothing
//       does.  ptxas -v: 200-250 registers a thread, no spill.
//     - The softmax, P.V's permuted key order (V read by 32-bit loads), the
//       split of P after the exponentials while l sums the unsplit P are the
//       Dh = 64 f32 kernel's.
//
// Bounds at the main path's shape (B=8, H=12, S=785, Dh=64; H100 SXM at
// 700 W): operations 4*B*H*S^2*Dh = 15.14 GFLOP, 15.3 us at 989 TFLOP/s in
// bf16; f32: 3 x 15.14 GFLOP at the 495 TFLOP/s of TF32, 91.8 us (226 us
// at the 67 TFLOP/s of the f32 FMAs); bytes q, k, v read and out written
// once, 38.6 MB in bf16 (11.5 us at 3.35 TB/s), 77.2 MB in f32 (23.0 us);
// exponentials B*H*S^2 = 59.2 M, about 14 us at the SFU's 16 per clock per
// SM.  Both variants are bounded by operations; mma.sync (not wgmma) caps
// the tensor cores near two thirds of their peak.  Over 64, on the call's own
// Dh (not a padded width): at [8, 16, 785, 80] (ViT-H/14) 25.24 GFLOP, 25.5
// us in bf16 and 153.0 us in f32 (3xTF32), bytes 64.3 / 128.6 MB (19.2 /
// 38.4 us), exponentials 78.9 M (18.9 us); at [8, 6, 785, 128] 15.14 GFLOP,
// 15.3 us in bf16 and 91.8 us in f32, bytes 38.6 / 77.2 MB.  Operations
// bound all four.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper_common.cuh"

namespace {

constexpr int DH = 64;        // head dim (every dino_vit* name)
constexpr int BQ = 128;       // query rows per block
constexpr int WARP_ROWS = 32;  // bf16: query rows a warp (4 warps)
constexpr int BF16_THREADS = BQ / WARP_ROWS * 32;
constexpr int F32_BQ = 128;        // f32: query rows per block
constexpr int F32_WARP_ROWS = 32;  // f32: query rows a warp (4 warps)
constexpr int F32_THREADS = F32_BQ / F32_WARP_ROWS * 32;
constexpr int BN = 64;        // keys per K/V tile
constexpr int KV_STAGES = 3;  // bf16: K/V ring depth
constexpr int F32_STAGES = 2;  // f32: K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
// bf16 shared memory: the Q tile and KV_STAGES K and V tiles, 128-B rows
constexpr int BF16_SMEM = (BQ + 2 * KV_STAGES * BN) * DH * 2;
// f32: the Q tile and F32_STAGES K and V tiles, 256-B rows
constexpr int F32_SMEM = (F32_BQ + 2 * F32_STAGES * BN) * DH * 4;

struct Strides {
  long long b, h, s;  // elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* seg;  // [S] or nullptr
  Strides sq, sk, sv, so;
  int S;
  float c;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b for one m16n8k8 tile: tf32 operands (f32 bits, the low 13
// ignored), f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo in two instructions: hi is x truncated to tf32 (10 mantissa
// bits), lo = x - hi the exact rest (|lo| < 2^-10 |x|), which the tensor
// cores read truncated to tf32 too (they ignore the low 13 bits), so hi +
// lo keeps x to 2^-20 |x|.  Rounding hi to nearest (one op more) and lo as
// well (two more) ran 5% and 10% slower (PERF.md, PR 8).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The same with hi rounded to nearest (ties away): lo then takes either
// sign, so neither its truncation by the tensor cores nor the dropped
// lo.lo' term leans one way.  Truncated, each term of q.k errs toward zero
// by about 2^-21 of |q_i k_i|, and QK^T over a wide head sums Dh such
// errors of one sign: at Dh 320 that put the f32 kernel past
// flash_tolerance (chip_smoke.py).  The wide f32 kernel splits q and k so
// (one op more); P.V's errors follow the sign of each p v term, so they
// sum like the output itself, and P and V keep split_tf32.
__device__ __forceinline__ void split_tf32_rn(float x, uint32_t& hi,
                                              uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 3xTF32: d += a_lo . b_hi + a_hi . b_lo, then d += a_hi . b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// Element offset of 16-byte chunk `ch` of row `r` in a tile of DH-element
// rows of T, the chunks XOR-swizzled by r & 7 (a bf16 row has 8 chunks, an
// f32 row 16, whose low 3 bits the XOR moves).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * DH + (ch ^ (r & 7)) * (16 / static_cast<int>(sizeof(T)));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Rows [r0, r0 + ROWS) of one (b, h) slice into a swizzled shared tile by
// cp.async; rows >= S are zero-filled (source size 0, address clamped).
template <int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src,
                                                long long ss, int r0, int S) {
  constexpr int PER = 16 / sizeof(T);     // elements a chunk
  constexpr int SHIFT = PER == 8 ? 3 : 4;  // log2 of the chunks a row
#pragma unroll
  for (int c = threadIdx.x; c < ROWS << SHIFT; c += THREADS) {
    const int row = c >> SHIFT;
    const int ch = c & ((1 << SHIFT) - 1);
    const int n = r0 + row < S ? 16 : 0;
    const T* g = src + min(r0 + row, S - 1) * ss + ch * PER;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + swz<T>(row, ch))), "l"(g), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x in one MUFU instruction (exp2f adds denormal handling around it); a
// result below 2^-126 flushes to 0, far under the bf16 rounding of P.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 3 blocks an SM without segment ids (168 registers a thread); the
// segment-id instance takes 2, which it fills without spilling.
template <bool SEG>
__global__ void __launch_bounds__(BF16_THREADS, SEG ? 2 : 3)
    flash_fwd_bf16(Args a) {
  constexpr int THREADS = BF16_THREADS;
  constexpr int MT = WARP_ROWS / 16;  // m16 tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * DH;              // [KV_STAGES][BN * DH]
  __nv_bfloat16* vs = ks + KV_STAGES * BN * DH;  // [KV_STAGES][BN * DH]

  const int S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) +
                           b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) +
                           b * a.sv.b + h * a.sv.h;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b +
                     h * a.so.h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int wr = (threadIdx.x >> 5) * WARP_ROWS;  // the warp's first row
  const int n_kt = (S + BN - 1) / BN;

  // cp.async groups: Q with K/V tile 0, then one group a tile (empty past
  // the last), so "tile kt has landed" is always wait_group 1 at kt
  load_rows_async<BQ, THREADS>(qs, q, a.sq.s, q0, S);
  load_rows_async<BN, THREADS>(ks, k, a.sk.s, 0, S);
  load_rows_async<BN, THREADS>(vs, v, a.sv.s, 0, S);
  cp_async_commit();
  if (n_kt > 1) {
    load_rows_async<BN, THREADS>(ks + BN * DH, k, a.sk.s, BN, S);
    load_rows_async<BN, THREADS>(vs + BN * DH, v, a.sv.s, BN, S);
  }
  cp_async_commit();

  // rows of this thread: wr + 16 mt + g (+ 8); rows >= S are never stored
  int qid[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qid[mt][e] = SEG ? a.seg[min(q0 + wr + 16 * mt + g + 8 * e, S - 1)]
                       : 0;

  float acc[MT][DH / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    cp_async_wait<1>();  // tile kt has landed; kt + 1 may still fly
    __syncthreads();
    // tile kt + 2 goes to the stage of kt - 1, which every warp finished
    // before the barrier above; it flies while kt and kt + 1 compute
    if (kt + 2 < n_kt) {
      const int st = (kt + 2) % KV_STAGES;
      load_rows_async<BN, THREADS>(ks + st * BN * DH, k, a.sk.s, k0 + 2 * BN,
                                   S);
      load_rows_async<BN, THREADS>(vs + st * BN * DH, v, a.sv.s, k0 + 2 * BN,
                                   S);
    }
    cp_async_commit();
    // a warp whose rows all lie past S (the last Q tile: S = 785 leaves 17
    // rows of 128) only helps with the copies and the barriers
    if (q0 + wr >= S) continue;
    const __nv_bfloat16* kst = ks + (kt % KV_STAGES) * BN * DH;
    const __nv_bfloat16* vst = vs + (kt % KV_STAGES) * BN * DH;

    // scores of the warp's rows x 64 keys: 8 n-tiles of 8 keys; one
    // ldmatrix.x4 gives the B fragments of two n-tiles at one 16-deep step
    float s[MT][BN / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qf[MT][4];  // the warp's Q rows as A fragments
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qf[mt],
                qs + swz(wr + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kst + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                              2 * kk + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt], kb[2], kb[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // invisible keys (ragged tail, other segment) become -inf, tested
      // only where a key can be invisible; the scale into the log2 domain
      // folds into the exponentials' FFMA below (c > 0 keeps the max)
      if (SEG || k0 + BN > S) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            bool ok = col < S;
            if (SEG) ok = ok && a.seg[min(col, S - 1)] == qid[mt][e >> 1];
            if (!ok) s[mt][n][e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      // the 4 threads of a quad hold one row between them
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m[mt][0], mx0 * a.c);
      const float mn1 = fmaxf(m[mt][1], mx1 * a.c);
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = ex2(m[mt][0] - base0);
      const float corr1 = ex2(m[mt][1] - base1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        s[mt][n][0] = ex2(fmaf(s[mt][n][0], a.c, -base0));
        s[mt][n][1] = ex2(fmaf(s[mt][n][1], a.c, -base0));
        s[mt][n][2] = ex2(fmaf(s[mt][n][2], a.c, -base1));
        s[mt][n][3] = ex2(fmaf(s[mt][n][3], a.c, -base1));
        rs0 += s[mt][n][0] + s[mt][n][1];
        rs1 += s[mt][n][2] + s[mt][n][3];
      }
      // a per-thread partial sum; quads add at the end
      l[mt][0] = l[mt][0] * corr0 + rs0;
      l[mt][1] = l[mt][1] * corr1 + rs1;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[mt][d][0] *= corr0;
        acc[mt][d][1] *= corr0;
        acc[mt][d][2] *= corr1;
        acc[mt][d][3] *= corr1;
      }
    }

    // acc += P V over 4 steps of 16 keys: the C fragments of n-tiles 2j and
    // 2j+1 are the A fragment of key step j, rounded to bf16 here; one
    // ldmatrix.x4.trans gives the B fragments of two 8-wide d-tiles
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vst + swz(j * 16 + (lane & 15), 2 * dp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int i0 = q0 + wr + 16 * mt + g;
    const int i1 = i0 + 8;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (i0 < S)
        *reinterpret_cast<uint32_t*>(o + i0 * a.so.s + col) =
            pack_bf16(acc[mt][d][0] * inv0, acc[mt][d][1] * inv0);
      if (i1 < S)
        *reinterpret_cast<uint32_t*>(o + i1 * a.so.s + col) =
            pack_bf16(acc[mt][d][2] * inv1, acc[mt][d][3] * inv1);
    }
  }
}

// 2 blocks an SM (96 KB of shared memory each; at most 255 registers).
template <bool SEG>
__global__ void __launch_bounds__(F32_THREADS, 2) flash_fwd_f32(Args a) {
  constexpr int THREADS = F32_THREADS;
  constexpr int MT = F32_WARP_ROWS / 16;  // m16 tiles a warp
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + F32_BQ * DH;               // [F32_STAGES][BN * DH]
  float* vs = ks + F32_STAGES * BN * DH;  // [F32_STAGES][BN * DH]

  const int S = a.S;
  const int q0 = blockIdx.x * F32_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column
  const int wr = (threadIdx.x >> 5) * F32_WARP_ROWS;  // the warp's first row
  const int n_kt = (S + BN - 1) / BN;

  // cp.async groups: Q with K/V tile 0, then tile kt + 1 at tile kt, so
  // "tile kt has landed" is wait_group 0 at kt
  load_rows_async<F32_BQ, THREADS>(qs, q, a.sq.s, q0, S);
  load_rows_async<BN, THREADS>(ks, k, a.sk.s, 0, S);
  load_rows_async<BN, THREADS>(vs, v, a.sv.s, 0, S);
  cp_async_commit();

  int qid[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qid[mt][e] = SEG ? a.seg[min(q0 + wr + 16 * mt + g + 8 * e, S - 1)]
                       : 0;

  float acc[MT][DH / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      acc[mt][d][0] = acc[mt][d][1] = acc[mt][d][2] = acc[mt][d][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    cp_async_wait<0>();  // tile kt has landed
    __syncthreads();
    // tile kt + 1 goes to the stage of kt - 1, which every warp finished
    // before the barrier above; it flies while kt computes
    if (kt + 1 < n_kt) {
      const int st = (kt + 1) % F32_STAGES;
      load_rows_async<BN, THREADS>(ks + st * BN * DH, k, a.sk.s, k0 + BN, S);
      load_rows_async<BN, THREADS>(vs + st * BN * DH, v, a.sv.s, k0 + BN, S);
    }
    cp_async_commit();
    // a warp whose rows all lie past S only helps with the copies
    if (q0 + wr >= S) continue;
    const float* kst = ks + (kt % F32_STAGES) * BN * DH;
    const float* vst = vs + (kt % F32_STAGES) * BN * DH;

    // scores of the warp's rows x 64 keys: 8 n-tiles of 8 keys, 8 steps of
    // 8 dims; one ldmatrix.x4 gives the B fragments of two n-tiles
    float s[MT][BN / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      // A fragments of the warp's Q rows; matrix lane >> 3 takes rows + 8
      // if odd and the next chunk (columns + 4) if >= 2
      uint32_t qh[MT][4], ql[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qf[4];
        ldsm_x4(qf, qs + swz<float>(wr + 16 * mt + (lane & 7) +
                                        ((lane >> 3) & 1) * 8,
                                    2 * kk + (lane >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(qf[e]), qh[mt][e], ql[mt][e]);
      }
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        // matrices: keys + 0 or + 8 (lane >> 4), the chunk of columns + 0
        // or + 4 (lane >> 3 & 1): b0, b1 of n-tile 2 np, then of 2 np + 1
        uint32_t kb[4];
        ldsm_x4(kb, kst + swz<float>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(kb[e]), bh[e >> 1][e & 1],
                     bl[e >> 1][e & 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(s[mt][2 * np], qh[mt], ql[mt], bh[0], bl[0]);
          mma_3xtf32(s[mt][2 * np + 1], qh[mt], ql[mt], bh[1], bl[1]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (SEG || k0 + BN > S) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            bool ok = col < S;
            if (SEG) ok = ok && a.seg[min(col, S - 1)] == qid[mt][e >> 1];
            if (!ok) s[mt][n][e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][n][0], s[mt][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m[mt][0], mx0 * a.c);
      const float mn1 = fmaxf(m[mt][1], mx1 * a.c);
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = ex2(m[mt][0] - base0);
      const float corr1 = ex2(m[mt][1] - base1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        s[mt][n][0] = ex2(fmaf(s[mt][n][0], a.c, -base0));
        s[mt][n][1] = ex2(fmaf(s[mt][n][1], a.c, -base0));
        s[mt][n][2] = ex2(fmaf(s[mt][n][2], a.c, -base1));
        s[mt][n][3] = ex2(fmaf(s[mt][n][3], a.c, -base1));
        rs0 += s[mt][n][0] + s[mt][n][1];
        rs1 += s[mt][n][2] + s[mt][n][3];
      }
      l[mt][0] = l[mt][0] * corr0 + rs0;
      l[mt][1] = l[mt][1] * corr1 + rs1;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[mt][d][0] *= corr0;
        acc[mt][d][1] *= corr0;
        acc[mt][d][2] *= corr1;
        acc[mt][d][3] *= corr1;
      }
    }

    // acc += P V over 8 steps of 8 keys.  The C fragment of n-tile j holds
    // keys 8j + 2t and 8j + 2t + 1 of rows g and g + 8: it is step j's A
    // fragment with logical key t read as key 2t and t + 4 as 2t + 1, so
    // V's B fragment takes rows 8j + 2t and 8j + 2t + 1 at column g
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][j][0], ph[mt][0], pl[mt][0]);
        split_tf32(s[mt][j][2], ph[mt][1], pl[mt][1]);
        split_tf32(s[mt][j][1], ph[mt][2], pl[mt][2]);
        split_tf32(s[mt][j][3], ph[mt][3], pl[mt][3]);
      }
      const float* v0 = vst + (8 * j + 2 * t) * DH;  // row & 7 == 2t
      const float* v1 = v0 + DH;                     // row & 7 == 2t + 1
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        // column 8 dn + g is element g % 4 of chunk 2 dn + g / 4
        const int ch = 2 * dn + (g >> 2);
        uint32_t bh[2], bl[2];
        split_tf32(v0[((ch ^ (2 * t)) << 2) + (g & 3)], bh[0], bl[0]);
        split_tf32(v1[((ch ^ (2 * t + 1)) << 2) + (g & 3)], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32(acc[mt][dn], ph[mt], pl[mt], bh, bl);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int i0 = q0 + wr + 16 * mt + g;
    const int i1 = i0 + 8;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (i0 < S)
        *reinterpret_cast<float2*>(o + i0 * a.so.s + col) =
            make_float2(acc[mt][d][0] * inv0, acc[mt][d][1] * inv0);
      if (i1 < S)
        *reinterpret_cast<float2*>(o + i1 * a.so.s + col) =
            make_float2(acc[mt][d][2] * inv1, acc[mt][d][3] * inv1);
    }
  }
}

// ---- head dims over 64 (flash_wide_bf16, flash_wide_f32) ----

constexpr int W_THREADS = 256;     // 2 warpgroups / 8 warps; 128 for 64 rows
constexpr int W_BN = 64;           // bf16: keys a K/V tile
constexpr int W_BOX = W_BN * 128;  // bf16: one 64-key x 64-column box, 8 KB

// Consumer warpgroups (64 query rows each) of a flash_wide_bf16 block and
// their registers a thread after setmaxnreg, beside a producer warpgroup
// cut to W_PRODUCER_REGS: 3 at 152 while O takes 64 registers a thread
// (NV = 2), 2 at 232 at 128 (NV = 4); 128 x (40 + 3 x 152) and 128 x (40
// + 2 x 232) registers fit the SM's 65,536.
__host__ __device__ constexpr int wide_bf16_wgs(int nv) {
  return nv <= 2 ? 3 : 2;
}
__host__ __device__ constexpr int wide_bf16_regs(int nv) {
  return nv <= 2 ? 152 : 232;
}
// Keys a K/V tile of flash_wide_f32: 64 while O takes 64 registers a
// thread (S another 32), 32 at 128.
__host__ __device__ constexpr int wide_f32_bn(int nv) {
  return nv <= 2 ? 64 : 32;
}
constexpr int W_PRODUCER_REGS = 40;

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

struct WideArgs {
  const void* q;  // f32 only: the bf16 kernel reads q, k, v by TMA
  const void* k;
  const void* v;
  void* o;
  const int* seg;  // [S] or nullptr
  Strides sq, sk, sv, so;
  int S;
  int dqk, dv;  // columns of q and k, of v and o (multiples of 8)
  int nq, nv;   // 64-column chunks of a shared row of Q/K, of V
  int stages;   // K/V ring depth: 1 to 3 (bf16), 1 or 2 (f32)
  float c;      // scale * log2(e)
};

struct WideMaps {  // TMA descriptors of the bf16 q, k, v
  CUtensorMap q, k, v;
};

// TMA: the box at (column c0, row c1, head c2, batch c3) of `map` into
// shared memory `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows (Q, K), 128-byte
// swizzle, 1024-byte aligned: 1024 bytes between 8-row groups; a 16-deep
// step advances the start address by 32 bytes (+2).
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an N-major tile (V as stored: keys are rows, the N columns
// contiguous): 1024 bytes between groups of 8 keys, so a 16-key step
// advances the start address by 2048 bytes (+128).  Each wgmma reads N <= 64
// columns, one swizzle atom, so the offset between atoms along N is never
// used; both offset fields hold the 1024.
__device__ __forceinline__ uint64_t desc_nmajor(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Orders the compiler's reads and writes of an accumulator against the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// d (+)= A . B^T for one m64n64k16 step, A [64 x 16] (Q) and B [64 x 16] (K)
// bf16, both K-major in shared memory (descriptors a, b); scale_d == 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += P . V for one m64nNk16 step (N = 64, 48, 32, 16): A = P, bf16 from
// registers (each warp's 16 rows as the m16n8k16 A fragment), B = V [16
// keys x N] bf16 from shared memory, N-major (the transpose bit set); d's
// first N / 2 registers are the f32 accumulator fragment.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// P.V of one 16-key step into a 64-column chunk of which `w` columns (16,
// 32, 48 or 64) hold V; the chunk's other columns are not computed.
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int w) {
  if (w == 64) wgmma_rs_n64(d, a, b);
  else if (w == 48) wgmma_rs_n48(d, a, b);
  else if (w == 32) wgmma_rs_n32(d, a, b);
  else wgmma_rs_n16(d, a, b);
}

// Head dims over 64, bf16 on wgmma + TMA (see the top of the file).  NV:
// 64-column chunks of V and O the registers hold (2 or 4; a.nv <= NV are
// used).  Block: consumer warpgroups of 64 query rows each, and a producer
// warpgroup last, of which one thread issues the TMA.
template <int NV, bool SEG>
__global__ void __launch_bounds__(128 * (wide_bf16_wgs(NV) + 1), 1)
    flash_wide_bf16(const __grid_constant__ WideMaps maps,
                    const WideArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte tiles
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int consumers = blockDim.x - 128;
  const int bq = consumers >> 1;
  const int S = a.S, nq = a.nq, nv = a.nv, stages = a.stages;
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_kt = (S + W_BN - 1) / W_BN;
  const int stage_bytes = (nq + nv) * W_BOX;
  unsigned char* qs = base;                  // nq chunks of [bq x 64]
  unsigned char* kvs = base + nq * bq * 128;  // stages x (nq K, nv V boxes)
  // the mbarriers after the ring (all shared memory is dynamic: the
  // launch's limit is then the device's whole per-block limit)
  uint64_t* full = reinterpret_cast<uint64_t*>(kvs + stages * stage_bytes);
  uint64_t* empty = full + 3;
  uint64_t* qbar = full + 6;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], consumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= consumers) {  // the producer warpgroup: one thread issues
    setmaxnreg_dec<W_PRODUCER_REGS>();
    if (tid != consumers) return;
    mbar_expect_tx(qbar, nq * bq * 128);
    for (int c = 0; c < nq; ++c)
      tma_load4(qs + c * bq * 128, &maps.q, 64 * c, q0, h, b, qbar);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % stages;
      // the consumers have released the tile that held this stage before
      mbar_wait(&empty[st], ((kt / stages) & 1) ^ 1);
      unsigned char* dst = kvs + st * stage_bytes;
      mbar_expect_tx(&full[st], stage_bytes);
      for (int c = 0; c < nq; ++c)
        tma_load4(dst + c * W_BOX, &maps.k, 64 * c, kt * W_BN, h, b,
                  &full[st]);
      for (int c = 0; c < nv; ++c)
        tma_load4(dst + (nq + c) * W_BOX, &maps.v, 64 * c, kt * W_BN, h, b,
                  &full[st]);
    }
    return;
  }

  setmaxnreg_inc<wide_bf16_regs(NV)>();
  // consumers: this thread's rows (block-relative) r0 and r0 + 8
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;
  const bool active = q0 + wg * 64 < S;  // the warpgroup has a row < S
  int qid0 = 0, qid1 = 0;
  if (SEG) {
    qid0 = a.seg[min(q0 + r0, S - 1)];
    qid1 = a.seg[min(q0 + r0 + 8, S - 1)];
  }
  const int nk16 = (a.dqk + 15) >> 4;        // QK^T steps of 16 columns
  const int dv16 = (a.dv + 15) & ~15;        // P.V columns, 16 at a time
  float o[NV][32];
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int k = 0; k < 32; ++k) o[c][k] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float s[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) s[k] = 0.f;
  const uint64_t qd = desc_kmajor(qs + wg * 64 * 128);
  const int q_chunk16 = (bq * 128) >> 4;  // a Q chunk, in descriptor units

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % stages;
    mbar_wait(&full[st], (kt / stages) & 1);
    if (active) {
      const unsigned char* kst = kvs + st * stage_bytes;
      const uint64_t kd = desc_kmajor(kst);
      const uint64_t vd = desc_nmajor(kst + nq * W_BOX);

      // S = Q K^T over every column: steps of 16, chunk i / 4, 32-byte
      // offset i % 4 inside the chunk's 128-byte rows
      wgmma_fence();
      for (int i = 0; i < nk16; ++i) {
        const int c = i >> 2, kk = i & 3;
        wgmma_ss_n64(s, qd + c * q_chunk16 + 2 * kk,
                     kd + c * (W_BOX >> 4) + 2 * kk, i);
      }
      wgmma_commit_wait();
      fence_acc(s);

      // invisible keys (ragged tail, other segment) become -inf; the scale
      // into the log2 domain folds into the exponentials' FFMA (c > 0 keeps
      // the max)
      const int k0 = kt * W_BN;
      if (SEG || k0 + W_BN > S) {
#pragma unroll
        for (int n = 0; n < W_BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1);
            bool ok = col < S;
            if (SEG)
              ok = ok && a.seg[min(col, S - 1)] == (e & 2 ? qid1 : qid0);
            if (!ok) s[4 * n + e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < W_BN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      // the 4 threads of a quad hold one row between them
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * a.c);
      const float mn1 = fmaxf(m1, mx1 * a.c);
      const float base0 = mn0 == -INFINITY ? 0.f : mn0;
      const float base1 = mn1 == -INFINITY ? 0.f : mn1;
      const float corr0 = ex2(m0 - base0);
      const float corr1 = ex2(m1 - base1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int n = 0; n < W_BN / 8; ++n) {
        s[4 * n] = ex2(fmaf(s[4 * n], a.c, -base0));
        s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], a.c, -base0));
        s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], a.c, -base1));
        s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], a.c, -base1));
        rs0 += s[4 * n] + s[4 * n + 1];
        rs1 += s[4 * n + 2] + s[4 * n + 3];
      }
      // a per-thread partial sum; quads add at the end
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
#pragma unroll
      for (int c = 0; c < NV; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= corr0;
          o[c][4 * j + 1] *= corr0;
          o[c][4 * j + 2] *= corr1;
          o[c][4 * j + 3] *= corr1;
        }

      // P rounded to bf16: key step j (keys 16 j ..) is n-tiles 2 j, 2 j + 1
      uint32_t pa[W_BN / 16][4];
#pragma unroll
      for (int j = 0; j < W_BN / 16; ++j) {
        pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (c >= nv) break;
        const int w = min(64, dv16 - 64 * c);
#pragma unroll
        for (int j = 0; j < W_BN / 16; ++j)
          wgmma_pv(o[c], pa[j], vd + ((c * W_BOX + j * 2048) >> 4), w);
      }
      wgmma_commit_wait();
#pragma unroll
      for (int c = 0; c < NV; ++c) fence_acc(o[c]);
    }
    // this warp's reads of the stage are done (the wgmmas completed)
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int i0 = q0 + r0;
  const int i1 = i0 + 8;
  __nv_bfloat16* o_bh = static_cast<__nv_bfloat16*>(a.o) + b * a.so.b +
                        h * a.so.h;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (c >= nv) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t;
      if (col >= a.dv) continue;
      if (i0 < S)
        *reinterpret_cast<uint32_t*>(o_bh + i0 * a.so.s + col) =
            pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      if (i1 < S)
        *reinterpret_cast<uint32_t*>(o_bh + i1 * a.so.s + col) =
            pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
    }
  }
}

// Element offset of 16-byte chunk `ch` of row `r` in an f32 tile of rows of
// `len` floats (a multiple of 32), the chunks XOR-swizzled by r & 7 as at
// Dh = 64.
__device__ __forceinline__ int swz_w(int r, int ch, int len) {
  return r * len + ((ch ^ (r & 7)) << 2);
}

// Rows [r0, r0 + rows) of one (b, h) slice, `d` of their columns, into a
// swizzled f32 tile of rows of `len` floats by cp.async; rows >= S and
// columns >= d are zero-filled (source size 0, address clamped).  A thread
// copies chunks tid, tid + blockDim.x, ...: its row and chunk advance by
// constant steps, one division a call.
__device__ __forceinline__ void load_rows_w(float* dst, const float* src,
                                            long long ss, int r0, int rows,
                                            int S, int len, int d) {
  const int chunks = len >> 2;
  const int step_row = blockDim.x / chunks;
  const int step_ch = blockDim.x - step_row * chunks;
  int row = threadIdx.x / chunks;
  int ch = threadIdx.x - row * chunks;
  for (; row < rows; row += step_row, ch += step_ch) {
    if (ch >= chunks) {
      ch -= chunks;
      if (++row >= rows) break;
    }
    const bool ok = r0 + row < S && 4 * ch < d;
    const float* gp = src + min(r0 + row, S - 1) * ss + (ok ? 4 * ch : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + swz_w(row, ch, len))), "l"(gp),
                    "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// Head dims over 64, f32 in 3xTF32 on mma.sync (see the top of the file).
// NV: 64-column chunks of V and O the registers hold (2 or 4).  D8: the
// head dim / 8 when it is fixed at compile time (q, k and v of one width),
// else 0 and read from the call.  Block: blockDim.x / 2 query rows, a warp
// of 16.
template <int NV, bool SEG, int D8>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wide_f32(const WideArgs a) {
  constexpr int BNW = wide_f32_bn(NV);  // keys a K/V tile
  constexpr int PV_GROUP = 4;           // P.V's n-tiles a pass
  extern __shared__ __align__(128) unsigned char smem[];
  const int bq = blockDim.x >> 1;
  const int S = a.S, stages = a.stages;
  const int qlen = 64 * a.nq, vlen = 64 * a.nv;  // floats a shared row
  float* qs = reinterpret_cast<float*>(smem);  // [bq][qlen]
  float* ks = qs + bq * qlen;                  // [stages][BNW][qlen]
  float* vs = ks + stages * BNW * qlen;        // [stages][BNW][vlen]

  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int n_kt = (S + BNW - 1) / BNW;
  const int nk8 = D8 ? D8 : (a.dqk + 7) >> 3;  // QK^T steps of 8 columns
  const int nd8 = D8 ? D8 : (a.dv + 7) >> 3;   // P.V n-tiles of 8 columns

  auto load_tile = [&](int kt, int st) {
    load_rows_w(ks + st * BNW * qlen, k, a.sk.s, kt * BNW, BNW, S, qlen,
                a.dqk);
    load_rows_w(vs + st * BNW * vlen, v, a.sv.s, kt * BNW, BNW, S, vlen,
                a.dv);
  };
  // cp.async groups: Q (with tile 0 for 2 stages), then one a tile
  load_rows_w(qs, q, a.sq.s, q0, bq, S, qlen, a.dqk);
  if (stages == 2) load_tile(0, 0);
  cp_async_commit();

  int qid0 = 0, qid1 = 0;
  if (SEG) {
    qid0 = a.seg[min(q0 + wr + g, S - 1)];
    qid1 = a.seg[min(q0 + wr + g + 8, S - 1)];
  }
  float acc[NV * 8][4];
#pragma unroll
  for (int d = 0; d < NV * 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // ldmatrix addresses: Q's matrix lane >> 3 takes rows + 8 if odd and the
  // next chunk (columns + 4) if >= 2; K's takes keys + 8 if >= 2 and the
  // next chunk if odd: b0, b1 of n-tile 2 np, then of 2 np + 1
  const float* qrow = qs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * qlen;
  const int q_ch = lane >> 4, q_sw = lane & 7;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_ch = (lane >> 3) & 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (stages == 1) {  // every warp is done with tile kt - 1
      __syncthreads();
      load_tile(kt, 0);
      cp_async_commit();
    }
    cp_async_wait<0>();  // tile kt has landed
    __syncthreads();
    // 2 stages: tile kt + 1 goes to the stage of kt - 1, which every warp
    // finished before the barrier above; it flies while kt computes
    if (stages == 2) {
      if (kt + 1 < n_kt) load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
    }
    // a warp whose rows all lie past S only helps with the copies
    if (q0 + wr >= S) continue;
    const int st = stages == 2 ? kt & 1 : 0;
    const float* kst = ks + st * BNW * qlen;
    const float* vst = vs + st * BNW * vlen;

    // scores of the warp's 16 rows x BNW keys: n-tiles of 8 keys, steps of
    // 8 columns over every column of q and k.  A step's fragments are
    // loaded while the step before computes, and its mma run pass by pass
    // over the n-tiles (each sum keeps mma_3xtf32's order: lo.hi, hi.lo,
    // hi.hi), so no mma waits on the one before
    float s[BNW / 8][4];
#pragma unroll
    for (int n = 0; n < BNW / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    uint32_t qf[4], kb[BNW / 16][4];
    auto load_step = [&](int kk) {
      ldsm_x4(qf, qrow + (((2 * kk + q_ch) ^ q_sw) << 2));
#pragma unroll
      for (int np = 0; np < BNW / 16; ++np)
        ldsm_x4(kb[np], kst + swz_w(np * 16 + k_row, 2 * kk + k_ch, qlen));
    };
    load_step(0);
#pragma unroll 2
    for (int kk = 0; kk < nk8; ++kk) {
      uint32_t qh[4], ql[4], bh[BNW / 8][2], bl[BNW / 8][2];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32_rn(__uint_as_float(qf[e]), qh[e], ql[e]);
#pragma unroll
      for (int np = 0; np < BNW / 16; ++np)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32_rn(__uint_as_float(kb[np][e]), bh[2 * np + (e >> 1)][e & 1],
                     bl[2 * np + (e >> 1)][e & 1]);
      if (kk + 1 < nk8) load_step(kk + 1);
#pragma unroll
      for (int n = 0; n < BNW / 8; ++n) mma_tf32(s[n], ql, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < BNW / 8; ++n) mma_tf32(s[n], qh, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < BNW / 8; ++n) mma_tf32(s[n], qh, bh[n][0], bh[n][1]);
    }

    const int k0 = kt * BNW;
    if (SEG || k0 + BNW > S) {
#pragma unroll
      for (int n = 0; n < BNW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = col < S;
          if (SEG) ok = ok && a.seg[min(col, S - 1)] == (e & 2 ? qid1 : qid0);
          if (!ok) s[n][e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BNW / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * a.c);
    const float mn1 = fmaxf(m1, mx1 * a.c);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = ex2(m0 - base0);
    const float corr1 = ex2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BNW / 8; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], a.c, -base0));
      s[n][1] = ex2(fmaf(s[n][1], a.c, -base0));
      s[n][2] = ex2(fmaf(s[n][2], a.c, -base1));
      s[n][3] = ex2(fmaf(s[n][3], a.c, -base1));
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int d = 0; d < NV * 8; ++d) {
      acc[d][0] *= corr0;
      acc[d][1] *= corr0;
      acc[d][2] *= corr1;
      acc[d][3] *= corr1;
    }

    // acc += P V over steps of 8 keys, P's key order permuted as at Dh =
    // 64: logical key t is key 2t, t + 4 is 2t + 1, so V's B fragment takes
    // rows 8j + 2t and 8j + 2t + 1 at column 8 dn + g
#pragma unroll
    for (int j = 0; j < BNW / 8; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = vst + (8 * j + 2 * t) * vlen;  // row & 7 == 2t
      const float* v1 = v0 + vlen;                     // row & 7 == 2t + 1
      // PV_GROUP n-tiles at a time, pass by pass as in QK^T
#pragma unroll
      for (int d0 = 0; d0 < NV * 8; d0 += PV_GROUP) {
        if (d0 >= nd8) break;
        uint32_t bh[PV_GROUP][2], bl[PV_GROUP][2];
#pragma unroll
        for (int i = 0; i < PV_GROUP; ++i) {
          // column 8 dn + g is element g % 4 of chunk 2 dn + g / 4
          const int ch = 2 * (d0 + i) + (g >> 2);
          split_tf32(v0[((ch ^ (2 * t)) << 2) + (g & 3)], bh[i][0], bl[i][0]);
          split_tf32(v1[((ch ^ (2 * t + 1)) << 2) + (g & 3)], bh[i][1],
                     bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < PV_GROUP; ++i)
          if (d0 + i < nd8) mma_tf32(acc[d0 + i], pl, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < PV_GROUP; ++i)
          if (d0 + i < nd8) mma_tf32(acc[d0 + i], ph, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < PV_GROUP; ++i)
          if (d0 + i < nd8) mma_tf32(acc[d0 + i], ph, bh[i][0], bh[i][1]);
      }
    }
  }
  if (q0 + wr >= S) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int i0 = q0 + wr + g;
  const int i1 = i0 + 8;
#pragma unroll
  for (int d = 0; d < NV * 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= a.dv) break;
    if (i0 < S)
      *reinterpret_cast<float2*>(o + i0 * a.so.s + col) =
          make_float2(acc[d][0] * inv0, acc[d][1] * inv0);
    if (i1 < S)
      *reinterpret_cast<float2*>(o + i1 * a.so.s + col) =
          make_float2(acc[d][2] * inv1, acc[d][3] * inv1);
  }
}

}  // namespace

// Launches `kernel` with SMEM bytes of dynamic shared memory; the limit is
// raised once per device (a driver call that cost host time at every call).
template <int SMEM>
static cudaError_t launch(void (*kernel)(Args), bool (&raised)[64],
                          const Args& a, dim3 grid, int threads,
                          cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  kernel<<<grid, threads, SMEM, s>>>(a);
  return cudaGetLastError();
}

template <bool SEG>
static cudaError_t launch_bf16(const Args& a, dim3 grid, cudaStream_t s) {
  static bool raised[64];
  return launch<BF16_SMEM>(&flash_fwd_bf16<SEG>, raised, a, grid,
                           BF16_THREADS, s);
}

template <bool SEG>
static cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t s) {
  static bool raised[64];
  return launch<F32_SMEM>(&flash_fwd_f32<SEG>, raised, a, grid, F32_THREADS,
                          s);
}

// A 4-D map over the bf16 view [B, H, S, d] (element strides st; the
// driver takes them in any order, as a packed qkv view has them), boxes
// of 64 columns x box_rows rows of one (b, h), 128-byte swizzle; rows >= S
// and columns >= d load as zeros.  A dim of extent 1 is never stepped, so
// its stride, which the wrapper does not check, becomes 16 bytes (TMA
// wants multiples of 16).
static bool make_map4(CUtensorMap* map, const void* base, int d, int S,
                      int H, int B, const Strides& st, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      S > 1 ? (cuuint64_t)st.s * 2 : 16, H > 1 ? (cuuint64_t)st.h * 2 : 16,
      B > 1 ? (cuuint64_t)st.b * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory of a wide block of bq query rows with a ring of `stages`
// K/V tiles (nq, nv: 64-column chunks of a Q/K and of a V row).
static int wide_smem(bool bf16, int nq, int nv, int bq, int stages) {
  if (bf16)  // + 1 KB to align the tiles to 1024 bytes, + the mbarriers
    return 1024 + nq * bq * 128 + stages * (nq + nv) * W_BN * 128 + 56;
  return nq * bq * 256 + stages * (nq + nv) * wide_f32_bn(nv > 2 ? 4 : 2) * 256;
}

// Raises `kernel`'s dynamic shared memory limit to the device's once per
// device; the launch then asks for what it needs.
static cudaError_t raise_smem(const void* kernel, bool (&raised)[64],
                              int dev, int max_smem) {
  if (dev < 64 && raised[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess && dev < 64) raised[dev] = true;
  return err;
}

template <int NV>
static cudaError_t launch_wide_bf16(const WideMaps& maps, const WideArgs& a,
                                    dim3 grid, int threads, int smem,
                                    int dev, int max_smem, cudaStream_t s) {
  static bool raised[2][64];
  auto kernel = a.seg ? &flash_wide_bf16<NV, true>
                      : &flash_wide_bf16<NV, false>;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(kernel),
                               raised[a.seg != nullptr], dev, max_smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(maps, a);
  return cudaGetLastError();
}

template <int NV, int D8>
static cudaError_t launch_wide_f32(const WideArgs& a, dim3 grid, int threads,
                                   int smem, int dev, int max_smem,
                                   cudaStream_t s) {
  static bool raised[2][64];
  auto kernel = a.seg ? &flash_wide_f32<NV, true, D8>
                      : &flash_wide_f32<NV, false, D8>;
  cudaError_t err = raise_smem(reinterpret_cast<const void*>(kernel),
                               raised[a.seg != nullptr], dev, max_smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// One launch of a wide kernel.  Its block and ring depth are the first
// that fits the device's shared memory a block: bf16, the instance's
// consumer warpgroups (wide_bf16_wgs) or 1 (64 rows) with a ring of 3 or
// 2 stages, then 1 stage; f32, 128 rows with 2 stages, then 1 stage, then
// 64 rows likewise (one block of 128 rows and 1 stage ran faster than one
// of 64 rows and 2 at Dh 200).  None fits: cudaErrorInvalidValue.
static cudaError_t launch_wide(const WideArgs& a0, const void* q,
                               const void* k, const void* v, int B, int H,
                               bool bf16, cudaStream_t s) {
  static int max_smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int limit = dev < 64 ? max_smem[dev] : 0;
  if (limit == 0) {
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) max_smem[dev] = limit;
  }
  WideArgs a = a0;
  const int wgs = wide_bf16_wgs(a.nv > 2 ? 4 : 2);
  const int bf16_plans[6][2] = {{wgs * 64, 3}, {wgs * 64, 2}, {64, 3},
                                {64, 2},       {wgs * 64, 1}, {64, 1}};
  const int f32_plans[4][2] = {{128, 2}, {128, 1}, {64, 2}, {64, 1}};
  const int n_plans = bf16 ? 6 : 4;
  int bq = 0, smem = 0;
  for (int i = 0; i < n_plans; ++i) {
    const int* p = bf16 ? bf16_plans[i] : f32_plans[i];
    smem = wide_smem(bf16, a.nq, a.nv, p[0], p[1]);
    if (smem <= limit) {
      bq = p[0];
      a.stages = p[1];
      break;
    }
  }
  if (bq == 0) return cudaErrorInvalidValue;
  const bool nv4 = a.nv > 2;
  const dim3 grid((a.S + bq - 1) / bq, H, B);
  if (!bf16) {  // a warp of 16 rows
    const int threads = 2 * bq;
    if (nv4)
      return launch_wide_f32<4, 0>(a, grid, threads, smem, dev, limit, s);
    // the head dim compiled in: ViT-H/14's 80
    if (a.dqk == 80 && a.dv == 80)
      return launch_wide_f32<2, 10>(a, grid, threads, smem, dev, limit, s);
    return launch_wide_f32<2, 0>(a, grid, threads, smem, dev, limit, s);
  }
  // 128 threads a consumer warpgroup of 64 rows, and the producer's
  const int threads = 2 * bq + 128;
  WideMaps maps;
  if (!make_map4(&maps.q, q, a.dqk, a.S, H, B, a.sq, bq) ||
      !make_map4(&maps.k, k, a.dqk, a.S, H, B, a.sk, W_BN) ||
      !make_map4(&maps.v, v, a.dv, a.S, H, B, a.sv, W_BN))
    return cudaErrorInvalidValue;
  return nv4 ? launch_wide_bf16<4>(maps, a, grid, threads, smem, dev, limit, s)
             : launch_wide_bf16<2>(maps, a, grid, threads, smem, dev, limit, s);
}

// C interface bound with ctypes by tpu_ac_torch/kernels/attention.py.
// q, k: [B, H, S, dqk], v, o: [B, H, S, dv], of bf16 (is_bf16 != 0) or f32,
// addressed by the 12 element strides in `strides` (q, k, v, o, each as
// batch, head, sequence; the last dim is contiguous, every row 16-byte
// aligned).  dqk = dv = 64 runs the Dh = 64 kernels; dqk over 64 (a
// multiple of 8) with dv a multiple of 8 up to 256 (all of V, or the
// wrapper's 256-column slice of it) runs the wide ones.  seg: int32 [S]
// segment ids on the device, or null.  Launches on `stream`, does not
// synchronize, returns cudaGetLastError() (cudaErrorInvalidValue for
// widths no kernel takes).
extern "C" int tpu_ac_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, const int* seg,
                                      const long long* strides, int B, int H,
                                      int S, int dqk, int dv, float scale,
                                      int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaSuccess;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dqk == DH && dv == DH) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.seg = seg;
    a.sq = sq;
    a.sk = sk;
    a.sv = sv;
    a.so = so;
    a.S = S;
    a.c = scale * LOG2E;
    if (!is_bf16) {
      const dim3 grid((S + F32_BQ - 1) / F32_BQ, H, B);
      return (int)(seg ? launch_f32<true>(a, grid, s)
                       : launch_f32<false>(a, grid, s));
    }
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    return (int)(seg ? launch_bf16<true>(a, grid, s)
                     : launch_bf16<false>(a, grid, s));
  }
  if (dqk <= DH || dqk % 8 || dv <= 0 || dv % 8 || dv > 4 * 64)
    return (int)cudaErrorInvalidValue;
  WideArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.seg = seg;
  a.sq = sq;
  a.sk = sk;
  a.sv = sv;
  a.so = so;
  a.S = S;
  a.dqk = dqk;
  a.dv = dv;
  a.nq = (dqk + 63) / 64;
  a.nv = (dv + 63) / 64;
  a.stages = 2;
  a.c = scale * LOG2E;
  return (int)launch_wide(a, q, k, v, B, H, is_bf16 != 0, s);
}
