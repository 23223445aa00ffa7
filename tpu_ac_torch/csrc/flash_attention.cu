// Flash (streaming-softmax) attention forward for Hopper: the ViT trunk's
// attention_impl="flash" path.
//
// Replaces tpu_ac/kernels/attention.py:26 `flash_attention_impl`, which calls
// JAX's stock Pallas TPU flash kernel on a sequence padded to a multiple of
// 128.  For q, k, v [B, H, S, 64] (wider head dims below) and an optional
// int32 segment-id vector ids [S] shared by the batch:
//
//     out[b, h, i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] * scale) v[b,h,j]
//
// over the keys j < S with ids[j] == ids[i] (every key without ids).  These
// are the stock kernel's segment semantics: a padded query row sees only the
// padded keys, and no row is ever fully masked, since it sees itself.  Any S
// is taken: the ragged last key tile (S = 785 = 12 * 64 + 17) is masked here;
// the TPU's 128-multiple was a tiling rule of the Pallas kernel.  Rows are
// addressed by (batch, head, sequence) strides, so q, k, v may be the strided
// views of a packed qkv projection and out may be the [B, S, H, 64] layout
// the output projection reads.
//
// Design of the bf16 variant (FlashAttention-2 style, mma.sync):
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
// Design of the f32 variant (precision="default"/"highest"): the same
// FlashAttention-2 structure on the tensor cores, with f32 accuracy from
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
// Head dims over 64 (WIDE instances, n_chunks > 1): the wrapper zero-pads
// Dh to a multiple of 64 and launches once per 64-column slice of V and O;
// q and k keep every column, as n_chunks chunks of 64.  The K/V ring then
// walks items (key tile kt, chunk c), it = kt * n_chunks + c: each stage
// holds Q's chunk c (Q no longer stays resident), K's chunk c of tile kt
// and, at the last chunk, V's tile kt.  S accumulates over the chunks in
// registers, and the softmax and P.V run at the last chunk, so V, O and the
// accumulators keep the 64-column budget above.  The cost is Dh / 64
// recomputations of S (one per V slice) and Q read once per key tile; the
// Dh = 64 instances (every dino_vit* name) are untouched.  The Q ring makes
// 96 KB of shared memory in bf16 (2 blocks an SM) and 128 KB in f32 (1).
//
// Bounds at the main path's shape (B=8, H=12, S=785, Dh=64; H100 SXM at
// 700 W): operations 4*B*H*S^2*Dh = 15.14 GFLOP, 15.3 us at 989 TFLOP/s in
// bf16; f32: 3 x 15.14 GFLOP at the 495 TFLOP/s of TF32, 91.8 us (226 us
// at the 67 TFLOP/s of the f32 FMAs); bytes q, k, v read and out written
// once, 38.6 MB in bf16 (11.5 us at 3.35 TB/s), 77.2 MB in f32 (23.0 us);
// exponentials B*H*S^2 = 59.2 M, about 14 us at the SFU's 16 per clock per
// SM.  Both variants are bounded by operations; mma.sync (not wgmma) caps
// the tensor cores near two thirds of their peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// WIDE: a Q chunk a stage beside the K and V tiles
constexpr int BF16_WIDE_SMEM = KV_STAGES * (BQ + 2 * BN) * DH * 2;
constexpr int F32_WIDE_SMEM = F32_STAGES * (F32_BQ + 2 * BN) * DH * 4;

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
  int nc;   // 64-column chunks of q and k (1 unless WIDE)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// segment-id instance takes 2, which it fills without spilling, as do the
// WIDE ones (96 KB of shared memory).
template <bool SEG, bool WIDE>
__global__ void __launch_bounds__(BF16_THREADS, (SEG || WIDE) ? 2 : 3)
    flash_fwd_bf16(Args a) {
  constexpr int THREADS = BF16_THREADS;
  constexpr int MT = WARP_ROWS / 16;  // m16 tiles a warp
  constexpr int Q_TILES = WIDE ? KV_STAGES : 1;  // resident, or one a stage
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + Q_TILES * BQ * DH;    // [KV_STAGES][BN * DH]
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
  const int nc = WIDE ? a.nc : 1;
  const int n_it = n_kt * nc;

  // item it (chunk c of key tile kt) into stage st: Q's chunk c (WIDE),
  // K's chunk c of tile kt and, at the last chunk, V's tile kt
  auto load_item = [&](int it, int st) {
    const int kt = WIDE ? it / nc : it;
    const int c = WIDE ? it - kt * nc : 0;
    if (WIDE)
      load_rows_async<BQ, THREADS>(qs + st * BQ * DH, q + c * DH, a.sq.s, q0,
                                   S);
    load_rows_async<BN, THREADS>(ks + st * BN * DH, k + c * DH, a.sk.s,
                                 kt * BN, S);
    if (c == nc - 1)
      load_rows_async<BN, THREADS>(vs + st * BN * DH, v, a.sv.s, kt * BN, S);
  };

  // cp.async groups: Q with item 0, then one group an item (empty past
  // the last), so "item it has landed" is always wait_group 1 at it
  if (!WIDE) load_rows_async<BQ, THREADS>(qs, q, a.sq.s, q0, S);
  load_item(0, 0);
  cp_async_commit();
  if (n_it > 1) load_item(1, 1);
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

  // scores of the warp's rows x 64 keys (summed over the chunks when WIDE)
  float s[MT][BN / 8][4];
  for (int it = 0; it < n_it; ++it) {
    const int kt = WIDE ? it / nc : it;
    const int c = WIDE ? it - kt * nc : 0;
    const int k0 = kt * BN;
    cp_async_wait<1>();  // item it has landed; it + 1 may still fly
    __syncthreads();
    // item it + 2 goes to the stage of it - 1, which every warp finished
    // before the barrier above; it flies while it and it + 1 compute
    if (it + 2 < n_it) load_item(it + 2, (it + 2) % KV_STAGES);
    cp_async_commit();
    // a warp whose rows all lie past S (the last Q tile: S = 785 leaves 17
    // rows of 128) only helps with the copies and the barriers
    if (q0 + wr >= S) continue;
    const int st = it % KV_STAGES;
    const __nv_bfloat16* qst = qs + (WIDE ? st * BQ * DH : 0);
    const __nv_bfloat16* kst = ks + st * BN * DH;
    const __nv_bfloat16* vst = vs + st * BN * DH;

    // 8 n-tiles of 8 keys; one ldmatrix.x4 gives the B fragments of two
    // n-tiles at one 16-deep step
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qf[MT][4];  // the warp's Q rows as A fragments
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(qf[mt],
                qst + swz(wr + 16 * mt + (lane & 15), 2 * kk + (lane >> 4)));
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
    if (c != nc - 1) continue;  // more chunks of S to come

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

// 2 blocks an SM (96 KB of shared memory each; at most 255 registers);
// WIDE: 1 (128 KB).
template <bool SEG, bool WIDE>
__global__ void __launch_bounds__(F32_THREADS, WIDE ? 1 : 2)
    flash_fwd_f32(Args a) {
  constexpr int THREADS = F32_THREADS;
  constexpr int MT = F32_WARP_ROWS / 16;  // m16 tiles a warp
  constexpr int Q_TILES = WIDE ? F32_STAGES : 1;  // resident, or one a stage
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + Q_TILES * F32_BQ * DH;     // [F32_STAGES][BN * DH]
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
  const int nc = WIDE ? a.nc : 1;
  const int n_it = n_kt * nc;

  // item it (chunk c of key tile kt) into stage st, as in the bf16 kernel
  auto load_item = [&](int it, int st) {
    const int kt = WIDE ? it / nc : it;
    const int c = WIDE ? it - kt * nc : 0;
    if (WIDE)
      load_rows_async<F32_BQ, THREADS>(qs + st * F32_BQ * DH, q + c * DH,
                                       a.sq.s, q0, S);
    load_rows_async<BN, THREADS>(ks + st * BN * DH, k + c * DH, a.sk.s,
                                 kt * BN, S);
    if (c == nc - 1)
      load_rows_async<BN, THREADS>(vs + st * BN * DH, v, a.sv.s, kt * BN, S);
  };

  // cp.async groups: Q with item 0, then item it + 1 at item it, so "item
  // it has landed" is wait_group 0 at it
  if (!WIDE) load_rows_async<F32_BQ, THREADS>(qs, q, a.sq.s, q0, S);
  load_item(0, 0);
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

  // scores of the warp's rows x 64 keys (summed over the chunks when WIDE)
  float s[MT][BN / 8][4];
  for (int it = 0; it < n_it; ++it) {
    const int kt = WIDE ? it / nc : it;
    const int c = WIDE ? it - kt * nc : 0;
    const int k0 = kt * BN;
    cp_async_wait<0>();  // item it has landed
    __syncthreads();
    // item it + 1 goes to the stage of it - 1, which every warp finished
    // before the barrier above; it flies while it computes
    if (it + 1 < n_it) load_item(it + 1, (it + 1) % F32_STAGES);
    cp_async_commit();
    // a warp whose rows all lie past S only helps with the copies
    if (q0 + wr >= S) continue;
    const int st = it % F32_STAGES;
    const float* qst = qs + (WIDE ? st * F32_BQ * DH : 0);
    const float* kst = ks + st * BN * DH;
    const float* vst = vs + st * BN * DH;

    // 8 n-tiles of 8 keys, 8 steps of 8 dims; one ldmatrix.x4 gives the B
    // fragments of two n-tiles
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      // A fragments of the warp's Q rows; matrix lane >> 3 takes rows + 8
      // if odd and the next chunk (columns + 4) if >= 2
      uint32_t qh[MT][4], ql[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qf[4];
        ldsm_x4(qf, qst + swz<float>(wr + 16 * mt + (lane & 7) +
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
    if (c != nc - 1) continue;  // more chunks of S to come

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

template <bool SEG, bool WIDE>
static cudaError_t launch_bf16(const Args& a, dim3 grid, cudaStream_t s) {
  static bool raised[64];
  return launch<WIDE ? BF16_WIDE_SMEM : BF16_SMEM>(
      &flash_fwd_bf16<SEG, WIDE>, raised, a, grid, BF16_THREADS, s);
}

template <bool SEG, bool WIDE>
static cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t s) {
  static bool raised[64];
  return launch<WIDE ? F32_WIDE_SMEM : F32_SMEM>(
      &flash_fwd_f32<SEG, WIDE>, raised, a, grid, F32_THREADS, s);
}

// C interface bound with ctypes by tpu_ac_torch/kernels/attention.py.
// q, k: [B, H, S, 64 * n_chunks], v, o: [B, H, S, 64] (the wrapper's slice
// of a wider V and O), of bf16 (is_bf16 != 0) or f32, addressed by the 12
// element strides in `strides` (q, k, v, o, each as batch, head, sequence;
// the last dim is contiguous, every row 16-byte aligned).  seg: int32 [S]
// segment ids on the device, or null.  Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
extern "C" int tpu_ac_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, const int* seg,
                                      const long long* strides, int B, int H,
                                      int S, float scale, int is_bf16,
                                      int n_chunks, void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.seg = seg;
  a.sq = Strides{strides[0], strides[1], strides[2]};
  a.sk = Strides{strides[3], strides[4], strides[5]};
  a.sv = Strides{strides[6], strides[7], strides[8]};
  a.so = Strides{strides[9], strides[10], strides[11]};
  a.S = S;
  a.nc = n_chunks;
  a.c = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = n_chunks > 1;
  if (!is_bf16) {
    const dim3 grid((S + F32_BQ - 1) / F32_BQ, H, B);
    if (wide)
      return (int)(seg ? launch_f32<true, true>(a, grid, s)
                       : launch_f32<false, true>(a, grid, s));
    return (int)(seg ? launch_f32<true, false>(a, grid, s)
                     : launch_f32<false, false>(a, grid, s));
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  if (wide)
    return (int)(seg ? launch_bf16<true, true>(a, grid, s)
                     : launch_bf16<false, true>(a, grid, s));
  return (int)(seg ? launch_bf16<true, false>(a, grid, s)
                   : launch_bf16<false, false>(a, grid, s));
}
