// Flash (streaming-softmax) attention forward for Hopper: the ViT trunk's
// attention_impl="flash" path.
//
// Replaces tpu_ac/kernels/attention.py:26 `flash_attention_impl`, which calls
// JAX's stock Pallas TPU flash kernel on a sequence padded to a multiple of
// 128.  For q, k, v [B, H, S, 64] and an optional int32 segment-id vector
// ids [S] shared by the batch:
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
// The f32 variant (precision="default"/"highest") is the first design: one
// thread per query row, f32 FMAs over 64-key tiles, the rescale once per 16
// keys.
//
// Bound at the main path's shape (B=8, H=12, S=785, Dh=64, bf16; H100 SXM at
// 700 W): operations 4*B*H*S^2*Dh = 15.14 GFLOP, 15.3 us at 989 TFLOP/s;
// bytes q, k, v read and out written once, 38.6 MB, 11.5 us at 3.35 TB/s;
// exponentials B*H*S^2 = 59.2 M, about 14 us at the SFU's 16 per clock per
// SM.  So it is bounded by operations, with the exponentials close behind;
// mma.sync (not wgmma) caps the tensor cores near two thirds of that peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;        // head dim (every dino_vit* name)
constexpr int BQ = 128;       // bf16: query rows per block
constexpr int WARP_ROWS = 32;  // bf16: query rows a warp (4 warps)
constexpr int BF16_THREADS = BQ / WARP_ROWS * 32;
constexpr int BM = 64;        // f32: query rows (threads) per block
constexpr int BN = 64;        // keys per K/V tile
constexpr int KV_STAGES = 3;  // bf16: K/V ring depth
constexpr int CHUNK = 16;     // f32: keys per online-softmax rescale
constexpr float LOG2E = 1.4426950408889634f;
// bf16 shared memory: the Q tile and KV_STAGES K and V tiles, 128-B rows
constexpr int BF16_SMEM = (BQ + 2 * KV_STAGES * BN) * DH * 2;

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

// Element offset of 16-byte chunk `ch` (0..7) of row `r` in a tile of
// 128-byte rows, the chunks XOR-swizzled by r & 7.
__device__ __forceinline__ int swz(int r, int ch) {
  return r * DH + ((ch ^ (r & 7)) << 3);
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
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long ss, int r0, int S) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (DH / 8); c += THREADS) {
    const int row = c >> 3;
    const int ch = c & 7;
    const int n = r0 + row < S ? 16 : 0;
    const __nv_bfloat16* g = src + min(r0 + row, S - 1) * ss + ch * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + swz(row, ch))), "l"(g), "r"(n)
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

__global__ void __launch_bounds__(BM) flash_fwd_f32(Args a) {
  __shared__ __align__(16) float ks[BN * DH];
  __shared__ __align__(16) float vs[BN * DH];
  __shared__ int kid[BN];

  const int S = a.S;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * BM + tid;  // this thread's query row
  const float* q = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* o = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;

  float qr[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < S) x = *reinterpret_cast<const float4*>(q + i * a.sq.s + d);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
  }
  const int qid = a.seg ? a.seg[min(i, S - 1)] : 0;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += BN) {
    __syncthreads();
    for (int c = tid; c < BN * DH / 4; c += BM) {
      const int row = c / (DH / 4);
      const int col = (c % (DH / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + row < S) {
        kx = *reinterpret_cast<const float4*>(k + (k0 + row) * a.sk.s + col);
        vx = *reinterpret_cast<const float4*>(v + (k0 + row) * a.sv.s + col);
      }
      *reinterpret_cast<float4*>(ks + row * DH + col) = kx;
      *reinterpret_cast<float4*>(vs + row * DH + col) = vx;
    }
    kid[tid] = (a.seg && k0 + tid < S) ? a.seg[k0 + tid] : 0;
    __syncthreads();

    for (int j0 = 0; j0 < BN; j0 += CHUNK) {
      float s[CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float* kr = ks + (j0 + jj) * DH;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
        const bool ok = k0 + j0 + jj < S && kid[j0 + jj] == qid;
        s[jj] = ok ? dot * a.c : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float mn = fmaxf(m, mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float corr = exp2f(m - base);
      m = mn;
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float p = exp2f(s[jj] - base);
        const float* vr = vs + (j0 + jj) * DH;
        l += p;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
  }

  if (i < S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4)
      *reinterpret_cast<float4*>(o + i * a.so.s + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                      acc[d + 3] * inv);
  }
}

}  // namespace

template <bool SEG>
static cudaError_t launch_bf16(const Args& a, dim3 grid, cudaStream_t s) {
  auto kernel = &flash_fwd_bf16<SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BF16_THREADS, BF16_SMEM, s>>>(a);
  return cudaGetLastError();
}

// C interface bound with ctypes by tpu_ac_torch/kernels/attention.py.
// q, k, v, o: [B, H, S, 64] of bf16 (is_bf16 != 0) or f32, addressed by the
// 12 element strides in `strides` (q, k, v, o, each as batch, head,
// sequence; the last dim is contiguous, every row 16-byte aligned).  seg:
// int32 [S] segment ids on the device, or null.  Launches on `stream`, does
// not synchronize, returns cudaGetLastError().
extern "C" int tpu_ac_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, const int* seg,
                                      const long long* strides, int B, int H,
                                      int S, float scale, int is_bf16,
                                      void* stream) {
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
  a.c = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    flash_fwd_f32<<<dim3((S + BM - 1) / BM, H, B), BM, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  return (int)(seg ? launch_bf16<true>(a, grid, s)
                   : launch_bf16<false>(a, grid, s));
}
