// Tiled pairwise-distance + min kernel for Hopper: the alpha hot loop.
//
// Replaces tpu_ac/kernels/distances.py `_min_dists_kernel` (launched by
// `_min_dists_padded`, distances.py:219) in its three modes: symmetric and
// rectangular (`min_dists_all_pairs`, :299) and window (`min_dists_window`,
// :348).  For query images i with patches A[i] [P, D] and bank images j
// with patches B[j] [Q, D]:
//
//     out[i, j, p] = min_q sqrt(max(a2[i,p] - 2 A[i,p].B[j,q] + b2[j,q], 0))
//
// Products are bf16 x bf16 on the tensor cores with f32 accumulation.  The
// compensated precisions ("f32", "bf16c") pass hi and lo bf16 parts of each
// operand and accumulate hi.hi' + hi.lo' + lo.hi'; "bf16" passes one part.
// The f32 norms a2/b2 come from the wrapper.
//
// Modes.  The wrapper passes a work list of (i, j, P-slab) items:
//   - rectangular: every pair, row-mins only;
//   - symmetric (bank is the query set): the pairs i <= j; for i < j the
//     tile's col-min over p is out[j, i, q], since tile (j, i) is tile (i, j)
//     transposed;
//   - window (the triangle-sharded alpha of one dp rank,
//     tpu_ac/distributed/mesh.py:97-151): the pairs r <= w < min(r + H, W)
//     of a query block [I, P, D] against a circulant window of the bank
//     [W, Q, D]; every tile's col-min goes to a separate col[w, r, q] of
//     shape [W, I, Q].  Entries of inactive tiles stay +inf in both outputs
//     ("undefined", as in tpu_ac).
//
// Design (wgmma + TMA, warp-specialised, persistent):
//   - A block is 2 consumer warpgroups and 1 producer warpgroup (384
//     threads, one of which issues the TMA), one block an SM (grid =
//     min(items, SMs)); block b walks items b,
//     b + grid, ... of the wrapper's list.  An item is a slab of 128 P rows
//     (64 a consumer warpgroup) of one pair, swept against the pair's Q
//     columns in tiles of 224 (two wgmma halves of 112; 784 = 3 x 224 + 112,
//     the last tile runs one half).  On the P axis the granularity is 64
//     rows: 784 = 12 x 64 + 16, so the last slab's second warpgroup has no
//     rows and issues no wgmma.  Launched work is 832 x 784 a pair: 5.8%
//     padding (the earlier wmma design: 896 x 896, 31%).
//   - Operands come by TMA (2-D tensor maps over [rows, D] bf16, boxes of
//     64 x 64 rows for A and 112 x 64 for B, 128-byte swizzle) into a ring
//     of 4 stages of BK = 64, each 44 KB (A 2 x 8 KB, B 2 x 14 KB), with a
//     full and an empty mbarrier a stage.  The compensated modes feed each
//     64-deep chunk through 3 stages, the terms (hi, hi'), (hi, lo'),
//     (lo, hi'), into the same accumulators: one code path, 3x the loads.
//   - Consumers run wgmma m64n112k16 (A and B from shared memory, both
//     K-major) with f32 accumulators in registers: 2 x 56 a thread.
//   - Epilogue from the accumulator registers, no staging: the row-min of
//     b2 - 2 a.b is a register min over the thread's 56 columns, carried
//     across Q tiles, then 2 quad shuffles and + a2 at the item's end.  The
//     col-min of a2 - 2 a.b (symmetric i < j, window) reduces the thread's 2
//     rows, then the 8 rows of a warp by 3 shuffles, then the 8 warps
//     through a double-buffered [8, 224] f32 buffer in shared memory (one
//     named barrier of the 256 consumer threads), + b2, and reaches out/col
//     by atomicMin on the int bits of the clamped d2 (every value is >= 0,
//     so int order is float order) into an output that starts at +inf; a
//     finishing pass takes the sqrt of those entries (sqrt is monotone).
//   - Padded rows/columns read the next image's rows or TMA's zero fill; a
//     row >= P has a2 = +inf and is not stored, a column >= Q has
//     b2 = +inf and is not stored.
//
// Tile arithmetic.  A stage moves (128 + 224) x 64 bf16 = 44 KB from L2 for
// 2 x 128 x 224 x 64 = 3.67 MFLOP: 81.5 FLOP per byte (the earlier 128 x 128
// tile: 64).  Shared memory: 4 x 44 KB ring + 1 KB alignment slack
// (dynamic) + 14 KB col-min buffer + the mbarriers, about 191 KB.
// Registers: 168 a thread, the cap of 384 threads an SM (ptxas; the
// symmetric and window instances spill 28-36 bytes in the col-min
// epilogue).  ptxas serializes the wgmmas (warning C7520: they sit behind
// branches on the thread index).  Reading the warpgroup's role through a
// warp shuffle removes the warning but ran about 40% slower on the card,
// and 27% slower with one wgmma group left in flight
// (scripts/kernel_ab.py variants md_role_shfl and md_wait1; PERF.md).
//
// Tile order (the wrapper's `work_items`): pairs in bands of 2 query
// images, bank-image-major inside a band, the 7 slabs of a pair adjacent.
// The 132 items in flight then touch at most 15 images, at most 11 of them
// bank images (tests/test_torch_kernel_schedule.py): the slabs of 2 query
// images (A, 12.8 MB, each slab re-read once per Q tile; up to 6 images at
// the triangle's tail, where little work is left) and the current
// 224-column tile of about 10 bank images (B, 1.8 MB each, read by the 7
// slabs of each of its pairs at once).  About 31 MB live, inside the 50 MB
// L2.  What it leaves at N = 168, symmetric: from L2, each item reads its
// A slab 4 times and its B image once, about 10.6 MB, 1.0 TB a launch;
// from HBM each bank image once a band (about 7,100 x 6.4 MB = 45 GB) and
// each query image about once.
//
// Bound.  2 * P * Q * D FLOPs per active pair and pass on the bf16 tensor
// cores (989 TFLOP/s dense on an H100 SXM at 700 W).  The main path's
// larger category (N = 168 images, symmetric, "bf16", the i <= j pairs with
// the diagonal) is 14,196 pairs x 5.035 GFLOP = 71.5 TFLOP, i.e. >= 72.3
// ms; "f32"/"bf16c" do 3 passes, 3x that.  Window mode at N = 168 over
// dp = 2 ranks (I = 84, W = 167, H = 84) is 7,056 active tiles a rank x
// 5.035 GFLOP = 35.5 TFLOP, i.e. >= 35.9 ms a rank in "bf16".  Next to
// the operations, the L2 traffic above (1.0 TB) is the nearest limit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper_common.cuh"

namespace {

constexpr int BK = 64;        // D chunk a stage: one 128-byte swizzle row
constexpr int WG_ROWS = 64;   // P rows a consumer warpgroup
constexpr int BM = 128;       // P rows an item (2 consumer warpgroups)
constexpr int HN = 112;       // Q columns a wgmma (784 = 7 x 112)
constexpr int BN = 2 * HN;    // Q columns a tile
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int A_BYTES = WG_ROWS * BK * 2;              // 8 KB
constexpr int B_BYTES = HN * BK * 2;                   // 14 KB
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;  // 44 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

enum Mode { RECT = 0, SYM = 1, WIN = 2 };

struct Maps {  // TMA descriptors of the operands' bf16 parts
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

struct Params {
  const float* a2;  // [n_i, p]
  const float* b2;  // [n_j, q]
  const int* items;  // [n_items, 3]: i, j, P slab
  int n_items;
  float* out;  // not __restrict__: col == out in symmetric mode
  float* col;
  int n_i, n_j, p, q, n_k;  // n_k = D / BK
};

// TMA: the box at (column c0, row c1) of `map` into shared memory `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle,
// 1024-byte aligned: stride 1024 bytes between 8-row groups.  A 16-deep
// step k advances the start address by 32 k bytes (+2 k).
__device__ __forceinline__ uint64_t smem_desc(const void* ptr) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A . B^T for one m64n112k16 step: A [64 x 16] and B [112 x 16] bf16,
// both K-major in 128-byte-swizzled shared memory (descriptors a, b); d is
// the warpgroup's f32 accumulator fragment.  scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n112(float (&d)[56], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(scale_d));
}


// Orders the compiler's reads and writes of an accumulator against the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[56]) {
#pragma unroll
  for (int k = 0; k < 56; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// The 256 consumer threads only (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Row-min and col-min contributions of one 112-column half of the tile.
// Thread rows r0 (a2 ar0) and r0 + 8 (ar1); columns qa = qbase + 8 nb + 2 c
// and qa + 1 of bank image j.
template <bool COL>
__device__ __forceinline__ void epilogue_half(const float (&d)[56],
                                              const float* b2j, int qbase,
                                              int q, float ar0, float ar1,
                                              float& rm0, float& rm1,
                                              float* cb, int c, int g) {
#pragma unroll
  for (int nb = 0; nb < HN / 8; ++nb) {
    const int qa = qbase + nb * 8 + 2 * c;
    const float bq0 = qa < q ? __ldg(b2j + qa) : INFINITY;
    const float bq1 = qa + 1 < q ? __ldg(b2j + qa + 1) : INFINITY;
    const float v00 = d[4 * nb], v01 = d[4 * nb + 1];
    const float v10 = d[4 * nb + 2], v11 = d[4 * nb + 3];
    rm0 = fminf(rm0, fminf(fmaf(-2.f, v00, bq0), fmaf(-2.f, v01, bq1)));
    rm1 = fminf(rm1, fminf(fmaf(-2.f, v10, bq0), fmaf(-2.f, v11, bq1)));
    if (COL) {
      float c0 = fminf(fmaf(-2.f, v00, ar0), fmaf(-2.f, v10, ar1));
      float c1 = fminf(fmaf(-2.f, v01, ar0), fmaf(-2.f, v11, ar1));
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {  // over the warp's 8 row pairs
        c0 = fminf(c0, __shfl_xor_sync(0xffffffffu, c0, x));
        c1 = fminf(c1, __shfl_xor_sync(0xffffffffu, c1, x));
      }
      if (g == 0) {
        cb[nb * 8 + 2 * c] = c0;
        cb[nb * 8 + 2 * c + 1] = c1;
      }
    }
  }
}

template <bool COMP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    min_dists_kernel(const __grid_constant__ Maps maps, const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte tiles
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float colbuf[2][8][BN];

  constexpr int TERMS = COMP ? 3 : 1;
  const int tid = threadIdx.x;
  const int p = prm.p, q = prm.q;
  const int n_qt = (q + BN - 1) / BN;
  const int steps = prm.n_k * TERMS;  // stages a Q tile

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {  // the producer warpgroup: one thread issues the TMA
    if (tid != CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < prm.n_items; it += gridDim.x) {
      const int i = prm.items[3 * it];
      const int j = prm.items[3 * it + 1];
      const int p0 = prm.items[3 * it + 2] * BM;
      const bool a1 = p0 + WG_ROWS < p;  // the second warpgroup has rows
      const int arow = i * p + p0;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BN;
        const bool b1 = q0 + HN < q;  // the second half has columns
        const int brow = j * q + q0;
        const uint32_t bytes = A_BYTES * (a1 ? 2 : 1) + B_BYTES * (b1 ? 2 : 1);
        for (int st = 0; st < steps; ++st) {
          const int k0 = (st / TERMS) * BK;
          const int term = st % TERMS;  // (hi, hi'), (hi, lo'), (lo, hi')
          const CUtensorMap* ma = term == 2 ? &maps.a_lo : &maps.a_hi;
          const CUtensorMap* mb = term == 1 ? &maps.b_lo : &maps.b_hi;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          unsigned char* buf = smem + stage * STAGE_BYTES;
          tma_load(buf, ma, k0, arow, &full[stage]);
          if (a1) tma_load(buf + A_BYTES, ma, k0, arow + WG_ROWS, &full[stage]);
          tma_load(buf + 2 * A_BYTES, mb, k0, brow, &full[stage]);
          if (b1)
            tma_load(buf + 2 * A_BYTES + B_BYTES, mb, k0, brow + HN,
                     &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the item's slab
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r_in = wg * WG_ROWS + (warp & 3) * 16 + g;  // and r_in + 8
  int stage = 0;
  uint32_t phase = 0;
  int par = 0;  // colbuf buffer
  float acc0[56], acc1[56];

  for (int it = blockIdx.x; it < prm.n_items; it += gridDim.x) {
    const int i = prm.items[3 * it];
    const int j = prm.items[3 * it + 1];
    const int p0 = prm.items[3 * it + 2] * BM;
    const bool a1 = p0 + WG_ROWS < p;
    const bool act = wg == 0 || a1;  // this warpgroup has rows
    const bool emit_col = MODE == WIN || (MODE == SYM && i != j);
    const int pr0 = p0 + r_in, pr1 = pr0 + 8;
    const float ar0 = pr0 < p ? __ldg(prm.a2 + (size_t)i * p + pr0) : INFINITY;
    const float ar1 = pr1 < p ? __ldg(prm.a2 + (size_t)i * p + pr1) : INFINITY;
    const float* b2j = prm.b2 + (size_t)j * q;
    float rm0 = INFINITY, rm1 = INFINITY;  // min_q (b2 - 2 a.b)

    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BN;
      const bool b1 = q0 + HN < q;
      for (int st = 0; st < steps; ++st) {
        mbar_wait(&full[stage], phase);
        if (act) {
          const unsigned char* buf = smem + stage * STAGE_BYTES;
          const uint64_t da = smem_desc(buf + wg * A_BYTES);
          const uint64_t db0 = smem_desc(buf + 2 * A_BYTES);
          const uint64_t db1 = smem_desc(buf + 2 * A_BYTES + B_BYTES);
          wgmma_fence();
          if (b1) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
              const int sc = st > 0 || kk > 0;  // 0: the tile's first step
              wgmma_m64n112(acc0, da + 2 * kk, db0 + 2 * kk, sc);
              wgmma_m64n112(acc1, da + 2 * kk, db1 + 2 * kk, sc);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              wgmma_m64n112(acc0, da + 2 * kk, db0 + 2 * kk, st > 0 || kk > 0);
          }
          wgmma_commit_wait();
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      fence_acc(acc0);
      fence_acc(acc1);

      float* cb = colbuf[par][warp];
      if (act) {
        if (emit_col) {
          epilogue_half<true>(acc0, b2j, q0, q, ar0, ar1, rm0, rm1, cb, c, g);
          if (b1)
            epilogue_half<true>(acc1, b2j, q0 + HN, q, ar0, ar1, rm0, rm1,
                                cb + HN, c, g);
        } else {
          epilogue_half<false>(acc0, b2j, q0, q, ar0, ar1, rm0, rm1, cb, c,
                               g);
          if (b1)
            epilogue_half<false>(acc1, b2j, q0 + HN, q, ar0, ar1, rm0, rm1,
                                 cb + HN, c, g);
        }
      }
      if (emit_col) {
        consumer_sync();  // every warp's column mins are in colbuf[par]
        const int n_cols = min(b1 ? BN : HN, q - q0);
        if (tid < n_cols) {
          float v = INFINITY;
          for (int w = 0; w < (a1 ? 8 : 4); ++w)
            v = fminf(v, colbuf[par][w][tid]);
          v = fmaxf(v + __ldg(b2j + q0 + tid), 0.f);
          atomicMin(reinterpret_cast<int*>(prm.col) +
                        ((size_t)j * prm.n_i + i) * q + q0 + tid,
                    __float_as_int(v));
        }
        par ^= 1;  // the next write to this buffer follows another barrier
      }
    }

    if (act) {
      rm0 = fminf(rm0, __shfl_xor_sync(0xffffffffu, rm0, 1));
      rm0 = fminf(rm0, __shfl_xor_sync(0xffffffffu, rm0, 2));
      rm1 = fminf(rm1, __shfl_xor_sync(0xffffffffu, rm1, 1));
      rm1 = fminf(rm1, __shfl_xor_sync(0xffffffffu, rm1, 2));
      float* orow = prm.out + ((size_t)i * prm.n_j + j) * p;
      if (c == 0 && pr0 < p) orow[pr0] = sqrtf(fmaxf(rm0 + ar0, 0.f));
      if (c == 0 && pr1 < p) orow[pr1] = sqrtf(fmaxf(rm1 + ar1, 0.f));
    }
  }
}

// out[a, b, :] = sqrt(out[a, b, :]) for a > b: the col-mins of symmetric
// mode, which hold d2 until every P slab has reduced into them.
__global__ void sqrt_lower_kernel(float* __restrict__ out, int n, int p) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)n * n * p;
  if (idx >= total) return;
  const size_t ab = idx / p;
  if (ab / n > ab % n) out[idx] = sqrtf(out[idx]);
}

// col[:] = sqrt(col[:]): the col-mins of window mode (+inf stays +inf).
__global__ void sqrt_all_kernel(float* __restrict__ col, size_t total) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) col[idx] = sqrtf(col[idx]);
}

// A 2-D map over `rows` rows of `d` bf16 (row stride d), boxes of
// BK x box_rows, 128-byte swizzle; rows past the end load as zeros.
bool make_map(CUtensorMap* map, const void* base, long long rows, int d,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool COMP, int MODE>
cudaError_t launch(const Maps& maps, const Params& prm, cudaStream_t stream) {
  auto kernel = &min_dists_kernel<COMP, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = prm.n_items < sms ? prm.n_items : sms;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(maps, prm);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == RECT) return err;
  if (MODE == SYM) {
    const size_t total = (size_t)prm.n_i * prm.n_j * prm.p;
    sqrt_lower_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        prm.out, prm.n_i, prm.p);
  } else {
    const size_t total = (size_t)prm.n_j * prm.n_i * prm.q;
    sqrt_all_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        prm.col, total);
  }
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int compensated, const Maps& maps, const Params& prm,
                        cudaStream_t s) {
  return compensated ? launch<true, MODE>(maps, prm, s)
                     : launch<false, MODE>(maps, prm, s);
}

}  // namespace

// C interface bound with ctypes by tpu_ac_torch/kernels/distances.py.
// a_* [n_i, p, d] and b_* [n_j, q, d] bf16 (d a multiple of 64, base
// 16-byte aligned), a2 [n_i, p] and b2 [n_j, q] f32, items [n_items, 3]
// int32 of (i, j, P slab of 128 rows), in the order the blocks walk them,
// out [n_i, n_j, p] f32.  mode 0 (rectangular): out only.  mode 1
// (symmetric: n_i == n_j, p == q, items with i <= j): out pre-filled with
// +inf, col == out.  mode 2 (window): out and col [n_j, n_i, q] pre-filled
// with +inf.  a_lo/b_lo are read only when compensated != 0.  Launches on
// `stream`, does not synchronize, returns cudaGetLastError() (or
// cudaErrorInvalidValue when a tensor map cannot be made).
extern "C" int tpu_ac_min_dists(const void* a_hi, const void* a_lo,
                                const void* b_hi, const void* b_lo,
                                const float* a2, const float* b2,
                                const int* items, int n_items, float* out,
                                float* col, int n_i, int n_j, int p, int q,
                                int d, int compensated, int mode,
                                void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  if (d % BK != 0 || mode < RECT || mode > WIN)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  bool ok = make_map(&maps.a_hi, a_hi, (long long)n_i * p, d, WG_ROWS) &&
            make_map(&maps.b_hi, b_hi, (long long)n_j * q, d, HN);
  if (compensated)
    ok = ok && make_map(&maps.a_lo, a_lo, (long long)n_i * p, d, WG_ROWS) &&
         make_map(&maps.b_lo, b_lo, (long long)n_j * q, d, HN);
  else
    maps.a_lo = maps.a_hi, maps.b_lo = maps.b_hi;
  if (!ok) return (int)cudaErrorInvalidValue;
  Params prm;
  prm.a2 = a2;
  prm.b2 = b2;
  prm.items = items;
  prm.n_items = n_items;
  prm.out = out;
  prm.col = mode == SYM ? out : col;
  prm.n_i = n_i;
  prm.n_j = n_j;
  prm.p = p;
  prm.q = q;
  prm.n_k = d / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case RECT:
      return (int)launch_mode<RECT>(compensated, maps, prm, s);
    case SYM:
      return (int)launch_mode<SYM>(compensated, maps, prm, s);
    default:
      return (int)launch_mode<WIN>(compensated, maps, prm, s);
  }
}
