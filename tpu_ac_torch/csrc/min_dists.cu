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
// Design.  A block owns a BM=128-row tile of P for one (i, j) pair and walks
// every BN=128-column tile of Q; for each it runs the whole D contraction
// (BK=32 chunks through shared memory, nvcuda::wmma 16x16x16), stages the
// f32 dot tile in shared memory and reduces it:
//   - the row-min over q stays in registers across Q tiles (no atomics);
//   - the pairs come as a list from the wrapper, so each mode launches only
//     the tiles it needs;
//   - symmetric mode (bank is the query set) launches the pairs i <= j and,
//     for i < j, also emits the col-min over p into out[j, i, q]: the
//     (j, i) tile is this tile transposed;
//   - window mode (the triangle-sharded alpha of one dp rank,
//     tpu_ac/distributed/mesh.py:97-151) launches the pairs r <= w <
//     min(r + H, W) of a query block [I, P, D] against a circulant window
//     of the bank [W, Q, D] and emits every tile's col-min into a separate
//     output col[w, r, q] of shape [W, I, Q] (no tile pairs an image with
//     itself: the pair distance w - r + 1 lies in [1, H] and H < N).
//   Col-mins of the P tiles of a pair combine by atomicMin on the bits of
//   the clamped d2 (every value is >= 0, so int order is float order) into
//   an output that starts at +inf; a finishing pass takes the sqrt of those
//   entries (sqrt is monotone).  In window mode the entries of inactive
//   tiles stay +inf in both outputs ("undefined", as in tpu_ac).
// Padded rows/columns of the last tiles load as zeros and are masked out of
// both mins.
//
// Bound.  2 * P * Q * D FLOPs per active pair and pass on the bf16 tensor
// cores (989 TFLOP/s dense on an H100 SXM at 700 W).  The main path's
// larger category (N = 168 images, symmetric, "bf16", the i <= j pairs with
// the diagonal) is 14,196 pairs x 5.035 GFLOP = 71.5 TFLOP, i.e. >= 72.3
// ms; "f32"/"bf16c" do 3 passes, 3x that.  Window mode at N = 168 over
// dp = 2 ranks (I = 84, W = 167, H = 84) is 7,056 active tiles a rank x
// 5.035 GFLOP = 35.5 TFLOP, i.e. >= 35.9 ms a rank in "bf16".  Bytes are no
// bound in principle (each image is 6.4 MB of bf16), but this first design
// re-reads its A tile from L2/HBM once per Q tile and pads 784 to 896 on
// both tile axes (1.31x the FLOPs): a later PR moves it to wgmma + TMA with
// a tile order that keeps operands in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;        // P rows per block
constexpr int BN = 128;        // Q columns per tile
constexpr int BK = 32;         // D chunk per shared-memory stage
constexpr int LDS = BK + 8;    // bf16 row stride in shared memory (80 B)
constexpr int LDC = BN + 4;    // f32 row stride of the staged dot tile
constexpr int THREADS = 256;   // 8 warps: 4 (rows of 32) x 2 (cols of 64)
constexpr int OPERAND_BYTES = 4 * BM * LDS * 2;
constexpr int TILE_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = OPERAND_BYTES > TILE_BYTES ? OPERAND_BYTES
                                                      : TILE_BYTES;

// Copy rows [r0, r0 + 128) x cols [k0, k0 + 32) of a [rows, d] bf16 matrix
// into shared memory (row stride LDS); rows >= n_rows load as zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int r0, int n_rows, int d, int k0) {
  for (int c = threadIdx.x; c < BM * (BK / 8); c += THREADS) {
    const int row = c >> 2;
    const int col = (c & 3) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + row < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * d + k0 +
                                          col);
    *reinterpret_cast<uint4*>(dst + row * LDS + col) = v;
  }
}

enum Mode { RECT = 0, SYM = 1, WIN = 2 };

template <bool COMP, int MODE>
__global__ void __launch_bounds__(THREADS)
min_dists_kernel(const __nv_bfloat16* __restrict__ a_hi,
                 const __nv_bfloat16* __restrict__ a_lo,
                 const __nv_bfloat16* __restrict__ b_hi,
                 const __nv_bfloat16* __restrict__ b_lo,
                 const float* __restrict__ a2, const float* __restrict__ b2,
                 const int* __restrict__ pairs,
                 float* out,  // not __restrict__: col == out in symmetric mode
                 float* col, int n_i, int n_j, int p, int q, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* as_lo = as_hi + BM * LDS;
  __nv_bfloat16* bs_hi = as_lo + BM * LDS;
  __nv_bfloat16* bs_lo = bs_hi + BN * LDS;
  float* cs = reinterpret_cast<float*>(smem);  // reused after the K loop
  __shared__ float a2s[BM];
  __shared__ float b2s[BN];
  __shared__ float colpart[2][BN];

  const int n_pt = (p + BM - 1) / BM;
  const int pair = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x % n_pt) * BM;
  const int i = pairs[2 * pair];
  const int j = pairs[2 * pair + 1];
  const bool emit_col = MODE == WIN || (MODE == SYM && i != j);

  const __nv_bfloat16* ai_hi = a_hi + (size_t)i * p * d;
  const __nv_bfloat16* ai_lo = COMP ? a_lo + (size_t)i * p * d : nullptr;
  const __nv_bfloat16* bj_hi = b_hi + (size_t)j * q * d;
  const __nv_bfloat16* bj_lo = COMP ? b_lo + (size_t)j * q * d : nullptr;

  const int tid = threadIdx.x;
  if (tid < BM) a2s[tid] = (p0 + tid < p) ? a2[(size_t)i * p + p0 + tid] : 0.f;

  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp's row offset in the tile
  const int wn = (warp & 1) * 64;   // warp's column offset in the tile

  // row-min mapping: 2 threads per row, each over half of the columns
  const int rr = tid >> 1;
  const int rh = tid & 1;
  float rmin = INFINITY;

  for (int q0 = 0; q0 < q; q0 += BN) {
    if (tid < BN) b2s[tid] = (q0 + tid < q) ? b2[(size_t)j * q + q0 + tid] : 0.f;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) wmma::fill_fragment(acc[x][y], 0.f);

    for (int k0 = 0; k0 < d; k0 += BK) {
      load_tile(as_hi, ai_hi, p0, p, d, k0);
      load_tile(bs_hi, bj_hi, q0, q, d, k0);
      if (COMP) {
        load_tile(as_lo, ai_lo, p0, p, d, k0);
        load_tile(bs_lo, bj_lo, q0, q, d, k0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb[4];
#pragma unroll
        for (int x = 0; x < 2; ++x)
          wmma::load_matrix_sync(fa[x], as_hi + (wm + 16 * x) * LDS + kk, LDS);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          wmma::load_matrix_sync(fb[y], bs_hi + (wn + 16 * y) * LDS + kk, LDS);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
        if (COMP) {
          // hi . lo'
#pragma unroll
          for (int y = 0; y < 4; ++y)
            wmma::load_matrix_sync(fb[y], bs_lo + (wn + 16 * y) * LDS + kk,
                                   LDS);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
          // lo . hi'
#pragma unroll
          for (int x = 0; x < 2; ++x)
            wmma::load_matrix_sync(fa[x], as_lo + (wm + 16 * x) * LDS + kk,
                                   LDS);
#pragma unroll
          for (int y = 0; y < 4; ++y)
            wmma::load_matrix_sync(fb[y], bs_hi + (wn + 16 * y) * LDS + kk,
                                   LDS);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y)
              wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
        }
      }
      __syncthreads();
    }

    // stage the f32 dot tile (the operand buffers are free now)
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        wmma::store_matrix_sync(cs + (wm + 16 * x) * LDC + wn + 16 * y,
                                acc[x][y], LDC, wmma::mem_row_major);
    __syncthreads();

    // row-min over this tile's valid columns
    {
      const float ar = a2s[rr];
      const float* crow = cs + rr * LDC + rh * (BN / 2);
      const int cmax = min(BN / 2, q - q0 - rh * (BN / 2));
      for (int c = 0; c < cmax; ++c)
        rmin = fminf(rmin, ar - 2.f * crow[c] + b2s[rh * (BN / 2) + c]);
    }
    if (emit_col) {
      // col-min over this block's valid rows, in two halves of 64 rows
      const int c = tid & (BN - 1);
      const int h = tid >> 7;
      const float bc = b2s[c];
      float m = INFINITY;
      const int rmax = min(BM / 2, p - p0 - h * (BM / 2));
      for (int r = 0; r < rmax; ++r) {
        const int row = h * (BM / 2) + r;
        m = fminf(m, a2s[row] - 2.f * cs[row * LDC + c] + bc);
      }
      colpart[h][c] = m;
      __syncthreads();
      if (tid < BN && q0 + tid < q) {
        float v = fminf(colpart[0][tid], colpart[1][tid]);
        v = v > 0.f ? v : 0.f;
        atomicMin(reinterpret_cast<int*>(col) + ((size_t)j * n_i + i) * q +
                      q0 + tid,
                  __float_as_int(v));
      }
    }
    __syncthreads();  // the next tile overwrites cs, b2s and colpart
  }

  rmin = fminf(rmin, __shfl_xor_sync(0xffffffffu, rmin, 1));
  if (rh == 0 && p0 + rr < p)
    out[((size_t)i * n_j + j) * p + p0 + rr] = sqrtf(fmaxf(rmin, 0.f));
}

// out[a, b, :] = sqrt(out[a, b, :]) for a > b: the col-mins of symmetric
// mode, which hold d2 until every P tile has reduced into them.
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

template <bool COMP, int MODE>
cudaError_t launch(const void* a_hi, const void* a_lo, const void* b_hi,
                   const void* b_lo, const float* a2, const float* b2,
                   const int* pairs, int n_pairs, float* out, float* col,
                   int n_i, int n_j, int p, int q, int d,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&min_dists_kernel<COMP, MODE>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)n_pairs * ((p + BM - 1) / BM);
  min_dists_kernel<COMP, MODE><<<(unsigned)blocks, THREADS, SMEM_BYTES,
                                 stream>>>(
      static_cast<const __nv_bfloat16*>(a_hi),
      static_cast<const __nv_bfloat16*>(a_lo),
      static_cast<const __nv_bfloat16*>(b_hi),
      static_cast<const __nv_bfloat16*>(b_lo), a2, b2, pairs, out, col, n_i,
      n_j, p, q, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE == RECT) return err;
  if (MODE == SYM) {
    const size_t total = (size_t)n_i * n_j * p;
    sqrt_lower_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        out, n_i, p);
  } else {
    const size_t total = (size_t)n_j * n_i * q;
    sqrt_all_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        col, total);
  }
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int compensated, const void* a_hi, const void* a_lo,
                        const void* b_hi, const void* b_lo, const float* a2,
                        const float* b2, const int* pairs, int n_pairs,
                        float* out, float* col, int n_i, int n_j, int p,
                        int q, int d, cudaStream_t s) {
  return compensated
             ? launch<true, MODE>(a_hi, a_lo, b_hi, b_lo, a2, b2, pairs,
                                  n_pairs, out, col, n_i, n_j, p, q, d, s)
             : launch<false, MODE>(a_hi, a_lo, b_hi, b_lo, a2, b2, pairs,
                                   n_pairs, out, col, n_i, n_j, p, q, d, s);
}

}  // namespace

// C interface bound with ctypes by tpu_ac_torch/kernels/distances.py.
// a_* [n_i, p, d] and b_* [n_j, q, d] bf16 (d a multiple of 32, rows 16-byte
// aligned), a2 [n_i, p] and b2 [n_j, q] f32, pairs [n_pairs, 2] int32 of
// (i, j), out [n_i, n_j, p] f32.  mode 0 (rectangular): out only.  mode 1
// (symmetric: n_i == n_j, p == q): out pre-filled with +inf, col == out.
// mode 2 (window): out and col [n_j, n_i, q] pre-filled with +inf.  a_lo/b_lo
// are read only when compensated != 0.  Launches on `stream`, does not
// synchronize, returns cudaGetLastError().
extern "C" int tpu_ac_min_dists(const void* a_hi, const void* a_lo,
                                const void* b_hi, const void* b_lo,
                                const float* a2, const float* b2,
                                const int* pairs, int n_pairs, float* out,
                                float* col, int n_i, int n_j, int p, int q,
                                int d, int compensated, int mode,
                                void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case RECT:
      return (int)launch_mode<RECT>(compensated, a_hi, a_lo, b_hi, b_lo, a2,
                                    b2, pairs, n_pairs, out, col, n_i, n_j,
                                    p, q, d, s);
    case SYM:
      return (int)launch_mode<SYM>(compensated, a_hi, a_lo, b_hi, b_lo, a2,
                                   b2, pairs, n_pairs, out, out, n_i, n_j,
                                   p, q, d, s);
    case WIN:
      return (int)launch_mode<WIN>(compensated, a_hi, a_lo, b_hi, b_lo, a2,
                                   b2, pairs, n_pairs, out, col, n_i, n_j,
                                   p, q, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
