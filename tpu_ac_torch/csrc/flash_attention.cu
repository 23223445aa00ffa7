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
// is taken: the ragged last tile (S=785 = 6*128 + 17) is masked here, on the
// loads, the scores and the stores; the TPU's 128-multiple was a tiling rule
// of the Pallas kernel.  Rows are addressed by (batch, head, sequence)
// strides, so q, k, v may be the strided views of a packed qkv projection
// and out may be the [B, S, H, 64] layout the output projection reads.
//
// Design, simple and right first.  A block owns a 64-row Q tile of one
// (b, h) and walks the K/V tiles of 64 keys through shared memory.  Each row
// keeps its running max m and sum l in f32 registers, in the log2 domain
// (scale * log2(e) folded into one multiply before exp2f), and rescales its
// output accumulator by exp2(m_old - m_new) when m grows; out = O / l is
// written once, in the input type.
//   - bf16: 4 warps, 16 rows each; QK^T and P.V on the tensor cores with
//     mma.sync m16n8k16 and f32 accumulation.  The score fragments stay in
//     registers and become the A operand of P.V directly, so P is rounded to
//     bf16 before P.V (l sums the unrounded f32 P).  V is stored transposed
//     in shared memory so that both B operands are 32-bit loads.
//   - f32: one thread per query row, f32 FMAs over the same tiles, the
//     online-softmax rescale once per 16 keys.  Right and slow: it exists
//     for precision="default"/"highest", not for the bf16 main path.
//   - A row that has seen no visible key yet has m = -inf; the exponentials
//     then subtract 0 instead of m, so exp2(-inf - -inf) never makes a NaN.
// wgmma, TMA, cp.async double buffering and warp specialisation are later
// work.
//
// Bound at the main path's shape (B=8, H=12, S=785, Dh=64, bf16; H100 SXM at
// 700 W): operations 4*B*H*S^2*Dh = 15.14 GFLOP, 15.3 us at 989 TFLOP/s;
// bytes q, k, v read and out written once, 38.6 MB, 11.5 us at 3.35 TB/s;
// exponentials B*H*S^2 = 59.2 M, about 14 us at the SFU's 16 per clock per
// SM.  So it is bounded by operations, with the exponentials close behind.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;        // head dim (every dino_vit* name)
constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // bf16: 4 warps x 16 rows
constexpr int LD = DH + 8;    // bf16 row stride of the Q and K tiles (144 B)
constexpr int LDV = BN + 8;   // bf16 row stride of the transposed V tile
constexpr int CHUNK = 16;     // f32: keys per online-softmax rescale
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// Rows [r0, r0 + 64) of one (b, h) slice into shared memory, row stride LD;
// rows >= S load as zeros.  A warp reads 4 rows of 128 contiguous bytes.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int S) {
  for (int c = threadIdx.x; c < 64 * (DH / 8); c += THREADS) {
    const int row = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + row) * ss + col);
    *reinterpret_cast<uint4*>(dst + row * LD + col) = val;
  }
}

// The same rows stored transposed: dst[col * LDV + row].  A warp reads 16
// rows of 32 contiguous bytes, so its 2-byte stores meet at most 2 to a bank.
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long ss, int r0, int S) {
  for (int c = threadIdx.x; c < 64 * (DH / 8); c += THREADS) {
    const int row = (c & 15) | ((c >> 7) << 4);
    const int col = ((c >> 4) & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + row < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + row) * ss + col);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * LDV + row] = e[i];
  }
}

__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(Args a) {
  __shared__ __align__(16) __nv_bfloat16 qs[BM * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[BN * LD];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * LDV];
  __shared__ int kid[BN];

  const int S = a.S;
  const int q0 = blockIdx.x * BM;
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

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column pair
  const int r0 = (tid >> 5) * 16;  // the warp's rows in the tile

  load_rows(qs, q, a.sq.s, q0, S);
  __syncthreads();
  // the warp's Q rows as A fragments, kept in registers for every K tile
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* p = qs + (r0 + g) * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LD);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LD + 8);
  }
  // rows i0 and i1 = i0 + 8 of this thread; rows >= S are never stored
  const int i0 = q0 + r0 + g;
  const int i1 = i0 + 8;
  const int qid0 = a.seg ? a.seg[min(i0, S - 1)] : 0;
  const int qid1 = a.seg ? a.seg[min(i1, S - 1)] : 0;

  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < S; k0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows(ks, k, a.sk.s, k0, S);
    load_rows_t(vt, v, a.sv.s, k0, S);
    if (tid < BN) kid[tid] = (a.seg && k0 + tid < S) ? a.seg[k0 + tid] : 0;
    __syncthreads();

    // scores of 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* p = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(p), ld32(p + 8));
      }
    }
    // into the log2 domain; invisible keys (ragged tail, other segment)
    // become -inf
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool ok = k0 + col < S && kid[col] == (e < 2 ? qid0 : qid1);
        s[n][e] = ok ? s[n][e] * a.c : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the 4 threads of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = exp2f(m0 - base0);
    const float corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base0);
      s[n][1] = exp2f(s[n][1] - base0);
      s[n][2] = exp2f(s[n][2] - base1);
      s[n][3] = exp2f(s[n][3] - base1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + rs0;  // a per-thread partial sum; quads add at the end
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][0] *= corr0;
      acc[d][1] *= corr0;
      acc[d][2] *= corr1;
      acc[d][3] *= corr1;
    }
    // acc += P V over 4 steps of 16 keys: the C fragments of n-tiles 2j and
    // 2j+1 are the A fragment of key step j, rounded to bf16 here
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const __nv_bfloat16* p = vt + (d * 8 + g) * LDV + j * 16 + 2 * t;
        mma_bf16(acc[d], pa, ld32(p), ld32(p + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (i0 < S)
      *reinterpret_cast<uint32_t*>(o + i0 * a.so.s + col) =
          pack_bf16(acc[d][0] * inv0, acc[d][1] * inv0);
    if (i1 < S)
      *reinterpret_cast<uint32_t*>(o + i1 * a.so.s + col) =
          pack_bf16(acc[d][2] * inv1, acc[d][3] * inv1);
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
  const dim3 grid((S + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_fwd_bf16<<<grid, THREADS, 0, s>>>(a);
  else
    flash_fwd_f32<<<grid, BM, 0, s>>>(a);
  return (int)cudaGetLastError();
}
