// The paper's tile accelerators, hand-written for Hopper (sm_90a): the
// mxmBlock tile of Fig. 1 and the dsyrk / dgemm / dtrsm tiles of Fig. 4.
//
// 1. gemm_tile_kernel replaces the Pallas TPU kernels
//      repro/kernels/block_matmul.py:34 block_matmul (_matmul_kernel :21)
//      repro/kernels/cholesky_tiles.py:34 syrk_tile (_syrk_kernel :26)
//    and the product inside repro/kernels/ops.py:119 gemm_update:
//
//      out[M,N] = op(A)[M,K] @ B[K,N]            (sub = 0)
//      out[M,N] = C[M,N] - op(A)[M,K] @ B[K,N]    (sub = 1)
//
//    with op(A) = A stored [M,K] (trans_a = 0) or op(A) = A^T with A stored
//    [K,M] (trans_a = 1).  block_matmul is (trans_a, sub) = (0, 0),
//    syrk_tile C - A^T A is (1, 1) with B = A, and gemm_update C - B^T A is
//    (1, 1) with the roles of its operands swapped.  (JAX subtracts outside
//    the kernel; the fused epilogue computes the same function.)  Inputs
//    are f32 or bf16, the output (and C) f32 or bf16; every product is
//    accumulated in f32 registers and rounded once, to nearest even.
//
//    Design: one block of 256 threads owns a TILE x TILE output tile.  The
//    TPU kernel's sequential K grid axis is the loop over k0 inside the
//    block: each step stages a TILE_K-deep slab of op(A) and of B in shared
//    memory as f32 (zero past the ragged edges, so any M, N, K runs), and
//    every thread accumulates a (TILE/16) x (TILE/16) micro-tile with FMAs.
//    Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, so a warp
//    reads one op(A) value per half-warp (a broadcast) and 16 consecutive B
//    values, with no bank conflict; the op(A) slab is padded by one column
//    so the row-major staging writes of trans_a = 0 do not conflict either.
//    TILE is a compile-time constant (-DTILE=..., default 64) so the
//    traditional flow can build one granularity's accelerator afresh.
//
//    Bound at the paths' shapes: at (64,64,64) f32 the product is 2*64^3 =
//    524,288 flops (7.8 ns at 67 TFLOP/s FP32) on 49,152 bytes (14.7 ns at
//    3.35 TB/s), so it is bound by bytes, at about 15 ns; (128,128,128) f32
//    is 58.7 ns of bytes against 62.6 ns of flops.  Either is far below one
//    launch.  At these shapes the grid is 1 to 4 blocks on a 132-SM card,
//    so the kernel is latency-bound: what the design does about it is to do
//    the whole product (and the epilogue) in one launch with no second
//    pass and no allocation.  wgmma, TMA and a split of K across blocks for
//    small grids are later work.
//
// 2. trsm_tile_kernel replaces repro/kernels/cholesky_tiles.py:86
//    trsm_tile (_trsm_kernel :49): X[bs,n] = A^-T B, A upper-triangular
//    [bs,bs] (so A^T is lower), by forward substitution
//
//      x[i] = (b[i] - sum_{j<i} A[j][i] x[j]) / A[i][i].
//
//    Design: the columns of B are independent, so a block of TRSM_COLS
//    threads stages all of A in shared memory (16 KB at bs = 64 in f32)
//    and each thread substitutes one column, keeping its x in a shared
//    column (conflict-free: neighbouring threads, neighbouring words).
//    Every thread reads the same A[j][i] at once (a broadcast).  This is
//    not the Pallas kernel's panel inversion, which fed the MXU; the
//    wrapper keeps the `panel` argument's contract (bs % panel == 0) and
//    the kernel does not need it.
//
//    Bound at the path's shape (64,64) f32: 64^2 * 64 = 262,144 flops
//    (3.9 ns at 67 TFLOP/s) on the upper triangle of A, B and X, 41,088
//    bytes (12.3 ns at 3.35 TB/s): bytes, about 12 ns.  The kernel is far
//    from it: each thread runs a chain of bs(bs-1)/2 dependent FMAs, some
//    thousands of cycles.  Splitting a column's dot products across a warp
//    would shorten the chain; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TILE
#define TILE 64
#endif

namespace {

constexpr int kTile = TILE;
constexpr int kTileK = 16;
constexpr int kGemmThreads = 256;       // 16 x 16
constexpr int kMicro = kTile / 16;
constexpr int kTrsmCols = 32;
static_assert(kTile % 16 == 0 && kTile >= 16 && kTile <= 128,
              "TILE must be a multiple of 16 in [16, 128]");
// The most dynamic shared memory one block may ask for on sm_90.
constexpr size_t kMaxSmem = 232448;

size_t trsm_smem_bytes(int bs) {
  return sizeof(float) * ((size_t)bs * bs + (size_t)bs * kTrsmCols);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tile_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                 const TOut* __restrict__ c, TOut* __restrict__ out,
                 int M, int N, int K, int trans_a, int sub) {
  __shared__ float As[kTileK][kTile + 1];
  __shared__ float Bs[kTileK][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * kTile; e += kGemmThreads) {
      // op(A) slab [kTileK][kTile]: neighbouring threads read
      // neighbouring addresses in either storage order
      int kk, r;
      if (trans_a) {
        kk = e / kTile;
        r = e % kTile;
      } else {
        r = e / kTileK;
        kk = e % kTileK;
      }
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < M && gk < K)
        v = to_f32(trans_a ? a[(int64_t)gk * M + gr] : a[(int64_t)gr * K + gk]);
      As[kk][r] = v;
      // B slab [kTileK][kTile]
      const int bk = e / kTile, bc = e % kTile;
      const int gbk = k0 + bk, gc = col0 + bc;
      Bs[bk][bc] = (gbk < K && gc < N) ? to_f32(b[(int64_t)gbk * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float af[kMicro], bf[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) af[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) bf[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= N) continue;
      const int64_t idx = (int64_t)r * N + col;
      float v = acc[i][j];
      if (sub) v = to_f32(c[idx]) - v;
      out[idx] = from_f32<TOut>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTrsmCols)
trsm_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, int bs, int n) {
  extern __shared__ float smem[];
  float* As = smem;                       // [bs][bs], row-major A
  float* Xs = smem + (int64_t)bs * bs;    // [bs][kTrsmCols], one column each
  const int t = threadIdx.x;
  const int col = blockIdx.x * kTrsmCols + t;
  for (int e = t; e < bs * bs; e += kTrsmCols) As[e] = to_f32(a[e]);
  if (col < n)
    for (int i = 0; i < bs; ++i)
      Xs[i * kTrsmCols + t] = to_f32(b[(int64_t)i * n + col]);
  __syncthreads();
  if (col >= n) return;
  for (int i = 0; i < bs; ++i) {
    float s = Xs[i * kTrsmCols + t];
    for (int j = 0; j < i; ++j)
      s = fmaf(-As[j * bs + i], Xs[j * kTrsmCols + t], s);
    s = s / As[i * bs + i];
    Xs[i * kTrsmCols + t] = s;
    out[(int64_t)i * n + col] = from_f32<T>(s);
  }
}

template <typename TIn, typename TOut>
int launch_gemm(const void* a, const void* b, const void* c, void* out,
                int M, int N, int K, int trans_a, int sub,
                cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_tile_kernel<TIn, TOut><<<grid, kGemmThreads, 0, stream>>>(
      (const TIn*)a, (const TIn*)b, (const TOut*)c, (TOut*)out, M, N, K,
      trans_a, sub);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trsm(const void* a, const void* b, void* out, int bs, int n,
                cudaStream_t stream) {
  const size_t smem = trsm_smem_bytes(bs);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trsm_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kTrsmCols - 1) / kTrsmCols;
  trsm_tile_kernel<T><<<blocks, kTrsmCols, smem, stream>>>(
      (const T*)a, (const T*)b, (T*)out, bs, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported by the caller.  Operands are contiguous
// and row-major; dtype codes are 0 for f32 and 1 for bf16.

extern "C" int tiles_tile_edge() { return kTile; }

// Whether trsm_tile_kernel can hold A and its columns for this bs.
extern "C" int tiles_trsm_fits(int bs) {
  return bs > 0 && trsm_smem_bytes(bs) <= kMaxSmem;
}

extern "C" int tiles_gemm_launch(const void* a, const void* b, const void* c,
                                 void* out, int M, int N, int K, int in_dtype,
                                 int out_dtype, int trans_a, int sub,
                                 void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return launch_gemm<float, float>(a, b, c, out, M, N, K, trans_a, sub, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_gemm<float, __nv_bfloat16>(a, b, c, out, M, N, K, trans_a,
                                             sub, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_gemm<__nv_bfloat16, float>(a, b, c, out, M, N, K, trans_a,
                                             sub, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16>(a, b, c, out, M, N, K,
                                                     trans_a, sub, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tiles_trsm_launch(const void* a, const void* b, void* out,
                                 int bs, int n, int dtype, void* stream) {
  if (bs <= 0 || n <= 0) return (int)cudaSuccess;
  if (trsm_smem_bytes(bs) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_trsm<float>(a, b, out, bs, n, s);
  if (dtype == 1) return launch_trsm<__nv_bfloat16>(a, b, out, bs, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
