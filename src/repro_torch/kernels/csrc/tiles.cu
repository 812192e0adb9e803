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
//    accumulated in f32 registers on the CUDA cores (full f32, no TF32)
//    and rounded once, to nearest even.
//
//    Bound at the paths' shapes: at (64,64,64) f32 the product is 2*64^3 =
//    524,288 flops (7.8 ns at 67 TFLOP/s FP32) on 49,152 bytes (14.7 ns at
//    3.35 TB/s), so it is bound by bytes, at about 15 ns; (128,128,128) f32
//    is 58.7 ns of bytes against 62.6 ns of flops.  Either is far below one
//    launch, so the kernel is bound by latency: a launch, global-memory
//    round trips, and the longest chain of dependent work on one SM.
//
//    Design: the paper's TILE x TILE output tile (TILE a compile-time
//    constant, -DTILE=..., default 64, so the traditional flow builds each
//    granularity's accelerator afresh) is split into (TILE/16)^2 blocks of
//    64 threads, each owning a 16 x 16 sub-tile: 16 blocks on 16 SMs at
//    64^3, 64 at 128^3.  A block stages its 16 op(A) rows, its 16 B columns
//    and (sub = 1) its C sub-tile over all of K in ONE round of 16-byte
//    cp.async copies into dynamic shared memory, waits once, and each
//    thread accumulates a 2 x 2 micro-tile with FMAs over K (one shared
//    load per FMA, the loop unrolled by 8 so that eight steps' loads are
//    issued before their FMAs: two warps a block cannot hide a load's
//    latency; the op(A) rows of trans_a = 0 are padded to 8 mod 32 words
//    so the warp's four rows fall in distinct banks).  An operand
//    whose base or row pitch is not 16-byte aligned (odd widths, bf16 rows
//    of odd length) is staged element by element in the same round, by
//    the same kernel.  Zero is staged past the ragged edges, so any M, N,
//    K runs.  K deeper than kChunkK (1,024) is staged in rounds of that
//    depth; no path comes near it.
//
// 2. trsm_tile_kernel replaces repro/kernels/cholesky_tiles.py:86
//    trsm_tile (_trsm_kernel :49): X[bs,n] = A^-T B, A upper-triangular
//    [bs,bs] (so L = A^T is lower), by the TPU kernel's blocked forward
//    substitution over `panel` rows:
//
//      for each panel p:  X_p = inv(L_pp) B_p;  B_tail -= L_tail,p X_p.
//
//    Bound at the path's shape (64,64) f32: 64^2 * 64 = 262,144 flops
//    (3.9 ns at 67 TFLOP/s) on the upper triangle of A, B and X, 41,088
//    bytes (12.3 ns at 3.35 TB/s): bytes, about 12 ns.  What bounds a
//    launch is the chain of dependent operations: substitution row by row
//    is bs(bs-1)/2 = 2,016 dependent FMAs a column at bs = 64.
//
//    Design: blocks of 128 threads each own kTrsmCols = 8 columns of B (8
//    blocks at n = 64).  A block stages A and its B columns in one round of
//    cp.async copies, then inverts the bs/panel diagonal panels at once
//    (they do not depend on B), one thread per column of an inverse, by
//    substitution on the identity: panel(panel-1)/2 = 120 dependent FMAs at
//    panel 16, with the diagonal's reciprocals taken first, one a thread.
//    Then, for each panel, the block's threads compute X_p = inv_p B_p
//    (`panel` FMAs an element) and, after a barrier, the trailing update
//    of the rows below (`panel` FMAs an element), each thread one row and
//    four columns, so that a float4 shared load feeds four FMAs (96 threads
//    for the up to 48 trailing rows at bs 64).  One to three warps take
//    part in a step, too few to hide a shared load's latency, so each step
//    loads eight steps' operands into registers before their FMAs
//    (dot_panel), and the inversion loads the next column of L while it
//    works on this one.  The default panel, 16, is a compile-time instance
//    (as the JAX kernel compiles its panel), with the inverse's column in
//    registers; other panels run a runtime-panel instance of the same
//    algorithm.  At (64, panel 16) no chain of dependent FMAs is longer
//    than 120 + 4 * (16 + 16) = 248, against 2,016.  Only A's upper
//    triangle is read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef TILE
#define TILE 64
#endif

// The launches' arguments, packed by the caller into one block (one
// ctypes argument in place of a dozen, each of which ctypes would convert
// on every call).  Python packs them with struct format "@5P7q" and
// "@4P4q"; tiles_gemm_args_bytes / tiles_trsm_args_bytes give the sizes
// to check against.  They live outside the unnamed namespace so that the
// extern "C" entries that take them keep external linkage.
struct GemmArgs {
  const void* a;
  const void* b;
  const void* c;                        // null unless sub
  void* out;
  void* stream;
  int64_t M, N, K, in_dtype, out_dtype, trans_a, sub;
};

struct TrsmArgs {
  const void* a;
  const void* b;
  void* out;
  void* stream;
  int64_t bs, n, panel, dtype;
};

namespace {

constexpr int kTile = TILE;
constexpr int kSub = 16;                // a GEMM block's sub-tile edge
constexpr int kGemmThreads = 64;        // 8 x 8 threads, 2 x 2 outputs each
constexpr int kChunkK = 1024;           // K staged in one round
constexpr int kTrsmThreads = 128;
constexpr int kTrsmCols = 8;            // columns of B a TRSM block owns
static_assert(kTile % kSub == 0 && kTile >= 16 && kTile <= 128,
              "TILE must be a multiple of 16 in [16, 128]");
// The most dynamic shared memory one block may ask for on sm_90, and the
// most it gets without opting in.
constexpr size_t kMaxSmem = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// Row pitch, in elements, of the [16][K] op(A) rows of trans_a = 0: at
// least kc, a multiple of 8 elements (16 bytes for bf16), and 8 mod 32 so
// that rows ty = 0..3 of a warp fall in distinct banks.
__host__ __device__ constexpr int a_row_pitch(int kc) {
  return ((kc + 31) / 32) * 32 + 8;
}

// Byte offsets of the GEMM's shared regions: op(A), then B, then C.
struct GemmSmem {
  size_t b, c, total;
};

__host__ __device__ GemmSmem gemm_layout(int kc, int trans_a, size_t in_size,
                                         size_t out_size) {
  GemmSmem s;
  const size_t a_elems =
      trans_a ? (size_t)kc * kSub : (size_t)kSub * a_row_pitch(kc);
  s.b = round16(a_elems * in_size);
  s.c = s.b + round16((size_t)kc * kSub * in_size);
  s.total = s.c + (size_t)kSub * kSub * out_size;
  return s;
}

// Byte offsets of the TRSM's shared regions: A, the reciprocals of its
// diagonal ([bs] f32), the panel inverses ([bs][panel + 1] f32), the
// right-hand sides being updated and the solution ([bs][kTrsmCols] f32
// each), and the raw bf16 B columns.
struct TrsmSmem {
  size_t rinv, inv, xs, ys, braw, total;
};

__host__ __device__ TrsmSmem trsm_layout(int bs, int panel, size_t el) {
  TrsmSmem s;
  s.rinv = round16((size_t)bs * bs * el);
  s.inv = s.rinv + round16((size_t)bs * sizeof(float));
  s.xs = s.inv + round16((size_t)bs * (panel + 1) * sizeof(float));
  s.ys = s.xs + (size_t)bs * kTrsmCols * sizeof(float);
  s.braw = s.ys + (size_t)bs * kTrsmCols * sizeof(float);
  s.total = s.braw + round16((size_t)bs * kTrsmCols * el);
  return s;
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

// 16 bytes from global to shared memory, asynchronously; only the first
// `bytes` are read and the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Starts the copy of the rows x cols window of a row-major matrix at `src`
// (row pitch `pitch` elements) into shared memory at `dst` (row pitch
// `dpitch`), zero past `valid_rows` and `valid_cols`.  With `vec`, by
// 16-byte cp.async: `src`, `pitch` and `dpitch` are then 16-byte aligned
// (in bytes) and the copies complete at the next cp_async_wait_all.
// Without, element by element (any alignment), complete on return.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dpitch, const T* src,
                                      int64_t pitch, int rows, int cols,
                                      int valid_rows, int valid_cols,
                                      bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);
    const int per_row = (cols + kE - 1) / kE;
    for (int e = tid; e < rows * per_row; e += nthreads) {
      const int r = e / per_row, c = (e % per_row) * kE;
      const int n = r < valid_rows ? min(max(valid_cols - c, 0), kE) : 0;
      cp_async16(dst + r * dpitch + c, n ? src + r * pitch + c : src,
                 n * (int)sizeof(T));
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, c = e % cols;
      dst[r * dpitch + c] = (r < valid_rows && c < valid_cols)
                                ? src[r * pitch + c]
                                : from_f32<T>(0.f);
    }
  }
}

// vec_mask: bit 0 A, bit 1 B, bit 2 C may be staged by 16-byte copies.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tile_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                 const TOut* __restrict__ c, TOut* __restrict__ out,
                 int M, int N, int K, int trans_a, int sub, int vec_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kcmax = min(K, kChunkK);
  const GemmSmem lay = gemm_layout(kcmax, trans_a, sizeof(TIn),
                                   sizeof(TOut));
  TIn* As = reinterpret_cast<TIn*>(smem);
  TIn* Bs = reinterpret_cast<TIn*>(smem + lay.b);
  TOut* Cs = reinterpret_cast<TOut*>(smem + lay.c);
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int row0 = blockIdx.y * kSub, col0 = blockIdx.x * kSub;
  const int vrows = M - row0, vcols = N - col0;
  // op(A)[r][k] is As[r * a_r + k * a_k]
  const int a_r = trans_a ? 1 : a_row_pitch(kcmax);
  const int a_k = trans_a ? kSub : 1;

  if (sub)
    stage(Cs, kSub, c + (int64_t)row0 * N + col0, N, kSub, kSub, vrows,
          vcols, vec_mask & 4, tid, kGemmThreads);
  float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kc = min(kChunkK, K - k0);
    if (k0) __syncthreads();            // the last round's reads are done
    if (trans_a)
      stage(As, kSub, a + (int64_t)k0 * M + row0, M, kc, kSub, kc, vrows,
            vec_mask & 1, tid, kGemmThreads);
    else
      stage(As, a_r, a + (int64_t)row0 * K + k0, K, kSub, kc, vrows, kc,
            vec_mask & 1, tid, kGemmThreads);
    stage(Bs, kSub, b + (int64_t)k0 * N + col0, N, kc, kSub, kc, vcols,
          vec_mask & 2, tid, kGemmThreads);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kc; ++k) {
      const float a0 = to_f32(As[ty * a_r + k * a_k]);
      const float a1 = to_f32(As[(ty + 8) * a_r + k * a_k]);
      const float b0 = to_f32(Bs[k * kSub + tx]);
      const float b1 = to_f32(Bs[k * kSub + tx + 8]);
      acc00 = fmaf(a0, b0, acc00);
      acc01 = fmaf(a0, b1, acc01);
      acc10 = fmaf(a1, b0, acc10);
      acc11 = fmaf(a1, b1, acc11);
    }
  }
  if (K <= 0 && sub) {                  // C was staged but never waited on
    cp_async_wait_all();
    __syncthreads();
  }

  const float acc[2][2] = {{acc00, acc01}, {acc10, acc11}};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 8 * i;
    if (r >= vrows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = tx + 8 * j;
      if (col >= vcols) continue;
      float v = acc[i][j];
      if (sub) v = to_f32(Cs[r * kSub + col]) - v;
      out[(int64_t)(row0 + r) * N + col0 + col] = from_f32<TOut>(v);
    }
  }
}

// s + sum over j < len of coef(j) * row(j), four columns at once, in the
// order of j.  Each 8 steps' operands are loaded before their FMAs: few
// warps take part in a panel step, so none would hide a load's latency.
template <typename Coef, typename Row>
__device__ __forceinline__ float4 dot_panel(int len, Coef coef, Row row,
                                            float4 s) {
  constexpr int kAhead = 8;
  for (int j0 = 0; j0 < len; j0 += kAhead) {
    float w[kAhead];
    float4 x[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int j = min(j0 + q, len - 1);
      w[q] = coef(j);
      x[q] = row(j);
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      if (j0 + q < len)
        s = make_float4(fmaf(w[q], x[q].x, s.x), fmaf(w[q], x[q].y, s.y),
                        fmaf(w[q], x[q].z, s.z), fmaf(w[q], x[q].w, s.w));
  }
  return s;
}

// P > 0: the panel is the compile-time P, so every loop over it has a
// fixed trip count and each thread keeps its column of an inverse in
// registers.  P = 0: the panel is the runtime `panel_rt`, any divisor of
// bs.  vec_mask: bit 0 A, bit 1 B may be staged by 16-byte copies.
template <typename T, int P>
__global__ void __launch_bounds__(kTrsmThreads)
trsm_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, int bs, int n, int panel_rt,
                 int vec_mask) {
  const int panel = P > 0 ? P : panel_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  const TrsmSmem lay = trsm_layout(bs, panel, sizeof(T));
  T* As = reinterpret_cast<T*>(smem);                 // [bs][bs], raw A
  float* Rinv = reinterpret_cast<float*>(smem + lay.rinv);
  float* Inv = reinterpret_cast<float*>(smem + lay.inv);
  float* Xs = reinterpret_cast<float*>(smem + lay.xs);
  float* Ys = reinterpret_cast<float*>(smem + lay.ys);
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kTrsmCols;
  const int vcols = min(kTrsmCols, n - col0);
  const int ip = panel + 1;             // Inv's row pitch: no bank conflict
  // L[r][q] = A[q][r], read from A's upper triangle (q <= r)
  auto L = [&](int r, int q) { return to_f32(As[q * bs + r]); };

  stage(As, bs, a, bs, bs, bs, bs, bs, vec_mask & 1, tid, kTrsmThreads);
  T* Bs = sizeof(T) == sizeof(float) ? reinterpret_cast<T*>(Xs)
                                     : reinterpret_cast<T*>(smem + lay.braw);
  stage(Bs, kTrsmCols, b + col0, n, bs, kTrsmCols, bs, vcols, vec_mask & 2,
        tid, kTrsmThreads);
  cp_async_wait_all();
  __syncthreads();
  if (sizeof(T) != sizeof(float))
    for (int e = tid; e < bs * kTrsmCols; e += kTrsmThreads)
      Xs[e] = to_f32(Bs[e]);
  // each of the diagonal's reciprocals once, by one thread: a division is
  // a long sequence, kept off the inversion's chain
  for (int t = tid; t < bs; t += kTrsmThreads) Rinv[t] = 1.f / L(t, t);
  __syncthreads();

  // The diagonal panels' inverses, all at once: thread t builds column
  // c = t % panel of panel t / panel's inverse from the identity, row i as
  // (e_i - sum_{j<i} L_ij inv_j) * (1 / L_ii) (rows above the diagonal
  // come out 0).  With a compile-time panel the sums are kept in registers
  // and each row, once found, is taken off the rows below it: the same
  // FMAs in the same order, with no shared-memory round trip between rows.
  for (int t = tid; t < bs; t += kTrsmThreads) {
    const int c = t % panel, p0 = t - c;
    if constexpr (P > 0) {
      // col: column j of the panel's L, loaded one column ahead
      float acc[P], rinv[P], col[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        acc[i] = i == c ? 1.f : 0.f;
        rinv[i] = Rinv[p0 + i];
        col[i] = L(p0 + i, p0);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float next[P];
#pragma unroll
        for (int i = j + 2; i < P; ++i) next[i] = L(p0 + i, p0 + j + 1);
        const float x = acc[j] * rinv[j];
        Inv[(p0 + j) * ip + c] = x;
#pragma unroll
        for (int i = j + 1; i < P; ++i) acc[i] = fmaf(-col[i], x, acc[i]);
#pragma unroll
        for (int i = j + 2; i < P; ++i) col[i] = next[i];
      }
    } else {
      for (int i = 0; i < panel; ++i) {
        float s = i == c ? 1.f : 0.f;
#pragma unroll 8
        for (int j = 0; j < i; ++j)
          s = fmaf(-L(p0 + i, p0 + j), Inv[(p0 + j) * ip + c], s);
        Inv[(p0 + i) * ip + c] = s * Rinv[p0 + i];
      }
    }
  }
  __syncthreads();

  // Each thread of the two steps takes one row and four of the block's
  // columns (h = 0 or 4), as a float4: one shared load of a coefficient
  // and one of a float4 feed four FMAs.
  for (int p0 = 0; p0 < bs; p0 += panel) {
    // X_p = inv_p B_p over the whole panel, as the JAX kernel's inv @ rhs
    // (inv_p is exactly 0 above its diagonal, so the loop needs no
    // branch), written out as it is found
    for (int e = tid; e < panel * 2; e += kTrsmThreads) {
      const int i = p0 + e / 2, h = (e % 2) * 4;
      const float4 s = dot_panel(
          panel, [&](int j) { return Inv[i * ip + j]; },
          [&](int j) {
            return *reinterpret_cast<const float4*>(
                Xs + (p0 + j) * kTrsmCols + h);
          },
          make_float4(0.f, 0.f, 0.f, 0.f));
      *reinterpret_cast<float4*>(Ys + i * kTrsmCols + h) = s;
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (h + q < vcols)
          out[(int64_t)i * n + col0 + h + q] = from_f32<T>(v[q]);
    }
    __syncthreads();
    // the rows below: B_tail -= L[tail, p] X_p
    const int tail = p0 + panel;
    for (int e = tid; e < (bs - tail) * 2; e += kTrsmThreads) {
      const int r = tail + e / 2, h = (e % 2) * 4;
      float4* xr = reinterpret_cast<float4*>(Xs + r * kTrsmCols + h);
      *xr = dot_panel(
          panel, [&](int j) { return -L(r, p0 + j); },
          [&](int j) {
            return *reinterpret_cast<const float4*>(
                Ys + (p0 + j) * kTrsmCols + h);
          },
          *xr);
    }
    __syncthreads();
  }
}

bool aligned16(const void* p, int64_t pitch, size_t el) {
  return (uintptr_t)p % 16 == 0 && (pitch * (int64_t)el) % 16 == 0;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename TIn, typename TOut>
int launch_gemm(const void* a, const void* b, const void* c, void* out,
                int M, int N, int K, int trans_a, int sub,
                cudaStream_t stream) {
  const size_t smem = gemm_layout(min(K, kChunkK), trans_a, sizeof(TIn),
                                  sizeof(TOut)).total;
  const cudaError_t err = allow_smem(gemm_tile_kernel<TIn, TOut>, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_mask =
      (aligned16(a, trans_a ? M : K, sizeof(TIn)) ? 1 : 0) |
      (aligned16(b, N, sizeof(TIn)) ? 2 : 0) |
      (sub && aligned16(c, N, sizeof(TOut)) ? 4 : 0);
  const dim3 grid((N + kSub - 1) / kSub, (M + kSub - 1) / kSub);
  gemm_tile_kernel<TIn, TOut><<<grid, kGemmThreads, smem, stream>>>(
      (const TIn*)a, (const TIn*)b, (const TOut*)c, (TOut*)out, M, N, K,
      trans_a, sub, vec_mask);
  return (int)cudaGetLastError();
}

// The default panel (16, the JAX kernel's and the Cholesky path's) runs
// the compile-time instance; every other panel the runtime one.
template <typename T>
int launch_trsm(const void* a, const void* b, void* out, int bs, int n,
                int panel, cudaStream_t stream) {
  const auto kernel =
      panel == 16 ? trsm_tile_kernel<T, 16> : trsm_tile_kernel<T, 0>;
  const size_t smem = trsm_layout(bs, panel, sizeof(T)).total;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_mask = (aligned16(a, bs, sizeof(T)) ? 1 : 0) |
                       (aligned16(b, n, sizeof(T)) ? 2 : 0);
  const int blocks = (n + kTrsmCols - 1) / kTrsmCols;
  kernel<<<blocks, kTrsmThreads, smem, stream>>>(
      (const T*)a, (const T*)b, (T*)out, bs, n, panel, vec_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launch takes its packed
// arguments, launches on their `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported
// by the caller.  Operands are contiguous and row-major; dtype codes are 0
// for f32 and 1 for bf16.

extern "C" int tiles_tile_edge() { return kTile; }

// Whether trsm_tile_kernel can hold A, its panel inverses and its columns
// for this bs at any panel and dtype.
extern "C" int tiles_trsm_fits(int bs) {
  return bs > 0 && trsm_layout(bs, bs, sizeof(float)).total <= kMaxSmem;
}

extern "C" int tiles_gemm_args_bytes() { return (int)sizeof(GemmArgs); }
extern "C" int tiles_trsm_args_bytes() { return (int)sizeof(TrsmArgs); }

extern "C" int tiles_gemm_launch(const GemmArgs* g) {
  const int M = (int)g->M, N = (int)g->N, K = (int)g->K;
  const int trans_a = (int)g->trans_a, sub = (int)g->sub;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)g->stream;
  if (g->in_dtype == 0 && g->out_dtype == 0)
    return launch_gemm<float, float>(g->a, g->b, g->c, g->out, M, N, K,
                                     trans_a, sub, s);
  if (g->in_dtype == 0 && g->out_dtype == 1)
    return launch_gemm<float, __nv_bfloat16>(g->a, g->b, g->c, g->out, M, N,
                                             K, trans_a, sub, s);
  if (g->in_dtype == 1 && g->out_dtype == 0)
    return launch_gemm<__nv_bfloat16, float>(g->a, g->b, g->c, g->out, M, N,
                                             K, trans_a, sub, s);
  if (g->in_dtype == 1 && g->out_dtype == 1)
    return launch_gemm<__nv_bfloat16, __nv_bfloat16>(g->a, g->b, g->c,
                                                     g->out, M, N, K,
                                                     trans_a, sub, s);
  return (int)cudaErrorInvalidValue;
}

// Refuses (cudaErrorInvalidValue) a panel that does not divide bs, and a
// bs whose tile does not fit in one block's shared memory.
extern "C" int tiles_trsm_launch(const TrsmArgs* t) {
  const int bs = (int)t->bs, n = (int)t->n, panel = (int)t->panel;
  if (bs <= 0 || n <= 0) return (int)cudaSuccess;
  if (panel <= 0 || bs % panel || !tiles_trsm_fits(bs))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)t->stream;
  if (t->dtype == 0)
    return launch_trsm<float>(t->a, t->b, t->out, bs, n, panel, s);
  if (t->dtype == 1)
    return launch_trsm<__nv_bfloat16>(t->a, t->b, t->out, bs, n, panel, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tiles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
