// Chunked decayed linear attention for Hopper (sm_90a), redesigned: chunks
// in parallel, the decay factored at sub-chunks of 16, and the products on
// tensor cores for bf16 operands.  The route linear_attn.kernel_for names
// "subchunk": dk = dv = 64 (RWKV6's heads) at chunk 16, 32 or 64, f32 or
// bf16 r/k/v/out, f32 or bf16 w and u.  Every other call keeps the serial
// kernel (linear_attn.cu).  Replaces the Pallas TPU kernel
//   repro/kernels/linear_attn.py:84 linear_attention (_linear_attn_kernel :38)
// and computes, for every row bh of r, k, w (BH, T, 64) and v (BH, T, 64)
// with the bonus u[bh % H], from a zero state,
//
//   o_t = r_t S_{t-1} + ((r_t * u) . k_t) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// in the TPU kernel's chunked closed form (A is the running sum of log2 w
// inside a chunk of C steps, a_inc inclusive, a_exc[t] = a_inc[t-1],
// a_end its last row):
//
//   scores[t,s] = sum_d r[t,d] k[s,d] 2^(a_exc[t,d] - a_inc[s,d])  (s < t)
//   scores[t,t] = sum_d r[t,d] u[d] k[t,d]
//   o           = (r 2^a_exc) S_c + scores v
//   S_{c+1}     = 2^a_end * S_c + dS_c,  dS_c = (k 2^(a_end - a_inc))^T v
//
// Design, three launches on one stream (the wrapper is one call):
//   1. linear_attn_state_kernel, one block per (bh, chunk): dS_c and
//      2^a_end, which depend on the chunk alone, into the caller's f32
//      scratch;
//   2. linear_attn_scan_kernel, one thread per four state elements of a
//      row: the only sequential part, S_c for every chunk (written over
//      dS_c) and the final state, an elementwise pass of one FMA a chunk;
//   3. linear_attn_output_kernel, one block per (bh, chunk): the chunk's
//      output from its own inputs and S_c.
// The scan and the output kernel are launched with programmatic dependent
// launch: each may start while the kernel before it runs and waits
// (griddepcontrol.wait) only where it reads what that kernel writes, so
// the output kernel stages its chunk, sums the decays and scores the
// diagonal blocks while the state increments and the scan run.
// So the (bh, chunk) pairs run in parallel (256 blocks at the path shape,
// BH 32, T 512, C 64), where the serial kernel (linear_attn.cu) walks the
// chunks of a row in one block (and repeats the scores in each of four dv
// slices).
//
// The scores are factored at sub-chunks of 16 (GLA's secondary chunking).
// For t in band i (rows 16i..16i+15) and s in an earlier band j, with
// P_i = a_inc[16i - 1] (0 for i = 0) and E_j = a_inc[16j + 15],
//   2^(a_exc[t] - a_inc[s])
//     = 2^(a_exc[t] - P_i) 2^(P_i - E_j) 2^(E_j - a_inc[s])
// and every exponent is <= 0, so any decay stays overflow-safe, as in the
// TPU kernel (a factoring about the chunk's start would overflow f32 within
// seven steps of w = 1e-6).  With R^[t] = r[t] 2^(a_exc[t] - P_i) and
// K~[s] = k[s] 2^(E_j - a_inc[s]), the off-diagonal 16 x 16 blocks are the
// products (R^ * 2^(P_i - E_j)) K~^T, and r 2^a_exc = R^ 2^P_i.  Inside a
// diagonal block the second half's rows against the first half's columns
// are factored the same way at the first half's last step, so the pairwise
// exp2 is left to the halves' own lower triangles: NS * 56 * 64 a chunk
// (14,336 at C 64, once for all of dv, plus 4,096 for the half factors),
// against 4 x 129k in the serial kernel.
//
// Products.  bf16 operands: mma.sync m16n8k16 (bf16 in, f32 accumulate)
// for the scores, scores.v, (r 2^a_exc).S_c and the state increment.  The
// decayed operands and S_c are f32 values; each is split into hi = bf16(x)
// and lo = bf16(x - hi), and the product takes hi.hi + lo.hi + hi.lo (v is
// exact in bf16: hi.v + lo.v), about 16 bits.  The scores take a third
// term for scores.v (hi, mid, lo: about 24 bits): with two, a plain mirror
// of this arithmetic flips the bf16 output's rounding about twice as often
// as f32 products do (2,045 against 1,083 of 1,048,576 outputs at the path
// shape, tools/linear_attn_rounding.py), and with one rounding (the flash
// kernel's P) it misses the port's bf16 tolerance of 1e-2 and the state's
// 2e-4 (tests/test_torch_linear_attn.py).  f32 operands keep f32 FMAs (TF32
// keeps ~3 digits, which the f32 tolerance of 2e-4 does not admit); they
// gain from the parallel chunks and the factored scores alone.
//
// Staging: every block reads its rows of r, k, v and w row by row (each
// thread's loads all in flight before its first store) into row-major
// shared arrays, and S_c by cp.async while the chunk is scored; the
// operands the products read down a column (k-major: v, S_c, K~ in the
// state kernel) sit at a pitch of 4 mod 32 floats, where a fragment's
// lanes fall in 32 different banks.  The diagonal blocks' pairwise terms
// take 2 x 2 register tiles (eight loads for four exp2 a d) over two
// threads a tile.  exp2 is the SFU's approximate one.
//
// log w is taken of max(w, 1e-30) as the TPU kernel does, and each decay
// exponent is clamped at 0 like its min(., 0).  r, k, v and the output
// share one type; w and u are read in their own types; everything is
// accumulated in f32 and the output is rounded once.
//
// Bound at the serve path's shape (BH 32, T 512, dk = dv = 64, C 64; bf16
// r, k, v, u and out, f32 w and state): 13.1 MB moved, 3.91 us at 3.35
// TB/s; the recurrence's 0.34 G operations (chip_smoke.py's linear_work),
// 0.34 us at the bf16 tensor cores' 989 TFLOP/s, which run its products:
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

// One launch's arguments, packed by the wrapper into a single ctypes
// argument (struct.Struct("@9P9q") in linear_attn.py); linear_attn.cu
// takes the same block.
struct LinearAttnArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  void* out;
  void* state;
  void* scratch;
  void* stream;
  int64_t bh;
  int64_t t_len;
  int64_t dk;
  int64_t dv;
  int64_t heads;
  int64_t chunk;
  int64_t dtype;
  int64_t w_dtype;
  int64_t u_dtype;
};

namespace {

constexpr int kThreads = 256;
constexpr int kD = 64;                   // dk = dv
constexpr int kStateFloats = kD * kD;
// Row pitches.  kLd (8 mod 32 floats) for arrays whose mma fragments are
// read along a row (float2 loads, conflict-free); kLdK (4 mod 32) for
// arrays read down a column (k-major operands: the lanes' rows 2*tig and
// columns g fall in 32 different banks) and read as float4 rows.
constexpr int kLd = 72;
constexpr int kLdK = 68;

__host__ __device__ constexpr int out_smem_floats(int c) {
  return 2 * c * kLd + (c + 1) * kLd + c * (c + 8) + c * kLdK + kD * kLdK +
         kD + 6 * kD + 4 * kD;
}
__host__ __device__ constexpr int state_smem_floats(int c) {
  return 3 * c * kLdK + 4 * kD;
}

// Phase cuts, for timing a kernel's phases (tools/linear_attn_ab.py
// --cuts): built with -DLINEAR_ATTN_CUT=n, every thread of a block exits
// at PHASE_CUT(n) by the PTX exit, which the compiler cannot see through,
// so it keeps the phases before the cut (a return would leave their
// results dead).  1-6 cut the output kernel, 7-8 the state kernel; the
// port's builds leave it 0, which cuts nothing.
#ifndef LINEAR_ATTN_CUT
#define LINEAR_ATTN_CUT 0
#endif
#define PHASE_CUT(n) \
  if (LINEAR_ATTN_CUT == (n)) asm volatile("exit;")

// ---- element access ------------------------------------------------------

// Four consecutive elements as f32; vector loads when `vec` (the arrays'
// bases are aligned), element loads otherwise.
__device__ __forceinline__ void ld4(const float* p, bool vec, float o[4]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = p[i];
  }
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, bool vec,
                                    float o[4]) {
  if (vec) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// Four decays, w in f32 or bf16.
__device__ __forceinline__ void ld4_w(const void* w, int64_t off,
                                      bool w_bf16, bool vec, float o[4]) {
  if (w_bf16)
    ld4(static_cast<const __nv_bfloat16*>(w) + off, vec, o);
  else
    ld4(static_cast<const float*>(w) + off, vec, o);
}

__device__ __forceinline__ void st4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float ld_u(const void* u, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[i])
              : static_cast<const float*>(u)[i];
}

// log2 of max(w, 1e-30), accurate: lg2.approx's error is absolute (about
// 2^-22 near 1), a large share of log2 w for the decays near 1 that RWKV6
// has, and it moved rwkv6-1.6b's served tokens past the smoke's
// self-check (tools/rwkv6_selfcheck.py).  2^min(x, 0) on the SFU
// (ex2.approx, about 2^-22 relative; denormal results flush to 0).
__device__ __forceinline__ float log2_w(float w) {
  return log2f(fmaxf(w, 1e-30f));
}
__device__ __forceinline__ float exp2_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fminf(x, 0.f)));
  return y;
}

// Programmatic dependent launch: the next kernel on the stream may start
// (its blocks wait in pdl_wait for this grid to finish and its writes to
// be visible); without the launch attribute both are no-ops.
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// 16 bytes from global to shared memory without a register round trip.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(addr), "l"(gmem));
}

// ---- tensor-core pieces --------------------------------------------------

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as a bf16 pair, x0 in the low half: exact for values that are
// bf16 already.
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}

// hi = bf16(x), lo = bf16(x - hi), for a pair.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// hi, mid and lo: three bf16 terms, about 24 bits.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The A fragment (16 x 16) of the row-major f32 array X (pitch ld) at rows
// r0.., columns k0.., each column scaled by scale[col] when scale is
// given: the four (row, column pair) values of this lane, x[0..3] in the
// fragment's register order.
__device__ __forceinline__ void a_vals(const float* X, int ld, int r0, int k0,
                                       const float* scale, float2 x[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = k0 + 2 * (lane & 3);
  x[0] = ld2(X + (r0 + g) * ld + c);
  x[1] = ld2(X + (r0 + g + 8) * ld + c);
  x[2] = ld2(X + (r0 + g) * ld + c + 8);
  x[3] = ld2(X + (r0 + g + 8) * ld + c + 8);
  if (scale) {
    const float2 s0 = ld2(scale + c), s1 = ld2(scale + c + 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 s = i < 2 ? s0 : s1;
      x[i] = make_float2(x[i].x * s.x, x[i].y * s.y);
    }
  }
}

// The A fragment of A = X^T, X k-major (X[k][m], pitch ld).
__device__ __forceinline__ void a_vals_t(const float* X, int ld, int m0,
                                         int k0, float2 x[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, k = k0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + (i & 1) * 8, kk = k + (i >> 1) * 8;
    x[i] = make_float2(X[kk * ld + m], X[(kk + 1) * ld + m]);
  }
}

// The B fragment (16 x 8) whose column n is row n0 + n of Y (Y[n][k],
// pitch ld): y[0..1] in register order.
__device__ __forceinline__ void b_vals(const float* Y, int ld, int n0, int k0,
                                       float2 y[2]) {
  const int lane = threadIdx.x & 31;
  const float* p = Y + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  y[0] = ld2(p);
  y[1] = ld2(p + 8);
}

// The B fragment of Y k-major (Y[k][n], pitch ld).
__device__ __forceinline__ void b_vals_t(const float* Y, int ld, int n0,
                                         int k0, float2 y[2]) {
  const int lane = threadIdx.x & 31, n = n0 + (lane >> 2);
  const int k = k0 + 2 * (lane & 3);
  y[0] = make_float2(Y[k * ld + n], Y[(k + 1) * ld + n]);
  y[1] = make_float2(Y[(k + 8) * ld + n], Y[(k + 9) * ld + n]);
}

template <int N>
__device__ __forceinline__ void split_all(const float2* x, uint32_t* hi,
                                          uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i].x, x[i].y, hi[i], lo[i]);
}

// ---- shared steps --------------------------------------------------------

// The inclusive running sum down the C rows of each of the 64 columns of A
// (pitch ld), in place: four threads a column, a quarter of the rows each,
// then each quarter's offset from the totals before it.  `tot` holds 256
// floats.  Ends behind a barrier.
template <int C>
__device__ __forceinline__ void cumsum_rows(float* A, int ld, float* tot) {
  constexpr int RQ = C / 4;
  const int d = threadIdx.x & 63, q = threadIdx.x >> 6;
  float x[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) x[i] = A[(q * RQ + i) * ld + d];
#pragma unroll
  for (int i = 1; i < RQ; ++i) x[i] += x[i - 1];
  tot[q * 64 + d] = x[RQ - 1];
  __syncthreads();
  float off = 0.f;
  for (int p = 0; p < q; ++p) off += tot[p * 64 + d];
#pragma unroll
  for (int i = 0; i < RQ; ++i) A[(q * RQ + i) * ld + d] = x[i] + off;
  __syncthreads();
}

// The pair (i, j < i) of bands that off-diagonal block p stands for.
__device__ __forceinline__ void band_pair(int p, int& i, int& j) {
  i = 1;
  while ((i + 1) * i / 2 <= p) ++i;
  j = p - i * (i - 1) / 2;
}

// The (row, column) of entry l of a lower triangle with its diagonal,
// row by row.
__device__ __forceinline__ void tri_index(int l, int& row, int& col) {
  int t = (int)((sqrtf(8.f * l + 1.f) - 1.f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= l) ++t;
  while (t * (t + 1) / 2 > l) --t;
  row = t;
  col = l - t * (t + 1) / 2;
}

// ---- 1. the chunk's state increment and decay ------------------------------

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
linear_attn_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                         const void* __restrict__ w,
                         float* __restrict__ scratch, int t_len, bool w_bf16,
                         bool vec) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int IT = C * 16 / kThreads;  // four-element loads a thread
  extern __shared__ float smem[];
  float* As = smem;                      // [C][kLdK]: log2 w, then a_inc
  float* Ks = As + C * kLdK;             // [C][kLdK]: k, then decayed
  float* Vs = Ks + C * kLdK;             // [C][kLdK]: v
  float* tot = Vs + C * kLdK;            // [256]

  const int tid = threadIdx.x, bh = blockIdx.x, c = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int64_t row0 = (int64_t)bh * t_len + (int64_t)c * C;
  pdl_launch_dependents();

  // every load in flight before the first store
  float xk[IT][4], xv[IT][4], xw[IT][4];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + kThreads * it, s = e >> 4, dq = e & 15;
    const int64_t off = (row0 + s) * kD + 4 * dq;
    ld4(k + off, vec, xk[it]);
    ld4(v + off, vec, xv[it]);
    ld4_w(w, off, w_bf16, vec, xw[it]);
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + kThreads * it, s = e >> 4, dq = e & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) xw[it][i] = log2_w(xw[it][i]);
    st4(Ks + s * kLdK + 4 * dq, xk[it]);
    st4(Vs + s * kLdK + 4 * dq, xv[it]);
    st4(As + s * kLdK + 4 * dq, xw[it]);
  }
  __syncthreads();
  PHASE_CUT(7);
  cumsum_rows<C>(As, kLdK, tot);

  float* dS = scratch + ((int64_t)bh * n_chunks + c) * kStateFloats;
  float* decay = scratch + (int64_t)gridDim.x * n_chunks * kStateFloats +
                 ((int64_t)bh * n_chunks + c) * kD;
#pragma unroll
  for (int it = 0; it < C * kD / kThreads; ++it) {
    const int s = it * (kThreads / kD) + tid / kD, d = tid % kD;
    Ks[s * kLdK + d] *= exp2_neg(As[(C - 1) * kLdK + d] - As[s * kLdK + d]);
  }
  if (tid < kD) decay[tid] = exp2_neg(As[(C - 1) * kLdK + tid]);
  __syncthreads();

  PHASE_CUT(8);
  // dS[d][j] = sum_s K~[s][d] v[s][j]
  if (kTC) {
    const int warp = tid >> 5, lane = tid & 31;
    const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      float2 x[4];
      uint32_t ahi[4], alo[4];
      a_vals_t(Ks, kLdK, m0, 16 * ks, x);
      split_all<4>(x, ahi, alo);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float2 y[2];
        b_vals_t(Vs, kLdK, n0 + 8 * n, 16 * ks, y);
        const uint32_t b[2] = {pack(y[0].x, y[0].y), pack(y[1].x, y[1].y)};
        mma(acc[n], ahi, b);
        mma(acc[n], alo, b);
      }
    }
    const int g = lane >> 2, j = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<float2*>(dS + (m0 + g) * kD + n0 + 8 * n + j) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(dS + (m0 + g + 8) * kD + n0 + 8 * n + j) =
          make_float2(acc[n][2], acc[n][3]);
    }
  } else {
    const int d0 = 4 * (tid >> 4), j0 = 4 * (tid & 15);
    float acc[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + s * kLdK + d0);
      const float4 vv = *reinterpret_cast<const float4*>(Vs + s * kLdK + j0);
      const float kq[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][0] = fmaf(kq[q], vv.x, acc[q][0]);
        acc[q][1] = fmaf(kq[q], vv.y, acc[q][1]);
        acc[q][2] = fmaf(kq[q], vv.z, acc[q][2]);
        acc[q][3] = fmaf(kq[q], vv.w, acc[q][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(dS + (d0 + q) * kD + j0) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

// ---- 2. the scan over chunks ------------------------------------------------

// One thread per four elements of a row's state: S_c over the chunks,
// written over dS_c, and the final state.  Grid (BH, 4): few and small
// blocks, so that the output kernel's blocks fit beside them and the
// state kernel's.
constexpr int kScanBlocks = kStateFloats / 4 / kThreads;

__global__ void __launch_bounds__(kThreads)
linear_attn_scan_kernel(float* __restrict__ scratch,
                        float* __restrict__ state, int n_chunks) {
  constexpr int kAhead = 8;              // chunks whose loads are in flight
  const int bh = blockIdx.x;
  const int e = 4 * (blockIdx.y * kThreads + threadIdx.x);
  float* dS = scratch + (int64_t)bh * n_chunks * kStateFloats + e;
  const float* g = scratch + (int64_t)gridDim.x * n_chunks * kStateFloats +
                   (int64_t)bh * n_chunks * kD + e / kD;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  pdl_launch_dependents();
  pdl_wait();                            // the state kernel's dS_c
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float4 x[kAhead];
    float gg[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < n_chunks) {
        x[q] = *reinterpret_cast<const float4*>(
            dS + (int64_t)(c0 + q) * kStateFloats);
        gg[q] = g[(int64_t)(c0 + q) * kD];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < n_chunks) {
        *reinterpret_cast<float4*>(dS + (int64_t)(c0 + q) * kStateFloats) =
            S;
        S = make_float4(fmaf(gg[q], S.x, x[q].x), fmaf(gg[q], S.y, x[q].y),
                        fmaf(gg[q], S.z, x[q].z), fmaf(gg[q], S.w, x[q].w));
      }
    }
  }
  *reinterpret_cast<float4*>(state + (int64_t)bh * kStateFloats + e) = S;
}

// ---- 3. the chunk's output --------------------------------------------------

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
linear_attn_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const void* __restrict__ w,
                          const void* __restrict__ u, T* __restrict__ out,
                          const float* __restrict__ scratch, int t_len,
                          int heads, bool w_bf16, bool u_bf16, bool vec) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NS = C / 16;             // bands of 16 rows
  constexpr int NP = NS * (NS - 1) / 2;  // off-diagonal band pairs
  constexpr int LDP = C + 8;
  constexpr int IT = C * 16 / kThreads;  // four-element loads a thread
  extern __shared__ float smem[];
  float* Rs = smem;                      // [C][kLd]: r, then R^
  float* Ks = Rs + C * kLd;              // [C][kLd]: k, then K~
  float* As = Ks + C * kLd + kLd;        // [C][kLd]: a_inc, after a row of
                                         // zeros (As[-1], the running sum
                                         // before the chunk)
  float* Ps = As + C * kLd;              // [C][LDP]: scores
  float* Vs = Ps + C * LDP;              // [C][kLdK]: v
  float* Ss = Vs + C * kLdK;             // [64][kLdK]: S_c
  float* Us = Ss + kD * kLdK;            // [64]
  float* Gs = Us + kD;                   // [6][64]: 2^(P_i - E_j)
  float* Hs = Gs + 6 * kD;               // [4][64]: 2^P_i

  const int tid = threadIdx.x, bh = blockIdx.x, c = blockIdx.y;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t row0 = (int64_t)bh * t_len + (int64_t)c * C;

  PHASE_CUT(1);
  // Everything but step 4's second term depends on the chunk's inputs
  // alone, so it overlaps the state and scan kernels (programmatic
  // dependent launch).  Every load in flight before the first store:
  float xr[IT][4], xk[IT][4], xv[IT][4], xw[IT][4];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + kThreads * it, s = e >> 4, dq = e & 15;
    const int64_t off = (row0 + s) * kD + 4 * dq;
    ld4(r + off, vec, xr[it]);
    ld4(k + off, vec, xk[it]);
    ld4(v + off, vec, xv[it]);
    ld4_w(w, off, w_bf16, vec, xw[it]);
  }
  if (tid < kD) {
    Us[tid] = ld_u(u, (int64_t)(bh % heads) * kD + tid, u_bf16);
    As[-kLd + tid] = 0.f;
  }
  for (int e = tid; e < C * LDP; e += kThreads) Ps[e] = 0.f;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int e = tid + kThreads * it, s = e >> 4, dq = e & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) xw[it][i] = log2_w(xw[it][i]);
    st4(Rs + s * kLd + 4 * dq, xr[it]);
    st4(Ks + s * kLd + 4 * dq, xk[it]);
    st4(Vs + s * kLdK + 4 * dq, xv[it]);
    st4(As + s * kLd + 4 * dq, xw[it]);
  }
  __syncthreads();
  PHASE_CUT(2);
  cumsum_rows<C>(As, kLd, Gs);           // Gs is free until step 3

  PHASE_CUT(3);
  // 1. the diagonal blocks.  A band's entries in one half of it (rows
  // and columns 8h..8h+7) pairwise: 2 x 2 tiles (rows t0, t0 + 1, columns
  // s0, s0 + 1) of each half's lower triangle, two threads a tile, 32 of
  // its d each (started at a lane-dependent d, against bank conflicts),
  // summed by one shuffle; a diagonal tile keeps its one entry below the
  // diagonal.  Its second half's rows against its first half's columns
  // factored again, at the first half's last step M:
  //   2^(a_exc[t] - a_inc[s]) = 2^(a_exc[t] - A_M) 2^(A_M - a_inc[s])
  // (both exponents <= 0), the factors into S_c's space (free until step
  // 4).  Then the bonus on the diagonal.
  {
    float* Rm = Ss;                      // [NS * 8][kLdK]: r 2^(a_exc - A_M)
    float* Km = Ss + NS * 8 * kLdK;      // [NS * 8][kLdK]: k 2^(A_M - a_inc)
#pragma unroll
    for (int it = 0; it < NS * 8 * kD / kThreads; ++it) {
      const int row = it * (kThreads / kD) + tid / kD, d = tid % kD;
      const int band = row / 8, h = row % 8;
      const int t = 16 * band + 8 + h, s = 16 * band + h;
      const float am = As[(16 * band + 7) * kLd + d];
      Rm[row * kLdK + d] = Rs[t * kLd + d] *
                           exp2_neg(As[(t - 1) * kLd + d] - am);
      Km[row * kLdK + d] = Ks[s * kLd + d] *
                           exp2_neg(am - As[s * kLd + d]);
    }
    constexpr int NT = 20 * NS;          // 2 * (4 * 5 / 2) tiles a band
    const int q = tid & 1, rot = (tid >> 1) & 15;
    for (int e0 = 0; e0 < 2 * NT; e0 += kThreads) {
      const int tile = (e0 + tid) >> 1;
      float acc[4] = {};
      int t0 = 0, s0 = 0;
      if (tile < NT) {
        int ti, si;
        tri_index(tile % 10, ti, si);
        const int base = 16 * (tile / 20) + 8 * ((tile / 10) & 1);
        t0 = base + 2 * ti;
        s0 = base + 2 * si;
        const float *r0 = Rs + t0 * kLd, *r1 = r0 + kLd;
        const float *e0p = As + (t0 - 1) * kLd, *e1p = e0p + kLd;
        const float *k0 = Ks + s0 * kLd, *k1 = k0 + kLd;
        const float *i0 = As + s0 * kLd, *i1 = i0 + kLd;
#pragma unroll 4
        for (int x = 0; x < 16; ++x) {
          const int d = 32 * q + 2 * ((x + rot) & 15);
          const float2 ra = ld2(r0 + d), rb = ld2(r1 + d);
          const float2 ea = ld2(e0p + d), eb = ld2(e1p + d);
          const float2 ka = ld2(k0 + d), kb = ld2(k1 + d);
          const float2 ia = ld2(i0 + d), ib = ld2(i1 + d);
          acc[0] = fmaf(ra.x * ka.x, exp2_neg(ea.x - ia.x), acc[0]);
          acc[1] = fmaf(ra.x * kb.x, exp2_neg(ea.x - ib.x), acc[1]);
          acc[2] = fmaf(rb.x * ka.x, exp2_neg(eb.x - ia.x), acc[2]);
          acc[3] = fmaf(rb.x * kb.x, exp2_neg(eb.x - ib.x), acc[3]);
          acc[0] = fmaf(ra.y * ka.y, exp2_neg(ea.y - ia.y), acc[0]);
          acc[1] = fmaf(ra.y * kb.y, exp2_neg(ea.y - ib.y), acc[1]);
          acc[2] = fmaf(rb.y * ka.y, exp2_neg(eb.y - ia.y), acc[2]);
          acc[3] = fmaf(rb.y * kb.y, exp2_neg(eb.y - ib.y), acc[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
      if (tile < NT && q == 0) {
        Ps[(t0 + 1) * LDP + s0] = acc[2];
        if (s0 < t0) {
          Ps[t0 * LDP + s0] = acc[0];
          Ps[t0 * LDP + s0 + 1] = acc[1];
          Ps[(t0 + 1) * LDP + s0 + 1] = acc[3];
        }
      }
    }
    // the bonus, four threads a row
    const int t = tid >> 2, q4 = tid & 3, rot4 = (tid >> 2) & 7;
    if (t < C) {
      float bonus = 0.f;
#pragma unroll 4
      for (int x = 0; x < 16; ++x) {
        const int d = 16 * q4 + ((x + rot4) & 15);
        bonus = fmaf(Rs[t * kLd + d] * Us[d], Ks[t * kLd + d], bonus);
      }
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
      if (q4 == 0) Ps[t * LDP + t] = bonus;
    }
  }
  __syncthreads();

  PHASE_CUT(4);
  // 2. the factored operands: R^ over r, K~ over k (the last band's k is
  // not needed), and the band factors G and H; and the halves' factored
  // entries of step 1, one a thread
  {
    const float* Rm = Ss;
    const float* Km = Ss + NS * 8 * kLdK;
    const int e = tid;
    if (e < NS * 64) {
      const int band = e / 64, tl = (e / 8) % 8, sl = e % 8;
      const float* rr = Rm + (8 * band + tl) * kLdK;
      const float* kk = Km + (8 * band + sl) * kLdK;
      float acc = 0.f;
#pragma unroll 4
      for (int x = 0; x < kD / 4; ++x) {
        const int d = 4 * ((x + sl) & 15);
        const float4 ra = *reinterpret_cast<const float4*>(rr + d);
        const float4 ka = *reinterpret_cast<const float4*>(kk + d);
        acc = fmaf(ra.x, ka.x, acc);
        acc = fmaf(ra.y, ka.y, acc);
        acc = fmaf(ra.z, ka.z, acc);
        acc = fmaf(ra.w, ka.w, acc);
      }
      Ps[(16 * band + 8 + tl) * LDP + 16 * band + sl] = acc;
    }
  }
#pragma unroll
  for (int it = 0; it < C * kD / kThreads; ++it) {
    const int t = it * (kThreads / kD) + tid / kD, d = tid % kD;
    const int band = t / 16;
    Rs[t * kLd + d] *= exp2_neg(As[(t - 1) * kLd + d] -
                                As[(16 * band - 1) * kLd + d]);
    if (band < NS - 1)
      Ks[t * kLd + d] *= exp2_neg(As[(16 * band + 15) * kLd + d] -
                                  As[t * kLd + d]);
  }
  for (int e = tid; e < (NP + NS) * kD; e += kThreads) {
    const int p = e / kD, d = e % kD;
    if (p < NP) {
      int i, j;
      band_pair(p, i, j);
      Gs[p * kD + d] = exp2_neg(As[(16 * i - 1) * kLd + d] -
                                As[(16 * j + 15) * kLd + d]);
    } else {
      const int i = p - NP;
      Hs[i * kD + d] = exp2_neg(As[(16 * i - 1) * kLd + d]);
    }
  }
  __syncthreads();

  PHASE_CUT(5);
  // 3. the off-diagonal blocks: (R^ G_ij) K~_j^T
  if (kTC) {
    for (int job = warp; job < 2 * NP; job += kThreads / 32) {
      const int p = job >> 1, nt = job & 1;
      int i, j;
      band_pair(p, i, j);
      float acc[4] = {};
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        float2 x[4], y[2];
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        a_vals(Rs, kLd, 16 * i, 16 * ks, Gs + p * kD, x);
        split_all<4>(x, ahi, alo);
        b_vals(Ks, kLd, 16 * j + 8 * nt, 16 * ks, y);
        split_all<2>(y, bhi, blo);
        mma(acc, ahi, bhi);
        mma(acc, alo, bhi);
        mma(acc, ahi, blo);
      }
      const int g = lane >> 2, col = 16 * j + 8 * nt + 2 * (lane & 3);
      Ps[(16 * i + g) * LDP + col] = acc[0];
      Ps[(16 * i + g) * LDP + col + 1] = acc[1];
      Ps[(16 * i + g + 8) * LDP + col] = acc[2];
      Ps[(16 * i + g + 8) * LDP + col + 1] = acc[3];
    }
  } else {
    for (int e = tid; e < NP * 256; e += kThreads) {
      const int p = e >> 8, tl = (e >> 4) & 15, sl = e & 15;
      int i, j;
      band_pair(p, i, j);
      const float* rr = Rs + (16 * i + tl) * kLd;
      const float* kk = Ks + (16 * j + sl) * kLd;
      const float* gg = Gs + p * kD;
      float acc = 0.f;
#pragma unroll 8
      for (int x = 0; x < kD; ++x) {
        const int d = (x + sl) & 63;
        acc = fmaf(rr[d] * gg[d], kk[d], acc);
      }
      Ps[(16 * i + tl) * LDP + 16 * j + sl] = acc;
    }
  }
  __syncthreads();

  PHASE_CUT(6);
  // 4. o = scores v + (R^ H_i) S_c: the first term, then S_c once the
  // scan has written it (copied while the first term is summed)
  const float* Sc = scratch + ((int64_t)bh * gridDim.y + c) * kStateFloats;
  auto copy_state = [&]() {
    pdl_wait();
#pragma unroll
    for (int i = 0; i < kStateFloats / 4 / kThreads; ++i) {
      const int e = 4 * (tid + kThreads * i);
      cp_async16(Ss + (e >> 6) * kLdK + (e & 63), Sc + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto wait_state = [&]() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  };
  if (kTC) {
    constexpr int WPB = 8 / NS;          // warps a band
    constexpr int NTW = NS;              // 8-column tiles a warp
    const int i = warp / WPB, n0 = (warp % WPB) * NTW * 8;
    float acc[NTW][4] = {};
    // the scores take three terms: two would flip the bf16 output's
    // rounding about twice as often as f32 products do
    for (int ks = 0; ks <= i; ++ks) {
      float2 x[4];
      uint32_t ahi[4], amid[4], alo[4];
      a_vals(Ps, LDP, 16 * i, 16 * ks, nullptr, x);
#pragma unroll
      for (int m = 0; m < 4; ++m) split3(x[m].x, x[m].y, ahi[m], amid[m],
                                         alo[m]);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        float2 y[2];
        b_vals_t(Vs, kLdK, n0 + 8 * n, 16 * ks, y);
        const uint32_t b[2] = {pack(y[0].x, y[0].y), pack(y[1].x, y[1].y)};
        mma(acc[n], ahi, b);
        mma(acc[n], amid, b);
        mma(acc[n], alo, b);
      }
      if (ks == 0) copy_state();
    }
    wait_state();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      float2 x[4];
      uint32_t ahi[4], alo[4];
      a_vals(Rs, kLd, 16 * i, 16 * ks, Hs + i * kD, x);
      split_all<4>(x, ahi, alo);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        float2 y[2];
        uint32_t bhi[2], blo[2];
        b_vals_t(Ss, kLdK, n0 + 8 * n, 16 * ks, y);
        split_all<2>(y, bhi, blo);
        mma(acc[n], ahi, bhi);
        mma(acc[n], alo, bhi);
        mma(acc[n], ahi, blo);
      }
    }
    const int g = lane >> 2;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int col = n0 + 8 * n + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(
          o + (row0 + 16 * i + g) * kD + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(
          o + (row0 + 16 * i + g + 8) * kD + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  } else {
    const int ty = tid >> 4, j0 = 4 * (tid & 15);
    float acc[NS][4] = {};
    copy_state();
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(Vs + s * kLdK + j0);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float x = Ps[(ty + 16 * m) * LDP + s];
        acc[m][0] = fmaf(x, vv.x, acc[m][0]);
        acc[m][1] = fmaf(x, vv.y, acc[m][1]);
        acc[m][2] = fmaf(x, vv.z, acc[m][2]);
        acc[m][3] = fmaf(x, vv.w, acc[m][3]);
      }
    }
    wait_state();
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      const float4 sv = *reinterpret_cast<const float4*>(Ss + d * kLdK + j0);
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const float x = Rs[(ty + 16 * m) * kLd + d] * Hs[m * kD + d];
        acc[m][0] = fmaf(x, sv.x, acc[m][0]);
        acc[m][1] = fmaf(x, sv.y, acc[m][1]);
        acc[m][2] = fmaf(x, sv.z, acc[m][2]);
        acc[m][3] = fmaf(x, sv.w, acc[m][3]);
      }
    }
    float* o = reinterpret_cast<float*>(out);
#pragma unroll
    for (int m = 0; m < NS; ++m)
      *reinterpret_cast<float4*>(o + (row0 + ty + 16 * m) * kD + j0) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

// ---- launches ---------------------------------------------------------------

template <typename T, int C>
int launch(const LinearAttnArgs& a) {
  const int bh = (int)a.bh, t_len = (int)a.t_len, n_chunks = t_len / C;
  const cudaStream_t st = (cudaStream_t)a.stream;
  float* scratch = (float*)a.scratch;
  const bool w_bf16 = a.w_dtype == 1, u_bf16 = a.u_dtype == 1;
  const size_t smem_state = state_smem_floats(C) * sizeof(float);
  const size_t smem_out = out_smem_floats(C) * sizeof(float);
  // the element loads' alignment: 16 bytes for f32 rows, 8 for bf16 ones
  constexpr uintptr_t al = std::is_same<T, float>::value ? 15 : 7;
  const uintptr_t wal = w_bf16 ? 7 : 15;
  const bool vec = ((((uintptr_t)a.r | (uintptr_t)a.k | (uintptr_t)a.v) & al)
                    | ((uintptr_t)a.w & wal)) == 0;
  // the shared-memory limits belong to a device: set by the first launch
  // on each (a bit a device ordinal; two threads may both set them, which
  // is harmless)
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(allowed.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(linear_attn_state_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_state);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(linear_attn_output_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_out);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(bh, n_chunks);
  if (n_chunks > 0) {
    linear_attn_state_kernel<T, C><<<grid, kThreads, smem_state, st>>>(
        (const T*)a.k, (const T*)a.v, a.w, scratch, t_len, w_bf16, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the scan and the output kernel may start while the kernel before them
  // runs (each waits, in pdl_wait, for what it reads)
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh, kScanBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, linear_attn_scan_kernel, scratch,
                           (float*)a.state, n_chunks);
  if (err != cudaSuccess || n_chunks == 0) return (int)err;
  cfg.gridDim = grid;
  cfg.dynamicSmemBytes = smem_out;
  err = cudaLaunchKernelEx(&cfg, linear_attn_output_kernel<T, C>,
                           (const T*)a.r, (const T*)a.k, (const T*)a.v, a.w,
                           a.u, (T*)a.out, (const float*)scratch, t_len,
                           (int)a.heads, w_bf16, u_bf16, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk(const LinearAttnArgs& a) {
  switch (a.chunk) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  The launches run on the
// stream in the block, do not synchronise, allocate nothing, and return
// cudaGetLastError() so a refused launch is reported by the caller.  r, k,
// w are (bh, t_len, 64), v and out (bh, t_len, 64), u (heads, 64), state
// (bh, 64, 64) f32, all contiguous; scratch holds bh * (t_len / chunk) *
// linear_attn_tc_scratch_floats_per_chunk() f32 values (each chunk's state
// increment, then its incoming state, and its decay); dtype codes are 0 for
// f32 and 1 for bf16, one for r, k, v and out, one for w and one for u.

extern "C" int linear_attn_tc_scratch_floats_per_chunk() {
  return kStateFloats + kD;
}

extern "C" int linear_attn_tc_launch(const LinearAttnArgs* a) {
  if (a->bh <= 0 || a->bh >= (1LL << 31) || a->t_len < 0 ||
      a->t_len >= (1LL << 31) || a->dk != kD || a->dv != kD ||
      a->heads <= 0 || a->bh % a->heads || a->chunk <= 0 ||
      a->t_len % a->chunk || a->t_len / a->chunk > 65535 ||
      a->w_dtype < 0 || a->w_dtype > 1 || a->u_dtype < 0 || a->u_dtype > 1 ||
      (a->t_len > 0 && a->scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a->dtype == 0) return launch_chunk<float>(*a);
  if (a->dtype == 1) return launch_chunk<__nv_bfloat16>(*a);
  return (int)cudaErrorInvalidValue;
}

extern "C" int linear_attn_tc_args_bytes() {
  return (int)sizeof(LinearAttnArgs);
}

extern "C" const char* linear_attn_tc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
