// Chunked decayed linear attention for Hopper (sm_90a), the serial design
// (chunks one after another in a block).  Replaces the Pallas TPU
// kernel
//   repro/kernels/linear_attn.py:84 linear_attention (_linear_attn_kernel :38)
// and computes, for every row bh of r, k, w (BH, T, dk) and v (BH, T, dv)
// with the bonus u[bh % H] (u is (H, dk)), from a zero state,
//
//   o_t = r_t S_{t-1} + ((r_t * u) . k_t) v_t
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// in the TPU kernel's chunked closed form over chunks of C steps (A is the
// running sum of log w inside a chunk, a_inc inclusive, a_exc exclusive,
// a_end its last row):
//
//   scores[t,s] = sum_d r[t,d] k[s,d] exp(min(a_exc[t,d] - a_inc[s,d], 0))
//                 for s < t, and sum_d r[t,d] u[d] k[t,d] on the diagonal
//   o           = (r * exp(a_exc)) S + scores v
//   S          <- exp(a_end)^T * S + (k * exp(a_end - a_inc))^T v
//
// Every exponent is <= 0, so any decay is overflow-safe; log w is taken of
// max(w, 1e-30) as the TPU kernel does (w = exp(-exp(x)) underflows to 0
// in f32).  r, k, v and the output share one type (f32 or bf16); w and u
// are read in their own types (the model's decays are f32 and are never
// rounded to bf16).  Everything is accumulated in f32, and the output is
// rounded once to r's type.  The kernel also writes the final state
// (BH, dk, dv) in f32, which RWKV6's decode continues from.
//
// Design.  One block of 256 threads owns one row bh and one 16-column
// slice of dv (grid: BH x ceil(dv / 16)); the TPU kernel's sequential chunk
// axis is a loop inside the block, and the block's (dk, 16) slice of the
// state stays in shared memory across chunks.  Columns of S and of o are
// independent, so slicing dv multiplies the blocks (32 heads of 64 give
// 128 blocks for 132 SMs) at the price of each slice recomputing the
// chunk's scores.  Per chunk:
//   1. r, k and log2 w are staged in shared memory as f32, transposed
//      (d-major), and the block's slice of v;
//   2. one thread per d takes the running sums a_inc and a_exc (log2 units,
//      so each decay is one exp2);
//   3. the C x C scores are computed on the fly, never materialising the
//      TPU kernel's (C, C, dk) pairwise decay tensor (1 MB at C = dk = 64):
//      each thread owns 2 x 2 score tiles of the lower triangle and walks
//      d, one exp2 per (t, s, d); the bonus fills the diagonal;
//   4. r and k are scaled in place by exp(a_exc) and exp(a_end - a_inc);
//   5. o = (r exp(a_exc)) S + scores v for the slice, written out;
//   6. S <- exp(a_end) S + (k exp(a_end - a_inc))^T v.
// Chunks up to 64 steps and dk up to 128 run (any dv); T must be a multiple
// of the chunk.  Shared memory is 4 dk (C + 2) + C (C + 1) + 16 C + 17 dk
// floats: 92.7 KB at C = dk = 64.
//
// Bound at the serve path's shape (BH 32, T 512, dk = dv = 64, C 64; bf16
// r, k, v, u and out, f32 w and state): the bytes are r, k, v and out at
// 2 MiB each, w at 4 MiB and the state at 0.5 MiB, 13.1 MB in all, 3.9 us
// at 3.35 TB/s; the work the function needs is the recurrence's, about
// 0.34 G operations (per step and row 5 dk dv for the state's decay,
// its k^T v update and r S, plus the bonus), 0.34 us at bf16's 989
// TFLOP/s: bytes (the f32 FMAs this kernel runs instead would take 5.1 us
// at 67 TFLOP/s).  The kernel is far from it (227 us a launch on
// an H100 80GB HBM3 at 700 W, timed by chip_smoke.py): step 3 takes 129k exp2s
// per chunk and block, each thread's four score chains wait on exp2 and
// FMA latency with one block of 8 warps an SM, the dv slices repeat the
// scores four times over, and the chunks run one after another.
// linear_attn_tc.cu takes the three steps that header names (chunks in
// parallel, the decay factored at sub-chunks of 16, tensor cores for bf16
// products) for dk = dv = 64 at chunk 16, 32 or 64, RWKV6's prefill
// among them; this kernel keeps every other call (linear_attn.kernel_for
// names it "serial").
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// One launch's arguments, packed by the wrapper into a single ctypes
// argument (struct.Struct("@9P9q") in linear_attn.py), the layout of
// linear_attn_tc.cu's.
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
constexpr int kSlice = 16;               // dv columns per block
constexpr int kMaxChunk = 64;
constexpr int kMaxDk = 128;
// The most dynamic shared memory one block may ask for on sm_90.
constexpr size_t kMaxSmem = 232448;

// cp is the chunk rounded up to even (the score tiles are 2 x 2).
__host__ __device__ constexpr int transposed_ld(int cp) { return cp + 2; }
__host__ __device__ constexpr size_t smem_floats(int cp, int dk) {
  return 4 * (size_t)dk * transposed_ld(cp) + (size_t)cp * (cp + 1) +
         (size_t)cp * kSlice + (size_t)dk * kSlice + (size_t)dk;
}
static_assert(smem_floats(kMaxChunk, kMaxDk) * sizeof(float) <= kMaxSmem,
              "the largest chunk and dk must fit in one block's shared "
              "memory");

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

template <typename T, typename TW, typename TU>
__global__ void __launch_bounds__(kThreads)
linear_attn_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const TW* __restrict__ w,
                   const TU* __restrict__ u, T* __restrict__ out,
                   float* __restrict__ state_out, int t_len, int dk, int dv,
                   int heads, int chunk) {
  const int cp = (chunk + 1) & ~1;
  const int ld = transposed_ld(cp);
  extern __shared__ float smem[];
  float* RT = smem;                      // [dk][ld]: r, then r exp(a_exc)
  float* KT = RT + dk * ld;              // [dk][ld]: k, then k exp(a_end-a_inc)
  float* AE = KT + dk * ld;              // [dk][ld]: a_exc (log2 units)
  float* AI = AE + dk * ld;              // [dk][ld]: log2 w, then a_inc
  float* P = AI + dk * ld;               // [cp][cp + 1]: scores
  float* V = P + cp * (cp + 1);          // [cp][kSlice]
  float* S = V + cp * kSlice;            // [dk][kSlice]: the state slice
  float* U = S + dk * kSlice;            // [dk]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kSlice;
  const int col = tid % kSlice;
  const int lane_row = tid / kSlice;     // 0..15
  const int64_t row0 = (int64_t)bh * t_len;

  for (int e = tid; e < cp * (cp + 1); e += kThreads) P[e] = 0.f;
  for (int e = tid; e < dk * kSlice; e += kThreads) S[e] = 0.f;
  for (int d = tid; d < dk; d += kThreads)
    U[d] = to_f32(u[(int64_t)(bh % heads) * dk + d]);

  const int n_tiles = cp / 2;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  for (int c0 = 0; c0 < t_len; c0 += chunk) {
    __syncthreads();                     // the last chunk's reads are done
    // 1. stage r, k, log2 w (transposed) and the slice of v
    for (int e = tid; e < cp * dk; e += kThreads) {
      const int t = e / dk, d = e % dk;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (t < chunk) {
        const int64_t off = (row0 + c0 + t) * dk + d;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        lw = log2f(fmaxf(to_f32(w[off]), 1e-30f));
      }
      RT[d * ld + t] = rv;
      KT[d * ld + t] = kv;
      AI[d * ld + t] = lw;
    }
    for (int e = tid; e < cp * kSlice; e += kThreads) {
      const int s = e / kSlice, cc = e % kSlice;
      V[e] = (s < chunk && j0 + cc < dv)
                 ? to_f32(v[(row0 + c0 + s) * dv + j0 + cc])
                 : 0.f;
    }
    __syncthreads();

    // 2. running sums of log2 w along the chunk
    for (int d = tid; d < dk; d += kThreads) {
      float run = 0.f;
      for (int t = 0; t < cp; ++t) {
        const float lw = AI[d * ld + t];
        run += lw;
        AI[d * ld + t] = run;
        AE[d * ld + t] = run - lw;
      }
    }
    __syncthreads();

    // 3. scores: 2 x 2 tiles of the lower triangle, then the diagonal
    const float2* RT2 = reinterpret_cast<const float2*>(RT);
    const float2* KT2 = reinterpret_cast<const float2*>(KT);
    const float2* AE2 = reinterpret_cast<const float2*>(AE);
    const float2* AI2 = reinterpret_cast<const float2*>(AI);
    const int ld2 = ld / 2;
    for (int q = tid; q < n_pairs; q += kThreads) {
      int ti = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
      while ((ti + 1) * (ti + 2) / 2 <= q) ++ti;
      while (ti * (ti + 1) / 2 > q) --ti;
      const int si = q - ti * (ti + 1) / 2;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      for (int d = 0; d < dk; ++d) {
        const float2 rr = RT2[d * ld2 + ti], ae = AE2[d * ld2 + ti];
        const float2 kk = KT2[d * ld2 + si], ai = AI2[d * ld2 + si];
        a00 = fmaf(rr.x * kk.x, exp2f(fminf(ae.x - ai.x, 0.f)), a00);
        a01 = fmaf(rr.x * kk.y, exp2f(fminf(ae.x - ai.y, 0.f)), a01);
        a10 = fmaf(rr.y * kk.x, exp2f(fminf(ae.y - ai.x, 0.f)), a10);
        a11 = fmaf(rr.y * kk.y, exp2f(fminf(ae.y - ai.y, 0.f)), a11);
      }
      const int t0 = 2 * ti, s0 = 2 * si;
      if (si < ti) {                     // every pair strictly below
        P[t0 * (cp + 1) + s0] = a00;
        P[t0 * (cp + 1) + s0 + 1] = a01;
        P[(t0 + 1) * (cp + 1) + s0] = a10;
        P[(t0 + 1) * (cp + 1) + s0 + 1] = a11;
      } else {                           // a diagonal tile: (t0 + 1, s0)
        P[(t0 + 1) * (cp + 1) + s0] = a10;
      }
    }
    for (int t = tid; t < cp; t += kThreads) {
      float b = 0.f;
      for (int d = 0; d < dk; ++d)
        b = fmaf(RT[d * ld + t] * U[d], KT[d * ld + t], b);
      P[t * (cp + 1) + t] = b;
    }
    __syncthreads();

    // 4. r * exp(a_exc) and k * exp(a_end - a_inc), in place
    for (int e = tid; e < dk * cp; e += kThreads) {
      const int d = e / cp, t = e % cp;
      const float a_end = AI[d * ld + chunk - 1];
      RT[d * ld + t] *= exp2f(AE[d * ld + t]);
      KT[d * ld + t] *= exp2f(fminf(a_end - AI[d * ld + t], 0.f));
    }
    __syncthreads();

    // 5. o = (r exp(a_exc)) S + scores v, the block's columns
    const int gc = j0 + col;
    for (int t = lane_row; t < chunk; t += kThreads / kSlice) {
      float acc = 0.f;
      for (int d = 0; d < dk; ++d)
        acc = fmaf(RT[d * ld + t], S[d * kSlice + col], acc);
      for (int s = 0; s <= t; ++s)
        acc = fmaf(P[t * (cp + 1) + s], V[s * kSlice + col], acc);
      if (gc < dv) out[(row0 + c0 + t) * dv + gc] = from_f32<T>(acc);
    }
    __syncthreads();

    // 6. S <- exp(a_end) S + (k exp(a_end - a_inc))^T v
    for (int d = lane_row; d < dk; d += kThreads / kSlice) {
      float acc = exp2f(AI[d * ld + chunk - 1]) * S[d * kSlice + col];
      for (int s = 0; s < chunk; ++s)
        acc = fmaf(KT[d * ld + s], V[s * kSlice + col], acc);
      S[d * kSlice + col] = acc;
    }
  }
  __syncthreads();
  const int gc = j0 + col;
  if (gc < dv)
    for (int d = lane_row; d < dk; d += kThreads / kSlice)
      state_out[((int64_t)bh * dk + d) * dv + gc] = S[d * kSlice + col];
}

template <typename T, typename TW, typename TU>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, void* state, int bh, int t_len, int dk,
           int dv, int heads, int chunk, cudaStream_t stream) {
  const int cp = (chunk + 1) & ~1;
  const size_t smem = smem_floats(cp, dk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_attn_kernel<T, TW, TU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, (dv + kSlice - 1) / kSlice);
  linear_attn_kernel<T, TW, TU><<<grid, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const TW*)w, (const TU*)u,
      (T*)out, (float*)state, t_len, dk, dv, heads, chunk);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int launch_u(int u_dtype, const void* r, const void* k, const void* v,
             const void* w, const void* u, void* out, void* state, int bh,
             int t_len, int dk, int dv, int heads, int chunk,
             cudaStream_t stream) {
  if (u_dtype == 0)
    return launch<T, TW, float>(r, k, v, w, u, out, state, bh, t_len, dk, dv,
                                heads, chunk, stream);
  if (u_dtype == 1)
    return launch<T, TW, __nv_bfloat16>(r, k, v, w, u, out, state, bh, t_len,
                                        dk, dv, heads, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_w(int w_dtype, int u_dtype, const void* r, const void* k,
             const void* v, const void* w, const void* u, void* out,
             void* state, int bh, int t_len, int dk, int dv, int heads,
             int chunk, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch_u<T, float>(u_dtype, r, k, v, w, u, out, state, bh, t_len,
                              dk, dv, heads, chunk, stream);
  if (w_dtype == 1)
    return launch_u<T, __nv_bfloat16>(u_dtype, r, k, v, w, u, out, state, bh,
                                      t_len, dk, dv, heads, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).  The launch runs on the
// stream in the block, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported by the
// caller.  r, k, w are (bh, t_len, dk), v and out (bh, t_len, dv), u
// (heads, dk), state (bh, dk, dv) f32, all contiguous; dtype codes are 0
// for f32 and 1 for bf16, one for r, k, v and out, one for w and one for
// u; the scratch pointer is not used.

extern "C" int linear_attn_launch(const LinearAttnArgs* a) {
  if (a->bh <= 0 || a->bh >= (1LL << 31) || a->t_len < 0 ||
      a->t_len >= (1LL << 31) || a->dk <= 0 || a->dk > kMaxDk ||
      a->dv <= 0 || a->dv >= (1LL << 31) || a->heads <= 0 ||
      a->bh % a->heads || a->chunk <= 0 || a->chunk > kMaxChunk ||
      a->t_len % a->chunk || (a->dv + kSlice - 1) / kSlice > 65535)
    return (int)cudaErrorInvalidValue;
  const int bh = (int)a->bh, t_len = (int)a->t_len, dk = (int)a->dk,
            dv = (int)a->dv, heads = (int)a->heads, chunk = (int)a->chunk;
  const int w_dtype = (int)a->w_dtype, u_dtype = (int)a->u_dtype;
  const cudaStream_t st = (cudaStream_t)a->stream;
  if (a->dtype == 0)
    return launch_w<float>(w_dtype, u_dtype, a->r, a->k, a->v, a->w, a->u,
                           a->out, a->state, bh, t_len, dk, dv, heads, chunk,
                           st);
  if (a->dtype == 1)
    return launch_w<__nv_bfloat16>(w_dtype, u_dtype, a->r, a->k, a->v, a->w,
                                   a->u, a->out, a->state, bh, t_len, dk, dv,
                                   heads, chunk, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int linear_attn_args_bytes() {
  return (int)sizeof(LinearAttnArgs);
}

extern "C" const char* linear_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
