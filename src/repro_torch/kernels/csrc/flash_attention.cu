// Flash attention for Hopper (sm_90a): the prefill hot spot of the LM
// serve path.  Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention.py:77 flash_attention (_flash_kernel :27)
// and computes, for every query head h of q (BH, T, D) against the KV head
// h / group of k and v (BKV, S, D), BH = BKV * group,
//
//   out[h] = softmax(mask(softcap(q[h] k[h/group]^T * scale))) v[h/group]
//
// with the causal mask (k_pos <= q_pos) and the sliding window
// (k_pos > q_pos - window), each optional.  Inputs and output are f32 or
// bf16; every product and the softmax statistics are f32, as the TPU
// kernel upcasts q, k and v; the output is rounded once to q's type.
//
// Design.  One block of 256 threads owns a 64-row query tile of one head
// (grid: heads x query tiles, the heaviest causal tiles first).  The TPU
// kernel's sequential key axis is a loop inside the block over 64-key
// tiles: each step stages the K and V tile in shared memory as f32 (zero
// past the ragged edges, so any T, S and D <= 256 run), computes the
// 64 x 64 score tile with FMAs (thread (ty, tx) owns rows ty + 16 i and key
// columns tx + 16 j, i, j < 4), folds it into the online softmax, writes
// the probabilities to shared memory and accumulates P V into the rows'
// output columns tx + 16 jj, held in registers.  The running max, the
// denominator and the accumulator never leave registers; a row's max and
// sum are reduced across its 16 threads, which sit in one half-warp, by
// shuffles.  The head dimension is padded to a compile-time width DP in
// {16, 32, 64, 128, 256} so the accumulator is a register array.
//
// Masked logits are the finite NEG_INF = -1e30 of the TPU kernel, not
// -inf: before a row meets its first valid key, exp(s - m) = exp(0) = 1
// gives garbage that the first valid key wipes out (its correction is
// exp(-1e30 - m) = 0), and a row with no valid key at all averages V, as
// the plain version's softmax does.  Key tiles that every row of the
// query tile masks are skipped: above the causal diagonal always, below
// the window only when every row of the tile has its own (valid) diagonal
// key, so that no row is left with no valid key.  Both skips drop only
// terms that the TPU kernel multiplies by exactly 0.
//
// Bound at the serve path's shape (BH 16, T = S = 512, D 128, bf16,
// causal): the causal half of the products is 2 * 2 * 16 * 512 * 512 * 128
// / 2 = 1.07 GFLOP, 1.09 us at the 989 TFLOP/s bf16 rate, and the bytes
// (q, k, v read once, out written once: 16 * 512 * 128 * 2 * (1 + 1/2 +
// 1/2 + 1)) 6.3 MB, 1.88 us at 3.35 TB/s: bytes, about 1.9 us.  This kernel
// is far from it: its products run on the f32 FMA units (67 TFLOP/s at
// best), fed from shared memory with about one load per two FMAs, and the
// 128 blocks of the path shape fill the card once with 8 warps per SM.
// wgmma on bf16 tiles with f32 accumulation, TMA loads and a deeper
// pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;            // 16 x 16
constexpr int kRows = kBlockQ / 16;      // query rows per thread
constexpr int kCols = kBlockK / 16;      // score columns per thread
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;        // the TPU kernel's NEG_INF
// The most dynamic shared memory one block may ask for on sm_90.
constexpr size_t kMaxSmem = 232448;

// Q and K rows are padded by one word so that the 16 rows a half-warp
// reads at one d fall in 16 different banks; P likewise.
constexpr size_t smem_bytes(int dp) {
  return sizeof(float) *
         ((size_t)kBlockQ * (dp + 1) + (size_t)kBlockK * (dp + 1) +
          (size_t)kBlockK * dp + (size_t)kBlockQ * (kBlockK + 1));
}
static_assert(smem_bytes(kMaxHeadDim) <= kMaxSmem,
              "the widest head must fit in one block's shared memory");

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

// Max and sum over the 16 threads of one row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int t_len,
                       int s_len, int d, int group, int causal, int window,
                       float softcap, float scale) {
  constexpr int kLdq = DP + 1, kLdk = DP + 1, kLdv = DP, kLdp = kBlockK + 1;
  constexpr int kOut = DP / 16;          // output columns per thread and row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * kLdq;
  float* Vs = Ks + kBlockK * kLdk;
  float* Ps = Vs + kBlockK * kLdv;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const T* qb = q + (int64_t)bh * t_len * d;
  const T* kb = k + (int64_t)(bh / group) * s_len * d;
  const T* vb = v + (int64_t)(bh / group) * s_len * d;

  for (int e = tid; e < kBlockQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP, gq = q0 + r;
    Qs[r * kLdq + c] =
        (gq < t_len && c < d) ? to_f32(qb[(int64_t)gq * d + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) acc[i][jj] = 0.f;
  }

  // The keys this tile must visit: [k_begin, k_end).
  const int q_last = min(q0 + kBlockQ, t_len) - 1;
  const int k_end = causal ? min(s_len, q_last + 1) : s_len;
  const int k_begin =
      (window > 0 && q_last < s_len) ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                     // the last tile's reads are done
    for (int e = tid; e < kBlockK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP, gk = k0 + r;
      const bool in = gk < k_end && c < d;
      const int64_t off = (int64_t)gk * d + c;
      Ks[r * kLdk + c] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * kLdv + c] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qf[kRows], kf[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qf[i] = Qs[(ty + 16 * i) * kLdq + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kf[j] = Ks[(tx + 16 * j) * kLdk + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qf[i], kf[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = -INFINITY;             // past k_end: no term at all
        if (kp < k_end) {
          x = s[i][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool valid = true;
          if (causal) valid = kp <= qp;
          if (window > 0) valid = valid && kp > qp - window;
          if (!valid) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = __expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p =
            (k0 + tx + 16 * j < k_end) ? __expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pf[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pf[i] = Ps[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int jj = 0; jj < kOut; ++jj) {
        const float vf = Vs[c * kLdv + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][jj] = fmaf(pf[i], vf, acc[i][jj]);
      }
    }
  }

  T* ob = out + (int64_t)bh * t_len * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= t_len) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];   // fully masked row guard
#pragma unroll
    for (int jj = 0; jj < kOut; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) ob[(int64_t)qp * d + c] = from_f32<T>(acc[i][jj] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int group, int t_len, int s_len, int d, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(bh, (t_len + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, t_len, s_len, d, group,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 int bh, int group, int t_len, int s_len, int d, int causal,
                 int window, float softcap, float scale, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 16>(q, k, v, out, bh, group, t_len, s_len, d, causal,
                         window, softcap, scale, stream);
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, bh, group, t_len, s_len, d, causal,
                         window, softcap, scale, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, bh, group, t_len, s_len, d, causal,
                         window, softcap, scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, bh, group, t_len, s_len, d, causal,
                          window, softcap, scale, stream);
  return launch<T, 256>(q, k, v, out, bh, group, t_len, s_len, d, causal,
                        window, softcap, scale, stream);
}

}  // namespace

// Plain C entry points (bound with ctypes).  The launch runs on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so a refused launch is reported by the caller.  q is (bh, t_len, d), k
// and v (bkv, s_len, d), out like q, all contiguous; dtype code 0 is f32,
// 1 bf16.

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int bkv, int t_len, int s_len, int d,
                                      int dtype, int causal, int window,
                                      float softcap, float scale,
                                      void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || d <= 0 || d > kMaxHeadDim ||
      t_len < 0 || s_len < 0 || (t_len + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (t_len == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int group = bh / bkv;
  if (dtype == 0)
    return launch_dtype<float>(q, k, v, out, bh, group, t_len, s_len, d,
                               causal, window, softcap, scale, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, bh, group, t_len,
                                       s_len, d, causal, window, softcap,
                                       scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
