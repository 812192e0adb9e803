// Flash attention for Hopper on the tensor cores (sm_90a): the bf16
// prefill hot spot of the LM serve path.  Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention.py:77 flash_attention (_flash_kernel :27)
// for bf16 q/k/v/out at head widths D in {64, 128, 256}, and computes, for
// every query head h of q (BH, T, D) against the KV head h / group of k
// and v (BKV, S, D), BH = BKV * group,
//
//   out[h] = softmax(mask(softcap(q[h] k[h/group]^T * scale))) v[h/group]
//
// with the causal mask (k_pos <= q_pos) and the sliding window
// (k_pos > q_pos - window), each optional.  Every other call (f32, or
// another head width) goes to flash_attention.cu's FMA kernel: the wrapper
// routes by dtype and width (kernels/flash_attention.py::kernel_for).
//
// Precision contract.  S = Q K^T runs on bf16 operands with f32
// accumulation: a bf16 x bf16 product is exact in f32, so only the
// summation order differs from the TPU kernel, which upcasts q and k to
// f32.  The online softmax (running max, correction, exponentials) is f32.
// For O += P V, P is rounded to bf16 (the TPU kernel keeps it in f32): P
// lies in [0, 1], so each term moves by at most 2^-9 of |v|.  The row sum
// l is taken from the f32 P, before rounding.  The output is divided by l
// and rounded once to bf16.
//
// Design, against the three faults of the FMA design:
// * Products on the tensor cores: both products are wgmma m64n64k16 (bf16
//   in, f32 out), written as inline PTX.  S takes Q and K from shared
//   memory; O takes P from registers, the f32 score fragment rounded to
//   bf16 in place (its accumulator layout is the A-operand layout of the
//   next product), and V from shared memory, transposed by the
//   instruction (V is stored key-major, d contiguous).
// * Loads by TMA into a ring: one producer warp issues TMA tile loads of K
//   and V (64 keys x D) into a ring of two stages, K and V each with
//   their own mbarriers ("full" counts the bytes, "empty" the consumers'
//   release), so the next tiles arrive while this one is computed: K's
//   stage is free once S is done, V's once P V is.  Q is loaded once per
//   block.  The tensor maps are 3-D, (D, S, BKV) for K and V and
//   (D, T, BH) for Q, so a ragged last tile reads zeros, never the next
//   head's rows.  Tiles are stored in the 128-byte swizzle that wgmma
//   reads without bank conflicts: a tile of width D is D / 64 column
//   chunks of 64 rows x 128 bytes.  cuTensorMapEncodeTiled comes from
//   the runtime's driver entry point (cudaGetDriverEntryPointByVersion
//   from CUDA 12.5, cudaGetDriverEntryPoint before), so the library is
//   not linked with -lcuda.
// * The consumer runs one tile ahead: tile j's S and tile j-1's P V are
//   issued together, and tile j's softmax runs on the CUDA cores while
//   P V runs on the tensor cores.  Tiles that every row sees in full (all
//   but the diagonal and window-edge tiles) skip the mask tests, and 2^x
//   is one ex2.approx.ftz.  Issuing tile j+1's S before tile j's softmax
//   too would need a second score fragment: at D = 128 that spilled
//   registers and ran slower, so it is not done.  Every barrier wait
//   comes before the products it guards are issued: a wait between two
//   issues made ptxas serialize the products (warning C7520).
// * Shared memory is bf16: Q 16 KB and two 32 KB K/V stages at D = 128
//   (80 KB), so two blocks fit on an SM.  One consumer warpgroup of 128
//   threads owns 64 query rows.  A variant with two warpgroups on a
//   128-row tile sharing each K/V stage was measured slower at the serve
//   path's shape and dropped (PERF.md §6).
//
// Semantics kept from the FMA design: the grid walks the heaviest causal
// tiles first; masked logits are the TPU kernel's finite NEG_INF = -1e30,
// so a row with no valid key averages V as the plain version does, and a
// fully masked row's l == 0 divides by 1; key tiles outside the block's
// [k_begin, k_end) are skipped (causal above the diagonal, window below
// it only when every row keeps its diagonal key), which drops only terms
// the TPU kernel multiplies by exactly 0.  The softcap is
// softcap * tanhf(s / softcap) with the accurate tanhf, not tanh.approx
// (whose 2^-11 relative error at softcap 50 moves a logit by up to 0.024).
//
// Bound at the serve path's shape (BH 16, T = S = 512, D 128, bf16,
// causal): q, k, v read once and out written once are 6,291,456 bytes,
// 1.878 us at 3.35 TB/s; the causal products are 1.076 GFLOP, 1.09 us at
// 989 TFLOP/s: bytes, 1.878 us.  The heaviest 64-row tile walks 8 key
// tiles in series, so one block's chain of 8 (S, softmax, PV) steps sets
// the kernel's time at that shape.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                       // query rows of a block
constexpr int kBlockK = 64;
constexpr int kStages = 2;
constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int kChunkBytes = 64 * 128;             // 64 rows x 128 bytes
constexpr float kNegInf = -1e30f;                 // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kChunks = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kChunks * kChunkBytes;
  static constexpr int kV = kK + kStages * kChunks * kChunkBytes;
  static constexpr int kBar = kV + kStages * kChunks * kChunkBytes;
  // q_full, full_k, full_v, empty_k, empty_v (kStages each); 1 KB of
  // slack to align the base
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity.  A
// wait past 2^34 cycles (about 10 s) traps, so that a broken pipeline
// fails its launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WGMMA_OUT32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) = [d +] A B^T: A 64 x 16 and B 64 x 16, both K-major in
// shared memory.  scale_d == 0 starts d from zero.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A B: A 64 x 16 bf16 from registers (a0..a3), B
// 16 x 64 in shared memory stored N-major (transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WGMMA_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x on the SFU (ex2.approx.ftz: flushes subnormal results, far below
// what a bf16 P keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_u32(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Scores -> log2-domain logits in place, and each of the thread's two
// rows' maximum.  Element i of the fragment sits at row r0 + 8 * ((i / 2)
// % 2) and key column k0 + 8 * (i / 4) + cq + i % 2.  kMask: keys outside
// [kb, ke) are no term (-inf), masked keys the finite kNegInf; a tile
// whose every key is visited and valid for every row skips the tests.
template <bool kMask>
__device__ __forceinline__ void logits(float (&s)[32], int k0, int cq,
                                       int qp0, int kb, int ke, int causal,
                                       int window, float s_scale,
                                       float softcap, float& mx0,
                                       float& mx1) {
  mx0 = -INFINITY;
  mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * s_scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap) * kLog2e;
    if (kMask) {
      const int kp = k0 + 8 * (i / 4) + cq + (i % 2);
      const int qp = qp0 + 8 * ((i / 2) % 2);
      bool valid = true;
      if (causal) valid = kp <= qp;
      if (window > 0) valid = valid && kp > qp - window;
      if (!valid) x = kNegInf;
      if (kp < kb || kp >= ke) x = -INFINITY;    // not visited: no term
    }
    s[i] = x;
    if ((i / 2) % 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out, int t_len,
                             int s_len, int group, int causal, int window,
                             float softcap, float scale) {
  using L = Smem<D>;
  constexpr int kChunks = L::kChunks;
  constexpr int kTileBytes = kChunks * kChunkBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  // K and V have barriers of their own: K's stage is released as soon as
  // S is computed, V's only after the next tile's softmax
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, bkv = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;

  // the keys the rows [q0, q0 + 64) must visit: [kb, ke)
  const int q_last = min(q0 + kBlockQ, t_len) - 1;
  const int ke = causal ? min(s_len, q_last + 1) : s_len;
  const int kb = (window > 0 && q_last < s_len) ? max(0, q0 - window + 1) : 0;
  const int n_tiles = ke > kb ? (ke - kb + kBlockK - 1) / kBlockK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 128);
      mbar_init(&empty_v[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q once, then each tile's K and V into the ring
    if (lane == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(smem + L::kQ + c * kChunkBytes, &q_map, q_full, 64 * c, q0,
                 bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, use = it / kStages;
        const int k0 = kb + it * kBlockK;
        if (use > 0) mbar_wait(&empty_k[st], (use - 1) & 1);
        mbar_expect_tx(&full_k[st], kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(smem + L::kK + st * kTileBytes + c * kChunkBytes, &k_map,
                   &full_k[st], 64 * c, k0, bkv);
        if (use > 0) mbar_wait(&empty_v[st], (use - 1) & 1);
        mbar_expect_tx(&full_v[st], kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(smem + L::kV + st * kTileBytes + c * kChunkBytes, &v_map,
                   &full_v[st], 64 * c, k0, bkv);
      }
    }
    return;
  }

  // the consumer warpgroup: rows [q0, q0 + 64)
  const int r0 = warp * 16 + lane / 4;           // this thread's rows r0, r0+8
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  const int cq = 2 * (lane % 4);                 // its first column in a group
  const float s_scale = softcap > 0.f ? scale : scale * kLog2e;

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // log2 domain max
  uint32_t pa[16];               // P of the pending tile, bf16 pairs

  const uint32_t q_base = smem_u32(smem + L::kQ);
  const uint32_t k_base = smem_u32(smem + L::kK);
  const uint32_t v_base = smem_u32(smem + L::kV);

  // S = Q K^T for the tile in stage st, over D in steps of 16 (32 bytes
  // inside a swizzle row); issued, not committed.
  auto issue_s = [&](float (&s)[32], int st) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * kChunkBytes + kk * 32;
        wgmma_ss(s, sw128_desc(q_base + off, 16, 1024),
                 sw128_desc(k_base + st * kTileBytes + off, 16, 1024),
                 (c | kk) != 0);
      }
  };
  // O += P V for the tile in stage pst: P in registers is the A operand,
  // 16 keys a step; V's 16-key slice is 16 rows of 128 bytes further on.
  auto issue_pv = [&](int pst) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[c], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3],
                 sw128_desc(v_base + pst * kTileBytes + c * kChunkBytes +
                                kk * 16 * 128,
                            kChunkBytes, 1024));
  };
  auto fence_o_pa = [&]() {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
    fence_u32(pa);
  };
  // Tile it's scores in s -> probabilities in s; m and l updated, the
  // rows' corrections of O returned.
  auto softmax = [&](float (&s)[32], int it, float& corr0, float& corr1) {
    const int k0 = kb + it * kBlockK;
    const bool plain = k0 + kBlockK <= ke &&
                       (!causal || k0 + kBlockK - 1 <= q0) &&
                       (window <= 0 || k0 > q0 + kBlockQ - 1 - window);
    float mx0, mx1;
    if (plain)
      logits<false>(s, k0, cq, qp0, kb, ke, causal, window, s_scale, softcap,
                    mx0, mx1);
    else
      logits<true>(s, k0, cq, qp0, kb, ke, causal, window, s_scale, softcap,
                   mx0, mx1);
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    corr0 = ex2(m0 - mn0);
    corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(s[i] - (((i / 2) % 2) ? mn1 : mn0));
      s[i] = p;
      if ((i / 2) % 2)
        rs1 += p;
      else
        rs0 += p;
    }
    l0 = l0 * corr0 + rs0;                       // this thread's share of l
    l1 = l1 * corr1 + rs1;
  };
  auto pack_p = [&](const float (&s)[32]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
  };
  // The loop runs one tile ahead: tile it's S and tile it-1's P V are
  // issued together, and tile it's softmax runs while P V does.  Every
  // barrier wait comes before the products are issued.
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    float s[32], corr0, corr1;
    {
      mbar_wait(&full_k[0], 0);
      fence_regs(s);
      wgmma_fence();
      issue_s(s, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&empty_k[0]);                  // K's stage may be refilled
      softmax(s, 0, corr0, corr1);               // O is still 0
      pack_p(s);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages, pst = (it - 1) % kStages;
      mbar_wait(&full_k[st], (it / kStages) & 1);
      mbar_wait(&full_v[pst], ((it - 1) / kStages) & 1);
      fence_regs(s);
      fence_o_pa();
      wgmma_fence();
      issue_s(s, st);
      wgmma_commit();
      issue_pv(pst);
      wgmma_commit();
      wgmma_wait<1>();                           // S done, P V in flight
      fence_regs(s);
      mbar_arrive(&empty_k[st]);
      softmax(s, it, corr0, corr1);
      wgmma_wait<0>();
      fence_o_pa();
      mbar_arrive(&empty_v[pst]);                // V's stage may be refilled
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          o[c][i] *= ((i / 2) % 2) ? corr1 : corr0;
      pack_p(s);
    }
    const int pst = (n_tiles - 1) % kStages;
    mbar_wait(&full_v[pst], ((n_tiles - 1) / kStages) & 1);
    fence_o_pa();
    wgmma_fence();
    issue_pv(pst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_o_pa();
    mbar_arrive(&empty_v[pst]);
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);  // fully masked row guard
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* ob = out + (int64_t)bh * t_len * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int col = 64 * c + 8 * g + cq;
      if (qp0 < t_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qp0 * D + col) =
            __floats2bfloat162_rn(o[c][4 * g] * inv0, o[c][4 * g + 1] * inv0);
      if (qp1 < t_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qp1 * D + col) =
            __floats2bfloat162_rn(o[c][4 * g + 2] * inv1,
                                  o[c][4 * g + 3] * inv1);
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// A (D, rows, heads) bf16 tensor map read in 64 x 64 boxes, 128-byte
// swizzled; rows past `rows` read as zeros.
bool make_map(CUtensorMap* map, const void* base, int d, int rows,
              int heads) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int group, int t_len, int s_len, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const int s_rows = s_len > 0 ? s_len : 1;     // S = 0 loads no tile
  if (!make_map(&qm, q, D, t_len, bh) ||
      !make_map(&km, k, D, s_rows, bh / group) ||
      !make_map(&vm, v, D, s_rows, bh / group))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<D>::kBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid(bh, (t_len + kBlockQ - 1) / kBlockQ);
  flash_attention_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, t_len, s_len, group, causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes), with flash_attention_launch's
// arguments.  The launch runs on `stream`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(); it refuses (cudaErrorInvalidValue)
// what it does not take: dtype other than bf16 (code 1), D not 64, 128 or
// 256, a base pointer not 16-byte aligned.  q is (bh, t_len, d), k and v
// (bkv, s_len, d), out like q, all contiguous.

extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int bh,
                                            int bkv, int t_len, int s_len,
                                            int d, int dtype, int causal,
                                            int window, float softcap,
                                            float scale, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv || dtype != 1 || t_len < 0 ||
      s_len < 0 || (t_len + kBlockQ - 1) / kBlockQ > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (t_len == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int group = bh / bkv;
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, bh, group, t_len, s_len, causal,
                        window, softcap, scale, st);
    case 128:
      return launch<128>(q, k, v, out, bh, group, t_len, s_len, causal,
                         window, softcap, scale, st);
    case 256:
      return launch<256>(q, k, v, out, bh, group, t_len, s_len, causal,
                         window, softcap, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
