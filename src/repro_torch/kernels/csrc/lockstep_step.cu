// Step-commit of the torch lockstep scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lockstep_step.py::step_commit
// (body _commit_kernel).  For every lane b of B, with the lane-last state
// clocks [P,S,B] f64, busy [P,B] f64, seen [P,B] bool and per-lane
// p [B] int64, rt [B] f64, base [B] f64, live [B] bool:
//
//   s     = first-minimum slot of clocks[p[b], :, b]  (the reference heap's
//           tie-break: the lowest index among equal clocks)
//   tmin  = clocks[p[b], s, b]
//   start = max(rt[b], tmin);  end = start + base[b];  end_out[b] = end
//   if live[b]: clocks[p[b], s, b] = end; busy[p[b], b] += end - start;
//               seen[p[b], b] = true
//
// The update is IN PLACE: only the chosen slot, busy[p] and seen[p] of a
// live lane are written.  (The Pallas kernel rewrote the whole [P,S,B]
// block because Pallas has no scatter.)  The state stays in f64: Hopper
// has native f64, and the torch engine's 1e-6 equivalence tier is stated
// for f64 end to end.  There is no multiply, so no FMA contraction can
// change a result, and the group reduction below picks the same slot as a
// sequential scan: the kernel is bit-identical to the plain PyTorch
// version step_commit_ref.
//
// NaN: max() below propagates a NaN operand like torch.maximum and
// jnp.maximum (CUDA's fmax would drop it), and a NaN clock counts as the
// minimum like torch.argmin (the first NaN, if there are several).  In the
// scan no NaN reaches rt or the clocks: clocks start at 0 or +inf, costs
// are NaN-scrubbed on the host, and start + base of a non-negative start
// and a finite base is never NaN.  An all-+inf pool does make end - start
// = inf - inf = NaN in busy; such lanes are flagged bad_row by the scan
// and discarded.
//
// Bound: one pass over the state the step touches: the S clocks of each
// lane's own pool (S*B*8 bytes; the other pools are not read), 25 bytes of
// p, rt, base and live per lane, 8 bytes of end per lane, and for each
// live lane busy read and written, one clock and one seen written.  The
// sweep's slices keep P*S*B near 8192, so S is large exactly where B is
// small (the commonest launch is (P,S,B) = (4,128,16)): tens of KB, a few
// thousandths of a microsecond at 3.35 TB/s.  The kernel is latency bound.
//
// Design.  A group of G threads owns one lane, G the power of two at or
// above S, at most 32 (a compile-time instance each; S >= 32 takes a whole
// warp).  Thread g of the group takes slots g, g + G, g + 2G, ...: it
// issues all of its strided loads before it compares any of them (kBatch
// at a time, unrolled), so the lane's pool costs one memory round trip,
// not S dependent ones, and keeps a local first-minimum under the scan's
// rule.  The group then combines its (value, slot) pairs by
// __shfl_xor_sync under the same total order (a NaN first, then the value,
// then the lower slot), and thread 0 of the group commits.  rt, base, live
// and the lane's busy entry are loaded by that thread before the
// reduction, so they are in flight with the clocks.  Blocks are kThreads
// wide, so at (4,128,16) the 16 lanes' 512 threads spread over 8 SMs.
// The earlier design, one thread a lane walking S dependent loads, took
// 18.7 us at S = 128 against 6.8 us at S = 16 on an H100 80GB HBM3 at
// 700 W (chip_smoke.py).
//
// The fused step (step_commit_fused_kernel, below) runs this commit as
// the fourth of five phases of one whole step of the scan, one launch a
// step; the standalone commit above stays for its own callers and tests.
// Folding the whole scan into one persistent kernel is later work.
#include <cuda_runtime.h>
#include <stdint.h>

// One launch's arguments, packed by the wrapper into a single ctypes
// argument (struct.Struct("@9P2q") in lockstep_step.py).
struct StepCommitArgs {
  void* clocks;
  void* busy;
  void* seen;
  const void* p;
  const void* rt;
  const void* base;
  const void* live;
  void* end_out;
  void* stream;
  int64_t S;
  int64_t B;
};

namespace {

constexpr int kThreads = 64;     // threads per block
constexpr int kBatch = 8;        // loads a thread has in flight per pass
constexpr int kMaxGroup = 32;

__host__ __device__ constexpr int group_for(int64_t S) {
  int g = 1;
  while (g < S && g < kMaxGroup) g <<= 1;
  return g;
}

__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// True when slot i holding v comes before slot j holding w in
// torch.argmin's order: a NaN before any number (the lower slot among
// NaNs), then the smaller value, then the lower slot.
__device__ __forceinline__ bool before(double v, int i, double w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn != wn) return vn;
  if (!vn && v != w) return v < w;
  return i < j;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
step_commit_kernel(double* __restrict__ clocks, double* __restrict__ busy,
                   uint8_t* __restrict__ seen,
                   const int64_t* __restrict__ p,
                   const double* __restrict__ rt,
                   const double* __restrict__ base,
                   const uint8_t* __restrict__ live,
                   double* __restrict__ end_out, int S, int B) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int b = tid / G;
  const int g = tid % G;
  const bool lane = b < B;
  // "no slot yet": +inf at slot S, after every real slot
  double best = __longlong_as_double(0x7ff0000000000000LL);
  int best_i = S;
  int64_t pb = 0;
  double rt_b = 0.0, base_b = 0.0, busy_b = 0.0;
  uint8_t live_b = 0;
  if (lane) {
    if (g == 0) {
      rt_b = rt[b];
      base_b = base[b];
      live_b = live[b];
    }
    pb = p[b];
    if (g == 0) busy_b = busy[pb * B + b];
    const double* col = clocks + pb * (int64_t)S * B + b;
    for (int j0 = g; j0 < S; j0 += kBatch * G) {
      double v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q * G;
        v[q] = j < S ? col[(int64_t)j * B] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q * G;
        if (j < S && before(v[q], j, best, best_i)) {
          best = v[q];
          best_i = j;
        }
      }
    }
  }
  // The group's xor tree; every thread of the warp takes part (groups
  // never straddle a warp: G divides 32 and kThreads).
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (before(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (!lane || g != 0) return;
  const double start = max_nan(rt_b, best);
  const double end = start + base_b;
  end_out[b] = end;
  if (live_b) {
    clocks[(pb * S + best_i) * (int64_t)B + b] = end;
    busy[pb * B + b] = busy_b + (end - start);
    seen[pb * B + b] = 1;
  }
}

template <int G>
int launch(const StepCommitArgs& a) {
  const int S = (int)a.S, B = (int)a.B;
  const int64_t threads = (int64_t)B * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  step_commit_kernel<G><<<blocks, kThreads, 0, (cudaStream_t)a.stream>>>(
      (double*)a.clocks, (double*)a.busy, (uint8_t*)a.seen,
      (const int64_t*)a.p, (const double*)a.rt, (const double*)a.base,
      (const uint8_t*)a.live, (double*)a.end_out, S, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  The launch runs on the
// stream it is given, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported by the caller.
extern "C" int step_commit_launch(const StepCommitArgs* a) {
  if (a->S < 1 || a->S >= (1LL << 31) || a->B < 0 || a->B >= (1LL << 26))
    return (int)cudaErrorInvalidValue;
  if (a->B == 0) return (int)cudaSuccess;
  switch (group_for(a->S)) {
    case 1: return launch<1>(*a);
    case 2: return launch<2>(*a);
    case 4: return launch<4>(*a);
    case 8: return launch<8>(*a);
    case 16: return launch<16>(*a);
    default: return launch<32>(*a);
  }
}

extern "C" int step_commit_args_bytes() {
  return (int)sizeof(StepCommitArgs);
}

// The threads a lane's pool of S slots is split across (G above).
extern "C" int step_commit_group(int S) { return group_for(S); }

extern "C" const char* step_commit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ---------------------------------------------------------------------------
// The fused step: one launch runs one whole step of the torch scan
// (repro_torch/core/torchsim.py::_steps) for every lane, in place of the
// ~150 PyTorch operations of its plain body and the separate step_commit
// launch.  It replaces no Pallas kernel: the JAX package's scan body
// (repro/core/jaxsim.py) is XLA's to fuse.
//
// State, lane-last as in torchsim._State: clocks [P,S,B] f64, ready and
// placement (int32) and npred (int32) [rows,B], busy [P,B] f64, seen [P,B]
// bool, key [B,rows] f64 (lane-first), and per lane makespan, prev_rt
// (f64), prev_tb (int64), div (bool) and t (int64: each lane's own step
// counter, so that no two blocks touch one word), read-only own (bool),
// cohort (int64), ran (int32) and gone (f64).  Step inputs: the packed
// cohort-last blocks xi [T,WI,G] int64 (r, tb, c, k_first, K own options,
// K parallel options, SC successors), xf [T,2NK,G] f64 (own then parallel
// costs) and xb [T,3+NK,G] bool (valid, is_comp, bad_row, NK act), each
// lane reading its cohort's column; kind_pool [B,NK] and smp_kid [B].
//
// Each lane b is one block, and lanes never interact, so the grid needs no
// synchronisation.  In the block:
//
//   1. Every load that needs nothing of this step, at once: the lane's
//      heap keys (thread i takes keys i, i + blockDim, ..., kKeys in
//      flight: the block's width comes from rows, fused_threads_for below;
//      read on a replayed lane too, so that no load waits for `own`), each
//      pool's first-minimum slot over its S clocks (groups of
//      group_for(S) threads a pool, the commit kernel's split and shuffle
//      tree), the lane's kind_pool row, busy column and scalars.
//   2. The heap's first minimum (warp shuffles, then every warp over the
//      warps' results, so that no barrier broadcasts it): the row `at` an
//      own-order lane runs; a replayed lane runs the row of its counter.
//      The row's packed inputs are staged in shared memory, one word a
//      thread.
//   3. What the row names: ready[r], placement at the conditional parent
//      and at r, and each successor's ready and npred (one thread a
//      successor, which also counts the successor's repeats and whether
//      it is the row that leaves the heap).
//   4. Two warps: the two choose passes at once, an option a thread
//      (shuffles and ballots); then one thread: the divergence check, the
//      conditional pass-through, the commit (the slot is the pool's first
//      minimum of phase 1, since no clock changes before it), makespan,
//      prev_rt/prev_tb, placement, and the leaving row's key and npred
//      unless a successor owns them.
//   5. One thread a distinct successor: ready = max(ready, end_eff),
//      npred += (its repeats) * valid, key = ready where npred reaches 0,
//      else inf.
//
// Every result is bit-identical to the plain body on the CPU: f64 with no
// multiply (no FMA contraction), the first minimum under torch.min's and
// torch.argmin's order (a NaN first, then the value, then the lower index,
// which every reduction tree gives alike), max_nan where the body takes
// torch.maximum or scatter_reduce's amax (both propagate a NaN), the
// choose passes' exact tie order (least key, then an accelerator before
// the SMP, then the lowest option), repeated successors folded as
// scatter_reduce_/scatter_add_/scatter_ fold them.  A row index `at`
// outside the step inputs (the plain body raises there) is read as row 0
// and flags the lane diverged, never read out of bounds.
//
// Bound: latency.  The bytes a step must move are the commit's (a pool's
// clocks, the lane's scalars) plus a heap of rows keys and a few dozen
// words a lane: about 7 MB at the matmul's rows 3,585
// and B 256, mostly L2-resident, 2 us at HBM bandwidth and well under
// that from L2.  The step is a chain of three dependent rounds of loads
// (keys and clocks; the row; what the row names) and five block barriers.

struct StepFusedArgs {
  const void* xi;
  const void* xf;
  const void* xb;
  const void* kind_pool;
  const void* smp_kid;
  const void* cohort;
  const void* own;
  const void* ran;
  const void* gone;
  void* clocks;
  void* ready;
  void* placement;
  void* busy;
  void* seen;
  void* makespan;
  void* prev_rt;
  void* prev_tb;
  void* div;
  void* npred;
  void* key;
  void* t;
  void* stream;
  int64_t P, S, B, rows, T, G, K, NK, SC, eft;
};

namespace {

constexpr int kFusedMaxThreads = 256;
constexpr int kKeys = 16;        // heap keys a thread has in flight

constexpr int fused_threads_for(int64_t rows, int64_t P, int64_t S) {
  const int64_t heap = (rows + kKeys - 1) / kKeys;
  const int64_t pools = P * group_for(S);
  const int64_t need = heap > pools ? heap : pools;
  int t = 32;
  while (t < need && t < kFusedMaxThreads) t <<= 1;
  return t;
}

// Shared memory of a block beyond its static part, in the kernel's order.
__host__ __device__ constexpr int64_t fused_smem_bytes(int64_t P, int64_t K,
                                                       int64_t NK,
                                                       int64_t SC) {
  return 8 * ((4 + 2 * K + SC) + 2 * NK + NK + 2 * P + SC) +
         4 * (P + 2 * SC) + (3 + NK);
}

struct Fused {
  const int64_t* xi;
  const double* xf;
  const uint8_t* xb;
  const int64_t* kind_pool;
  const int64_t* smp_kid;
  const int64_t* cohort;
  const uint8_t* own;
  const int32_t* ran;
  const double* gone;
  double* clocks;
  double* ready;
  int32_t* placement;
  double* busy;
  uint8_t* seen;
  double* makespan;
  double* prev_rt;
  int64_t* prev_tb;
  uint8_t* div;
  int32_t* npred;
  double* key;
  int64_t* t;
  int64_t T;
  int P, S, B, rows, G, K, NK, SC;
  bool eft;
};

constexpr double kInf = __builtin_huge_val();

// The xor tree over W lanes of a warp (W a power of two, at most 32):
// every lane ends with the group's first (value, index) under before().
template <int W>
__device__ __forceinline__ void first_min_xor(double& v, int& i) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Option k of a choose pass: whether it has a pool, and its key.
__device__ __forceinline__ bool option_key(const int64_t* opts,
                                           const double* cost, int k,
                                           double rt, const int64_t* kp,
                                           const double* minv, bool eft,
                                           double* keyv) {
  const int64_t o = opts[k];
  const int64_t kk = o < 0 ? 0 : o;
  const int64_t pi = kp[kk];
  double key = max_nan(rt, minv[pi < 0 ? 0 : pi]);
  if (eft) key = key + cost[kk];
  const bool valid = o >= 0 && pi >= 0;
  *keyv = valid ? key : kInf;
  return valid;
}

// torchsim._steps' choose() for one lane, by the 32 threads of a warp
// (thread q takes options q, q + 32, ...): among the options with a pool,
// the least key (torch.amin's: a NaN anywhere leaves no tie), then an
// accelerator before the SMP, then the lowest index; -1 if none.  Every
// thread of the warp returns the choice.
__device__ int64_t choose_warp(const int64_t* opts, const double* cost,
                               double rt, const int64_t* kp,
                               const double* minv, int64_t smp, int K,
                               bool eft, int lane) {
  double m = kInf;
  for (int k = lane; k < K; k += 32) {
    double v;
    option_key(opts, cost, k, rt, kp, minv, eft, &v);
    if (m == m && (v != v || v < m)) m = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(0xffffffffu, m, off);
    if (m == m && (o != o || o < m)) m = o;
  }
  bool other_tie = false;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    double v;
    const bool tie = k < K && option_key(opts, cost, k, rt, kp, minv, eft,
                                         &v) && v == m;
    other_tie |= __any_sync(0xffffffffu, tie && opts[k] != smp);
  }
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    double v;
    const bool pick = k < K && option_key(opts, cost, k, rt, kp, minv, eft,
                                          &v) && v == m &&
                      !(opts[k] == smp && other_tie);
    const unsigned hits = __ballot_sync(0xffffffffu, pick);
    if (hits) return opts[k0 + __ffs(hits) - 1];
  }
  return -1;
}

template <int GP>
__global__ void __launch_bounds__(kFusedMaxThreads)
step_commit_fused_kernel(Fused a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int P = a.P, S = a.S, B = a.B, rows = a.rows, G = a.G, K = a.K,
            NK = a.NK, SC = a.SC;
  const int WI = 4 + 2 * K + SC, WF = 2 * NK, WB = 3 + NK;
  int64_t* xrow = reinterpret_cast<int64_t*>(smem);       // [WI]
  double* frow = reinterpret_cast<double*>(xrow + WI);    // [2 NK]
  int64_t* kp = reinterpret_cast<int64_t*>(frow + WF);    // [NK]
  double* minv = reinterpret_cast<double*>(kp + NK);      // [P]
  double* busyv = minv + P;                               // [P]
  double* sready = busyv + P;                             // [SC]
  int32_t* mins = reinterpret_cast<int32_t*>(sready + SC);  // [P]
  int32_t* snpred = mins + P;                             // [SC]
  int32_t* smult = snpred + SC;                           // [SC]
  uint8_t* brow = reinterpret_cast<uint8_t*>(smult + SC);   // [3 + NK]
  __shared__ double warp_v[kFusedMaxThreads / 32];
  __shared__ int warp_i[kFusedMaxThreads / 32];
  __shared__ double s_rt;
  __shared__ int32_t s_place_c, s_place_r;
  __shared__ int64_t s_chosen_o;
  __shared__ double s_end_eff;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int groups = nth / GP, q = tid / GP, g = tid % GP;

  // ---- 1. loads that need nothing of this step -------------------------
  // All in flight at once: a thread's first batch of heap keys (read on
  // every lane, so that no load waits for `own`; a replayed lane ignores
  // them) and of its first pool's clocks, the lane's scalars, its
  // kind_pool row and busy column.
  const bool own = a.own[b] != 0;
  const int64_t col = a.cohort[b];
  const int64_t smp_b = a.smp_kid[b];
  const int32_t ran_b = a.ran[b];
  const int64_t t_b = a.t[b];
  int64_t prev_tb_b = 0;
  double prev_rt_b = 0.0, makespan_b = 0.0, gone_b = 0.0;
  bool div_b = false;
  if (tid == 0) {
    prev_rt_b = a.prev_rt[b];
    prev_tb_b = a.prev_tb[b];
    makespan_b = a.makespan[b];
    div_b = a.div[b] != 0;
    gone_b = a.gone[b];
  }
  const double* kr = a.key + (int64_t)b * rows;
  double kv[kKeys], cv[kBatch];
#pragma unroll
  for (int u = 0; u < kKeys; ++u) {
    const int i = tid + u * nth;
    kv[u] = i < rows ? kr[i] : 0.0;
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int j = g + u * GP;
    cv[u] = q < P && j < S ? a.clocks[((int64_t)q * S + j) * B + b] : 0.0;
  }
  for (int j = tid; j < NK; j += nth) kp[j] = a.kind_pool[(int64_t)b * NK + j];
  for (int p = tid; p < P; p += nth) busyv[p] = a.busy[(int64_t)p * B + b];
  // the heap's first minimum, this thread's share: "no key yet" is +inf
  // at index rows, after every row
  double hv = kInf;
  int hi = rows;
  for (int i0 = tid; i0 < rows; i0 += kKeys * nth) {
    double v[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int i = i0 + u * nth;
      v[u] = i0 == tid ? kv[u] : (i < rows ? kr[i] : 0.0);
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int i = i0 + u * nth;
      if (i < rows && before(v[u], i, hv, hi)) {
        hv = v[u];
        hi = i;
      }
    }
  }
  // each pool's first-minimum slot, a group of GP threads a pool
  for (int p0 = 0; p0 < P; p0 += groups) {
    const int p = p0 + q;
    double best = kInf;
    int best_i = S;
    if (p < P) {
      const double* pc = a.clocks + (int64_t)p * S * B + b;
      for (int j0 = g; j0 < S; j0 += kBatch * GP) {
        double v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u * GP;
          v[u] = p0 == 0 && j0 == g ? cv[u]
                                    : (j < S ? pc[(int64_t)j * B] : 0.0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = j0 + u * GP;
          if (j < S && before(v[u], j, best, best_i)) {
            best = v[u];
            best_i = j;
          }
        }
      }
    }
    first_min_xor<GP>(best, best_i);
    if (p < P && g == 0) {
      minv[p] = best;
      mins[p] = best_i;
    }
  }
  first_min_xor<32>(hv, hi);
  if (lane == 0) {
    warp_v[warp] = hv;
    warp_i[warp] = hi;
  }
  __syncthreads();

  // ---- 2. the row this lane runs, staged ---------------------------------
  // every warp folds the warps' minima itself: no barrier to broadcast it
  double kmin = lane < nwarps ? warp_v[lane] : kInf;
  {
    int i = lane < nwarps ? warp_i[lane] : rows;
    first_min_xor<32>(kmin, i);
    hi = i;
  }
  int64_t at = own ? (int64_t)hi : t_b;
  if (at < 0 || at >= a.T) {
    at = 0;
    div_b = true;
  }
  for (int w = tid; w < WI; w += nth)
    xrow[w] = a.xi[(at * WI + w) * G + col];
  for (int w = tid; w < WF; w += nth)
    frow[w] = a.xf[(at * WF + w) * G + col];
  for (int w = tid; w < WB; w += nth)
    brow[w] = a.xb[(at * WB + w) * G + col];
  __syncthreads();

  // ---- 3. what the row names ---------------------------------------------
  const int64_t* succ = xrow + 4 + 2 * K;
  const int64_t r = xrow[0];
  const bool valid = own ? kmin < kInf : brow[0] != 0;
  const int64_t ran = valid ? r : (int64_t)(rows - 1);
  if (tid == 0) {
    const int64_t c = xrow[2];
    s_rt = a.ready[r * B + b];
    s_place_c = a.placement[(c < 0 ? 0 : c) * B + b];
    s_place_r = a.placement[r * B + b];
  }
  int hit = 0;
  for (int j = tid; j < SC; j += nth) {
    const int64_t s = succ[j];
    sready[j] = a.ready[s * B + b];
    snpred[j] = a.npred[s * B + b];
    int mult = 0, first = 1;
    for (int i = 0; i < SC; ++i) {
      const int same = succ[i] == s;
      mult += same;
      first &= !(same && i < j);
    }
    smult[j] = first ? mult : 0;      // a repeat's first entry counts all
    hit |= s == ran;
  }
  const bool ran_in_succ = __syncthreads_or(hit) != 0;

  // ---- 4. divergence, choose, commit -----------------------------------
  // the two choose passes in two warps at once (one warp: in turn)
  const double rt = s_rt;
  const int64_t* own_opts = xrow + 4;
  const int64_t* par_opts = xrow + 4 + K;
  const double* own_cost = frow;
  const double* par_cost = frow + NK;
  int64_t chosen_p = -1;
  if (warp == 0)
    chosen_p = choose_warp(par_opts, par_cost, rt, kp, minv, smp_b, K, a.eft,
                           lane);
  if (warp == (nwarps > 1 ? 1 : 0)) {
    const int64_t chosen_o = choose_warp(own_opts, own_cost, rt, kp, minv,
                                         smp_b, K, a.eft, lane);
    if (lane == 0) s_chosen_o = chosen_o;
  }
  __syncthreads();
  if (tid == 0) {
    const int64_t tbv = xrow[1], c = xrow[2], k_first = xrow[3];
    const bool is_comp = brow[1] != 0, bad_row = brow[2] != 0;
    const uint8_t* act = brow + 3;
    bool dv = div_b;
    if (valid && !own &&
        (rt < prev_rt_b || (rt == prev_rt_b && tbv <= prev_tb_b)))
      dv = true;
    // conditional pass-through
    const bool has_cond = c >= 0 && valid;
    const int64_t cmax = c < 0 ? 0 : c;
    const int64_t pk_old = s_place_c;
    const int64_t pk = pk_old < 0 ? chosen_p : pk_old;
    const int32_t placed_c = (int32_t)(has_cond ? pk : pk_old);
    if (has_cond) a.placement[cmax * B + b] = placed_c;
    const bool live = (!has_cond || act[pk < 0 ? 0 : pk] != 0) && valid;
    // dispatch
    const int64_t k_own = r == cmax ? (int64_t)placed_c : (int64_t)s_place_r;
    const bool und = k_own < 0;
    const int64_t k = is_comp ? (und ? s_chosen_o : k_own) : k_first;
    if (is_comp && live && und) a.placement[r * B + b] = (int32_t)k;
    if (live && (bad_row || k < 0)) dv = true;
    const int64_t kk = k < 0 ? 0 : k;
    const int64_t pp = kp[kk];
    const int64_t p = pp < 0 ? 0 : pp;
    const double start = max_nan(rt, minv[p]);
    const double end = start + own_cost[kk];
    if (live) {
      a.clocks[(p * S + mins[p]) * (int64_t)B + b] = end;
      a.busy[p * B + b] = busyv[p] + (end - start);
      a.seen[p * B + b] = 1;
    }
    const double end_eff = live ? end : (valid ? rt : 0.0);
    a.makespan[b] = max_nan(makespan_b, end_eff);
    if (valid) {
      a.prev_rt[b] = rt;
      a.prev_tb[b] = tbv;
    }
    a.div[b] = dv;
    if (!ran_in_succ) {
      a.key[(int64_t)b * rows + ran] = gone_b;
      a.npred[ran * B + b] = ran_b;
    }
    a.t[b] = t_b + 1;
    s_end_eff = end_eff;
  }
  __syncthreads();

  // ---- 5. the successors and the heap ----------------------------------
  const double end_eff = s_end_eff;
  for (int j = tid; j < SC; j += nth) {
    if (!smult[j]) continue;
    const int64_t s = succ[j];
    const double nr = max_nan(sready[j], end_eff);
    a.ready[s * B + b] = nr;
    // the ran row's npred is set before the successors add theirs
    const int32_t n0 = s == ran ? ran_b : snpred[j];
    const int32_t n1 = n0 + smult[j] * (int)valid;
    a.npred[s * B + b] = n1;
    a.key[(int64_t)b * rows + s] = n1 == 0 ? nr : kInf;
  }
}

template <int GP>
int launch_fused(const StepFusedArgs& a, int threads, int64_t smem) {
  const Fused f{(const int64_t*)a.xi, (const double*)a.xf,
                (const uint8_t*)a.xb, (const int64_t*)a.kind_pool,
                (const int64_t*)a.smp_kid, (const int64_t*)a.cohort,
                (const uint8_t*)a.own, (const int32_t*)a.ran,
                (const double*)a.gone, (double*)a.clocks, (double*)a.ready,
                (int32_t*)a.placement, (double*)a.busy, (uint8_t*)a.seen,
                (double*)a.makespan, (double*)a.prev_rt,
                (int64_t*)a.prev_tb, (uint8_t*)a.div, (int32_t*)a.npred,
                (double*)a.key, (int64_t*)a.t, a.T, (int)a.P, (int)a.S,
                (int)a.B, (int)a.rows, (int)a.G, (int)a.K, (int)a.NK,
                (int)a.SC, a.eft != 0};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        step_commit_fused_kernel<GP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  step_commit_fused_kernel<GP><<<(unsigned)a.B, threads, (size_t)smem,
                                 (cudaStream_t)a.stream>>>(f);
  return (int)cudaGetLastError();
}

}  // namespace

// One whole step for every lane, on the stream it is given: no
// synchronisation, no allocation; returns cudaGetLastError().
extern "C" int step_fused_launch(const StepFusedArgs* a) {
  const int64_t lim = 1LL << 31;
  if (a->P < 1 || a->S < 1 || a->B < 0 || a->rows < 1 || a->T < 1 ||
      a->G < 1 || a->K < 1 || a->NK < 1 || a->SC < 0 || a->P >= lim ||
      a->S >= lim || a->B >= lim || a->rows >= lim || a->T >= lim ||
      a->G >= lim || a->P * a->S >= lim || a->K >= (1 << 20) ||
      a->NK >= (1 << 20) || a->SC >= (1 << 20))
    return (int)cudaErrorInvalidValue;
  if (a->B == 0) return (int)cudaSuccess;
  const int64_t smem = fused_smem_bytes(a->P, a->K, a->NK, a->SC);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  const int threads = fused_threads_for(a->rows, a->P, a->S);
  switch (group_for(a->S)) {
    case 1: return launch_fused<1>(*a, threads, smem);
    case 2: return launch_fused<2>(*a, threads, smem);
    case 4: return launch_fused<4>(*a, threads, smem);
    case 8: return launch_fused<8>(*a, threads, smem);
    case 16: return launch_fused<16>(*a, threads, smem);
    default: return launch_fused<32>(*a, threads, smem);
  }
}

extern "C" int step_fused_args_bytes() {
  return (int)sizeof(StepFusedArgs);
}
