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
