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
// change a result: the kernel is bit-identical to the plain PyTorch
// version step_commit_ref.
//
// NaN: max() below propagates a NaN operand like torch.maximum and
// jnp.maximum (CUDA's fmax would drop it), and a NaN clock counts as the
// minimum like torch.argmin.  In the scan no NaN reaches rt or the clocks:
// clocks start at 0 or +inf, costs are NaN-scrubbed on the host, and
// start + base of a non-negative start and a finite base is never NaN.  An
// all-+inf pool does make end - start = inf - inf = NaN in busy; such lanes
// are flagged bad_row by the scan and discarded.
//
// Design and bound: one thread per lane with a loop over S inside the
// thread.  With the lane axis last, neighbouring threads read neighbouring
// addresses, so each slot row of the chosen pool is one coalesced read.
// The work is one pass over the state the step touches: the S clocks of
// each lane's own pool (S*B*8 bytes; the other pools are not read), 25
// bytes of p, rt, base and live per lane, 8 bytes of end per lane, and for
// each live lane busy read and written, one clock and one seen written.
// The sweep's slices keep P*S*B near 8192 (B <= 256), so that is tens of
// KB, a few hundredths of a microsecond at 3.35 TB/s, far below the few
// microseconds one launch costs.  The kernel is launch-latency bound; what
// the design does about it is to do the whole commit in one launch with no
// allocation, no synchronisation and no second pass.  Folding the whole
// scan into one persistent kernel is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double max_nan(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void step_commit_kernel(double* __restrict__ clocks,
                                   double* __restrict__ busy,
                                   uint8_t* __restrict__ seen,
                                   const int64_t* __restrict__ p,
                                   const double* __restrict__ rt,
                                   const double* __restrict__ base,
                                   const uint8_t* __restrict__ live,
                                   double* __restrict__ end_out,
                                   int S, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t pb = p[b];
  double* col = clocks + pb * (int64_t)S * B + b;
  double tmin = col[0];
  int s = 0;
  for (int j = 1; j < S; ++j) {
    const double v = col[(int64_t)j * B];
    // strict < keeps the first minimum; a NaN replaces a non-NaN minimum
    // once and is then kept, as torch.argmin does
    if (v < tmin || (v != v && tmin == tmin)) {
      tmin = v;
      s = j;
    }
  }
  const double start = max_nan(rt[b], tmin);
  const double end = start + base[b];
  end_out[b] = end;
  if (live[b]) {
    col[(int64_t)s * B] = end;
    busy[pb * B + b] += end - start;
    seen[pb * B + b] = 1;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so a
// refused launch is reported by the caller.
extern "C" int step_commit_launch(void* clocks, void* busy, void* seen,
                                  const void* p, const void* rt,
                                  const void* base, const void* live,
                                  void* end_out, int S, int B,
                                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  step_commit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (double*)clocks, (double*)busy, (uint8_t*)seen, (const int64_t*)p,
      (const double*)rt, (const double*)base, (const uint8_t*)live,
      (double*)end_out, S, B);
  return (int)cudaGetLastError();
}

extern "C" const char* step_commit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
