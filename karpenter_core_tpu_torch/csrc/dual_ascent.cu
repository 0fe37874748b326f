// Dual ascent of the pack LP's relaxation on Hopper (sm_90a).
//
// Replaces karpenter_core_tpu/solver/backends/lp.py::_dual_ascent_kernel
// (a lax.scan of `iters` multiplicative-weights steps). Inputs, padded by
// the wrapper as the reference pads them: reqs (S, R) and counts (S,)
// per signature, alloc (T, R), prices (T,) and valid (T,) per type, the
// starting weights w0 (T, R). Each iteration, as the reference's step:
//   1. project: mu_t = price_t * w_t / max(sum_r w_tr * alloc_tr, 1e-6);
//   2. route: t*_s = argmin_t sum_r req_sr * mu_tr over the types the
//      signature fits (valid, req <= alloc on every axis), 1e18 where it
//      fits none, first index on ties;
//   3. demand_tr = sum over the signatures routed to t (and fitting some
//      type) of count_s * req_sr, in signature order;
//   4. update: util = demand / max(alloc, 1), w *= 1 + lr * util /
//      max(rowmax(util), 1e-30), lr = 0.5 / sqrt(k + 1), with the
//      normalised utilisation rounded as demand / (max(alloc, 1) * peak)
//      and lr * it + 1 fused, as XLA compiles the reference's step.
// After the loop it projects and routes once more and writes w, t* and
// has_fit (the signature fits some type). The host re-certifies the
// bound from w in float64, as the reference does.
//
// Arithmetic. Every sum runs in axis or signature order with
// __fmul_rn / __fadd_rn / __fdiv_rn (no FMA contraction but the update's
// one fused multiply-add, taken exactly in double), the order of
// the plain version (backends/lp.py::dual_ascent_reference), so the two
// agree bit for bit on the card. Demand sums no atomics: R threads walk
// the signatures in order, each adding its axis to the routed type's
// row, so the float order never changes from run to run.
//
// Design. One thread block of 1024 threads per relax call, the iteration
// loop inside it. alloc, w, mu (reused as demand), prices, validity and
// the signatures live in shared memory when they fit (T = 2048 and R = 8
// take 208 KB), else in a global scratch buffer the wrapper passes. The
// route gives each warp a signature: lanes walk the types, a shuffle
// argmin (value, then index) ends it.
//
// Bound. Bytes: inputs read once and outputs written once, about
// (S * R + S + T * (2R + 2)) * 4 + T * R * 4 + S * 5. Operations: per
// iteration S * T * 2R flops of routing, T * 4R of projection and update,
// S * R of demand, over the published 67 TFLOP/s float32 rate. Neither
// bounds it: each iteration waits for the last (four block barriers),
// so the time is `iters` times one iteration's latency.
//
// Host build. The per-row steps are __host__ __device__; compiled by g++
// as C++ this file exports dual_ascent_host, the same iterations with the
// thread work run in order (tests/test_torch_lp.py).

#include <climits>
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <cmath>
#include <vector>
#define HD inline
#endif

#ifdef __CUDA_ARCH__
#define FMUL(a, b) __fmul_rn((a), (b))
#define FADD(a, b) __fadd_rn((a), (b))
#define FDIV(a, b) __fdiv_rn((a), (b))
#define F_INF __int_as_float(0x7f800000)
#else
#define FMUL(a, b) ((a) * (b))
#define FADD(a, b) ((a) + (b))
#define FDIV(a, b) ((a) / (b))
#define F_INF INFINITY
#endif

namespace {

constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_R = 16;
constexpr size_t SMEM_BUDGET = 220 * 1024;
// the reference's mask value: float32(_BIG * 1e6), _BIG = float32(1e12)
constexpr float MASKED = 1e18f;

// The kernel's working arrays, carved from one float buffer.
struct Work {
  float* alloc;   // (T, R)
  float* w;       // (T, R)
  float* mu;      // (T, R), then the iteration's demand
  float* price;   // (T,)
  float* valid;   // (T,) 1 or 0
  float* reqs;    // (S, R)
  float* counts;  // (S,)
  int32_t* tstar;   // (S,)
  int32_t* hasfit;  // (S,)
};

HD size_t work_floats(int S, int T, int R) {
  return static_cast<size_t>(T) * (3 * R + 2) + static_cast<size_t>(S) * (R + 3);
}

HD Work carve(float* base, int S, int T, int R) {
  Work k;
  k.alloc = base;
  k.w = k.alloc + T * R;
  k.mu = k.w + T * R;
  k.price = k.mu + T * R;
  k.valid = k.price + T;
  k.reqs = k.valid + T;
  k.counts = k.reqs + S * R;
  k.tstar = reinterpret_cast<int32_t*>(k.counts + S);
  k.hasfit = k.tstar + S;
  return k;
}

// sum_r a_r * b_r in axis order, each product and sum rounded
HD float dot_rn(const float* a, const float* b, int R) {
  float acc = FMUL(a[0], b[0]);
  for (int r = 1; r < R; ++r) acc = FADD(acc, FMUL(a[r], b[r]));
  return acc;
}

HD bool sig_fits(const Work& k, int s, int t, int R) {
  if (k.valid[t] == 0.0f) return false;
  const float* req = k.reqs + s * R;
  const float* al = k.alloc + t * R;
  for (int r = 0; r < R; ++r) {
    if (!(req[r] <= al[r])) return false;
  }
  return true;
}

HD void project_row(const Work& k, int t, int R) {
  const float* w = k.w + t * R;
  const float denom = dot_rn(w, k.alloc + t * R, R);
  const float d = denom > 1e-6f ? denom : 1e-6f;
  float* mu = k.mu + t * R;
  for (int r = 0; r < R; ++r) mu[r] = FDIV(FMUL(k.price[t], w[r]), d);
}

// the cost the route minimises for (s, t)
HD float route_cost(const Work& k, int s, int t, int R) {
  return sig_fits(k, s, t, R) ? dot_rn(k.reqs + s * R, k.mu + t * R, R) : MASKED;
}

#ifdef __CUDA_ARCH__
#define DMUL(a, b) __dmul_rn((a), (b))
#define DADD(a, b) __dadd_rn((a), (b))
#define DDIV(a, b) __ddiv_rn((a), (b))
#define DSQRT(a) __dsqrt_rn(a)
#define D2F(a) __double2float_rn(a)
#else
#define DMUL(a, b) ((a) * (b))
#define DADD(a, b) ((a) + (b))
#define DDIV(a, b) ((a) / (b))
#define DSQRT(a) std::sqrt(a)
#define D2F(a) static_cast<float>(a)
#endif

// w *= 1 + lr * util / max(rowmax(util), 1e-30), util = demand / max(alloc, 1),
// rounded as the reference's compiled step rounds it: the normalised
// utilisation as demand / (max(alloc, 1) * peak) (XLA folds the two
// divisions into one), then lr * it + 1 with one rounding (a fused
// multiply-add; the product is exact in double), times w
HD void update_row(const Work& k, int t, int R, float lr) {
  float safe[MAX_R];
  const float* al = k.alloc + t * R;
  const float* dm = k.mu + t * R;
  float peak = 0.0f;
  for (int r = 0; r < R; ++r) {
    safe[r] = al[r] > 1.0f ? al[r] : 1.0f;
    const float util = FDIV(dm[r], safe[r]);
    peak = r == 0 || util > peak ? util : peak;
  }
  peak = peak > 1e-30f ? peak : 1e-30f;
  float* w = k.w + t * R;
  for (int r = 0; r < R; ++r) {
    const double step = DADD(DMUL(static_cast<double>(lr), static_cast<double>(FDIV(dm[r], FMUL(safe[r], peak)))), 1.0);
    w[r] = FMUL(w[r], D2F(step));
  }
}

// 0.5 / sqrt(it + 1) as 0.5 times 1 / sqrt(it + 1) rounded once to float
// (backends/lp.py::step_lr)
HD float step_lr(int it) {
  return FMUL(0.5f, D2F(DDIV(1.0, DSQRT(static_cast<double>(it) + 1.0))));
}

#ifdef __CUDACC__
__device__ void route_all(const Work& k, int S, int T, int R, int lane, int warp) {
  for (int s = warp; s < S; s += NWARPS) {
    float bv = F_INF;
    int bi = INT_MAX;
    for (int t = lane; t < T; t += 32) {
      const float v = route_cost(k, s, t, R);
      if (v < bv) {
        bv = v;
        bi = t;
      }
    }
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) k.tstar[s] = bi;
  }
}

__global__ void __launch_bounds__(THREADS)
    dual_ascent_kernel(const float* __restrict__ reqs, const float* __restrict__ counts,
                       const float* __restrict__ alloc, const float* __restrict__ prices,
                       const uint8_t* __restrict__ valid, const float* __restrict__ w0, int S,
                       int T, int R, int iters, float* scratch, float* __restrict__ w_out,
                       int32_t* __restrict__ tstar_out, uint8_t* __restrict__ hasfit_out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Work k = carve(scratch != nullptr ? scratch : smem, S, T, R);
  for (int i = tid; i < T * R; i += THREADS) {
    k.alloc[i] = alloc[i];
    k.w[i] = w0[i];
  }
  for (int t = tid; t < T; t += THREADS) {
    k.price[t] = prices[t];
    k.valid[t] = valid[t] ? 1.0f : 0.0f;
  }
  for (int i = tid; i < S * R; i += THREADS) k.reqs[i] = reqs[i];
  for (int s = tid; s < S; s += THREADS) k.counts[s] = counts[s];
  __syncthreads();
  for (int s = warp; s < S; s += NWARPS) {
    bool any = false;
    for (int base = 0; base < T && !any; base += 32) {
      const int t = base + lane;
      any = __any_sync(0xffffffffu, t < T && sig_fits(k, s, t, R));
    }
    if (lane == 0) k.hasfit[s] = any;
  }
  for (int it = 0; it <= iters; ++it) {
    for (int t = tid; t < T; t += THREADS) project_row(k, t, R);
    __syncthreads();
    route_all(k, S, T, R, lane, warp);
    __syncthreads();
    if (it == iters) break;
    for (int i = tid; i < T * R; i += THREADS) k.mu[i] = 0.0f;
    __syncthreads();
    if (tid < R) {
      for (int s = 0; s < S; ++s) {
        if (!k.hasfit[s]) continue;
        float* d = k.mu + k.tstar[s] * R + tid;
        *d = FADD(*d, FMUL(k.counts[s], k.reqs[s * R + tid]));
      }
    }
    __syncthreads();
    const float lr = step_lr(it);
    for (int t = tid; t < T; t += THREADS) update_row(k, t, R, lr);
    __syncthreads();
  }
  for (int i = tid; i < T * R; i += THREADS) w_out[i] = k.w[i];
  for (int s = tid; s < S; s += THREADS) {
    tstar_out[s] = k.tstar[s];
    hasfit_out[s] = static_cast<uint8_t>(k.hasfit[s]);
  }
}
#endif

bool bad_args(int64_t S, int64_t T, int64_t R, int64_t iters) {
  return S < 1 || T < 1 || R < 1 || R > MAX_R || iters < 0;
}

}  // namespace

extern "C" {

// reqs (S, R), counts (S,), alloc (T, R), prices (T,), w0 (T, R) float32
// and valid (T,) uint8, row-major and contiguous; w_out (T, R) float32,
// tstar_out (S,) int32, hasfit_out (S,) uint8 are written. scratch: a
// float32 buffer of dual_ascent_scratch_floats(S, T, R) elements, used
// only when the working set does not fit in shared memory (pass any
// buffer, or null when dual_ascent_scratch_floats returns 0). Returns an
// error code without running when the arguments break that contract.
int64_t dual_ascent_scratch_floats(int64_t S, int64_t T, int64_t R) {
  const size_t n = work_floats(static_cast<int>(S), static_cast<int>(T), static_cast<int>(R));
  return n * 4 <= SMEM_BUDGET ? 0 : static_cast<int64_t>(n);
}

#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int dual_ascent_launch(const void* reqs, const void* counts, const void* alloc, const void* prices,
                       const void* valid, const void* w0, int64_t S, int64_t T, int64_t R,
                       int64_t iters, void* scratch, void* w_out, void* tstar_out,
                       void* hasfit_out, void* stream) {
  if (bad_args(S, T, R, iters)) return static_cast<int>(cudaErrorInvalidValue);
  const bool global = dual_ascent_scratch_floats(S, T, R) > 0;
  if (global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = global ? 0 : work_floats(S, T, R) * 4;
  cudaError_t err = cudaFuncSetAttribute(dual_ascent_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dual_ascent_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(reqs), static_cast<const float*>(counts),
      static_cast<const float*>(alloc), static_cast<const float*>(prices),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(w0), static_cast<int>(S),
      static_cast<int>(T), static_cast<int>(R), static_cast<int>(iters),
      global ? static_cast<float*>(scratch) : nullptr, static_cast<float*>(w_out),
      static_cast<int32_t*>(tstar_out), static_cast<uint8_t*>(hasfit_out));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same iterations on the CPU, host pointers, same layout as the launch.
int dual_ascent_host(const void* reqs, const void* counts, const void* alloc, const void* prices,
                     const void* valid, const void* w0, int64_t S, int64_t T, int64_t R,
                     int64_t iters, void* w_out, void* tstar_out, void* hasfit_out) {
  if (bad_args(S, T, R, iters)) return 1;
  std::vector<float> buf(work_floats(S, T, R));
  const Work k = carve(buf.data(), S, T, R);
  for (int64_t i = 0; i < T * R; ++i) {
    k.alloc[i] = static_cast<const float*>(alloc)[i];
    k.w[i] = static_cast<const float*>(w0)[i];
  }
  for (int64_t t = 0; t < T; ++t) {
    k.price[t] = static_cast<const float*>(prices)[t];
    k.valid[t] = static_cast<const uint8_t*>(valid)[t] ? 1.0f : 0.0f;
  }
  for (int64_t i = 0; i < S * R; ++i) k.reqs[i] = static_cast<const float*>(reqs)[i];
  for (int64_t s = 0; s < S; ++s) {
    k.counts[s] = static_cast<const float*>(counts)[s];
    bool any = false;
    for (int64_t t = 0; t < T && !any; ++t) any = sig_fits(k, s, t, R);
    k.hasfit[s] = any;
  }
  for (int64_t it = 0; it <= iters; ++it) {
    for (int64_t t = 0; t < T; ++t) project_row(k, t, R);
    for (int64_t s = 0; s < S; ++s) {
      float bv = F_INF;
      int bi = INT_MAX;
      for (int64_t t = 0; t < T; ++t) {
        const float v = route_cost(k, s, t, R);
        if (v < bv) {
          bv = v;
          bi = static_cast<int>(t);
        }
      }
      k.tstar[s] = bi;
    }
    if (it == iters) break;
    for (int64_t i = 0; i < T * R; ++i) k.mu[i] = 0.0f;
    for (int64_t r = 0; r < R; ++r) {
      for (int64_t s = 0; s < S; ++s) {
        if (!k.hasfit[s]) continue;
        float* d = k.mu + k.tstar[s] * R + r;
        *d = FADD(*d, FMUL(k.counts[s], k.reqs[s * R + r]));
      }
    }
    const float lr = step_lr(static_cast<int>(it));
    for (int64_t t = 0; t < T; ++t) update_row(k, t, R, lr);
  }
  for (int64_t i = 0; i < T * R; ++i) static_cast<float*>(w_out)[i] = k.w[i];
  for (int64_t s = 0; s < S; ++s) {
    static_cast<int32_t*>(tstar_out)[s] = k.tstar[s];
    static_cast<uint8_t*>(hasfit_out)[s] = static_cast<uint8_t>(k.hasfit[s]);
  }
  return 0;
}
#endif

}  // extern "C"
