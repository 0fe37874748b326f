// The consolidation capacity screens on Hopper (sm_90a), B8.
//
// Replaces the three float32 screens of
// karpenter_core_tpu/disruption/tpu_repack.py (jax.jit functions, not
// Pallas kernels): prefix_screen_kernel, subset_screen_kernel and
// single_screen_kernel. Each row asks whether removing a set of candidate
// nodes is capacity-feasible: on every resource column r,
//
//   load <= (fleet_free[r] + surviving[r]) + new_node_cap[r]
//
// in that association (the reference's), where
//   prefix, row k < N:  load = sum_{n <= k} loads[n, r],
//                       surviving = total_free[r] - sum_{n <= k} free[n, r];
//   subset, row s < S:  load = sum_n m[s, n] * loads[n, r],
//                       surviving = sum_n (1 - m[s, n]) * free[n, r];
//   single, row i < N:  load = loads[i, r],
//                       surviving = total_free[r] - free[i, r];
// with total_free[r] = sum_n free[n, r]. The inputs are int32, converted
// to float32 with round-to-nearest; the screen is a float32 heuristic by
// design, verified afterwards by a scheduling simulation.
//
// Why a kernel of its own. Once partial sums pass 2^24, float32 addition
// is not associative, and a row's verdict can flip at a near-tie with the
// order of the additions. A cumsum or a matrix product in PyTorch takes
// whatever order CUB or cuBLAS picks on the card, and another on the CPU.
// Here every sum runs over the candidates in candidate order, one float32
// add at a time with round-to-nearest (__fadd_rn: no contraction), so the
// card, this file built by g++ for the CPU and the plain PyTorch versions
// (karpenter_core_tpu_torch/disruption/screen_kernels.py) give the same
// bits. Products by a 0/1 mask are exact, so they are written as selects:
// adding +0.0 leaves a sum as it was.
//
// Design: one warp per row. Lane r of the warp owns resource column r
// (r, r + 32, ... when R > 32) and walks the candidates n = 0 .. N - 1
// once, accumulating its sums in registers; the row's verdict is the warp
// vote (__all_sync) of the lanes' column verdicts, lanes past R voting
// true. A warp reads loads[n, lane] and free[n, lane] for neighbouring
// lanes at neighbouring addresses, and the subset mask byte m[s, n] once
// for the whole warp. Eight warps a block.
//
// Bound. Bytes, each input read once and each output written once:
// prefix and single 2 * N * R * 4 + 2 * R * 4 + N, subset S * N +
// 2 * N * R * 4 + 2 * R * 4 + S. Operations, float32 adds and compares of
// the plain formula: prefix about 6 N R, single about 5 N R, subset about
// 4 S N R (two products of (S, N) by (N, R)). At the sizes of bench
// configs 4 and 9 (N <= 1,000, S <= 8,193, R <= 8) both bounds are a few
// microseconds; the kernel is bound by the per-row chain of N dependent
// adds (each lane's sums are sequential by construction) and by the
// launch. chip_smoke.py phase 15d times it on every captured shape.
//
// Host build. The column sums are __host__ __device__; compiled by g++ as
// C++ this file exports disrupt_{prefix,subsets,singles}_host, which run
// the same column functions over every (row, column) and AND the verdicts
// (tests/test_torch_disrupt_screen.py).

#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr int LANES = 32;

HD float to_f32(int32_t v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return static_cast<float>(v);
#endif
}

HD float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

HD float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// Column r's verdict, given the row's load and surviving candidate free.
HD bool fits(float load, float surviving, const int32_t* fleet, const int32_t* cap, int64_t r) {
  return load <= add(add(to_f32(fleet[r]), surviving), to_f32(cap[r]));
}

// Prefix row k, column r: cumulative load and free over n <= k, the total
// free over every n, one pass in candidate order.
HD bool prefix_column(const int32_t* loads, const int32_t* free, const int32_t* fleet,
                      const int32_t* cap, int64_t N, int64_t R, int64_t k, int64_t r) {
  float cum_load = 0.0f, cum_free = 0.0f, total = 0.0f;
  for (int64_t n = 0; n < N; ++n) {
    const float f = to_f32(free[n * R + r]);
    total = add(total, f);
    if (n <= k) {
      cum_load = add(cum_load, to_f32(loads[n * R + r]));
      cum_free = add(cum_free, f);
    }
  }
  return fits(cum_load, sub(total, cum_free), fleet, cap, r);
}

// Subset row s, column r: the masked load and the unmasked free.
HD bool subset_column(const uint8_t* mask_row, const int32_t* loads, const int32_t* free,
                      const int32_t* fleet, const int32_t* cap, int64_t N, int64_t R, int64_t r) {
  float load = 0.0f, surviving = 0.0f;
  for (int64_t n = 0; n < N; ++n) {
    const bool m = mask_row[n] != 0;
    load = add(load, m ? to_f32(loads[n * R + r]) : 0.0f);
    surviving = add(surviving, m ? 0.0f : to_f32(free[n * R + r]));
  }
  return fits(load, surviving, fleet, cap, r);
}

// Single row i, column r: candidate i's load against everyone else's free.
HD bool single_column(const int32_t* loads, const int32_t* free, const int32_t* fleet,
                      const int32_t* cap, int64_t N, int64_t R, int64_t i, int64_t r) {
  float total = 0.0f;
  for (int64_t n = 0; n < N; ++n) total = add(total, to_f32(free[n * R + r]));
  return fits(to_f32(loads[i * R + r]), sub(total, to_f32(free[i * R + r])), fleet, cap, r);
}

enum class Mode { Prefix, Subset, Single };

template <Mode M>
HD bool column(const uint8_t* masks, const int32_t* loads, const int32_t* free,
               const int32_t* fleet, const int32_t* cap, int64_t N, int64_t R, int64_t row,
               int64_t r) {
  if (M == Mode::Prefix) return prefix_column(loads, free, fleet, cap, N, R, row, r);
  if (M == Mode::Subset) return subset_column(masks + row * N, loads, free, fleet, cap, N, R, r);
  return single_column(loads, free, fleet, cap, N, R, row, r);
}

bool bad_args(int64_t rows, int64_t N, int64_t R) { return rows < 0 || N < 0 || R < 0; }

#ifdef __CUDACC__

template <Mode M>
__global__ void __launch_bounds__(WARPS * LANES)
screen_kernel(const uint8_t* __restrict__ masks, const int32_t* __restrict__ loads,
              const int32_t* __restrict__ free, const int32_t* __restrict__ fleet,
              const int32_t* __restrict__ cap, int64_t rows, int64_t N, int64_t R,
              bool* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / LANES;
  if (row >= rows) return;  // the whole warp: a row is one warp
  const int lane = threadIdx.x % LANES;
  bool ok = true;
  for (int64_t r = lane; r < R; r += LANES) {
    ok = ok && column<M>(masks, loads, free, fleet, cap, N, R, row, r);
  }
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) out[row] = ok;
}

template <Mode M>
int launch(const void* masks, const void* loads, const void* free, const void* fleet,
           const void* cap, int64_t rows, int64_t N, int64_t R, void* out, void* stream) {
  if (bad_args(rows, N, R)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (rows + WARPS - 1) / WARPS;
  screen_kernel<M><<<static_cast<unsigned>(blocks), WARPS * LANES, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const int32_t*>(loads),
      static_cast<const int32_t*>(free), static_cast<const int32_t*>(fleet),
      static_cast<const int32_t*>(cap), rows, N, R, static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

#else

template <Mode M>
int run_host(const void* masks, const void* loads, const void* free, const void* fleet,
             const void* cap, int64_t rows, int64_t N, int64_t R, void* out) {
  if (bad_args(rows, N, R)) return 1;
  auto* o = static_cast<uint8_t*>(out);
  for (int64_t row = 0; row < rows; ++row) {
    bool ok = true;
    for (int64_t r = 0; r < R; ++r) {
      ok = column<M>(static_cast<const uint8_t*>(masks), static_cast<const int32_t*>(loads),
                     static_cast<const int32_t*>(free), static_cast<const int32_t*>(fleet),
                     static_cast<const int32_t*>(cap), N, R, row, r) && ok;
    }
    o[row] = ok ? 1 : 0;
  }
  return 0;
}

#endif

}  // namespace

extern "C" {

// loads and free (N, R) int32, fleet and cap (R,) int32, masks (S, N)
// uint8, all row-major and contiguous; out (N,) or (S,) bool is written.
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int disrupt_prefix_launch(const void* loads, const void* free, const void* fleet, const void* cap,
                          int64_t N, int64_t R, void* out, void* stream) {
  return launch<Mode::Prefix>(nullptr, loads, free, fleet, cap, N, N, R, out, stream);
}

int disrupt_subsets_launch(const void* masks, const void* loads, const void* free,
                           const void* fleet, const void* cap, int64_t S, int64_t N, int64_t R,
                           void* out, void* stream) {
  return launch<Mode::Subset>(masks, loads, free, fleet, cap, S, N, R, out, stream);
}

int disrupt_singles_launch(const void* loads, const void* free, const void* fleet, const void* cap,
                           int64_t N, int64_t R, void* out, void* stream) {
  return launch<Mode::Single>(nullptr, loads, free, fleet, cap, N, N, R, out, stream);
}
#else
// The same column functions on the CPU, host pointers; out holds 0 or 1.
int disrupt_prefix_host(const void* loads, const void* free, const void* fleet, const void* cap,
                        int64_t N, int64_t R, void* out) {
  return run_host<Mode::Prefix>(nullptr, loads, free, fleet, cap, N, N, R, out);
}

int disrupt_subsets_host(const void* masks, const void* loads, const void* free,
                         const void* fleet, const void* cap, int64_t S, int64_t N, int64_t R,
                         void* out) {
  return run_host<Mode::Subset>(masks, loads, free, fleet, cap, S, N, R, out);
}

int disrupt_singles_host(const void* loads, const void* free, const void* fleet, const void* cap,
                         int64_t N, int64_t R, void* out) {
  return run_host<Mode::Single>(nullptr, loads, free, fleet, cap, N, N, R, out);
}
#endif

}  // extern "C"
