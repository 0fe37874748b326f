// First-fit of pods onto existing nodes on Hopper (sm_90a).
//
// Replaces karpenter_core_tpu/solver/pack.py::pack_existing (a lax.scan
// over the pods): each pod, in order, takes the first node, in the fixed
// node order, that its signature admits (compat[sig] row) and whose free
// capacity holds its request on every axis; that node's free capacity
// drops by the request. A pod that fits nowhere gets -1 and changes
// nothing. Outputs: the node index per pod and the remaining free (M, R).
//
// Design. One thread block of 1024 threads for the whole scan: each pod
// depends on every earlier pod's update, so there is nothing to spread
// over blocks. Per pod, thread i walks nodes i, i + 1024, ... and stops
// at its first admissible node with room; a warp min (__reduce_min_sync)
// and a 32-entry shared-memory pass give the first such node of all, and
// thread 0 takes it. Free capacity lives in shared memory when it fits
// (1,000 nodes x 8 axes is 32 KB), else in the output buffer.
//
// Bound. Bytes: requests, signature ids and the compat rows the pods use
// read once, free read and written once: P * (R + 1) * 4 + S * M +
// 2 * M * R * 4. Operations: up to P * M * R int32 compares. Neither
// bounds it: each pod waits for the previous pod's update, so the time
// is P times one step's latency (two block barriers and a walk of
// ceil(M / 1024) nodes per thread); the bytes/operations bound is loose.
//
// Host build. node_fits and take are __host__ __device__; compiled by
// g++ as C++ this file exports pack_existing_host, the same step with
// the thread walk run in node order (tests/test_torch_pack_device.py).

#include <climits>
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif

namespace {

constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr size_t SMEM_BUDGET = 200 * 1024;

HD bool node_fits(const int32_t* free_m, const int32_t* req, int R) {
  for (int r = 0; r < R; ++r) {
    if (free_m[r] < req[r]) return false;
  }
  return true;
}

HD void take(int32_t* free_m, const int32_t* req, int R) {
  for (int r = 0; r < R; ++r) free_m[r] -= req[r];
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(THREADS)
    pack_existing_kernel(const int32_t* __restrict__ req, const int32_t* __restrict__ sig_ids,
                         const uint8_t* __restrict__ compat, const int32_t* __restrict__ free_in,
                         int P, int R, int M, int free_in_smem, int32_t* __restrict__ free_out,
                         int32_t* __restrict__ assign) {
  extern __shared__ int32_t sfree[];
  __shared__ int warp_min[NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* fr = free_in_smem ? sfree : free_out;
  for (int i = tid; i < M * R; i += THREADS) fr[i] = free_in[i];
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    const int32_t* rq = req + static_cast<int64_t>(p) * R;
    const uint8_t* row = compat + static_cast<int64_t>(sig_ids[p]) * M;
    int cand = INT_MAX;
    for (int m = tid; m < M; m += THREADS) {
      if (row[m] && node_fits(fr + m * R, rq, R)) {
        cand = m;
        break;
      }
    }
    cand = __reduce_min_sync(0xffffffffu, cand);
    if (lane == 0) warp_min[warp] = cand;
    __syncthreads();
    if (tid == 0) {
      int best = warp_min[0];
      for (int w = 1; w < NWARPS; ++w) best = warp_min[w] < best ? warp_min[w] : best;
      if (best < M) take(fr + best * R, rq, R);
      assign[p] = best < M ? best : -1;
    }
    __syncthreads();
  }
  if (free_in_smem) {
    for (int i = tid; i < M * R; i += THREADS) free_out[i] = fr[i];
  }
}
#endif

bool bad_args(int64_t P, int64_t R, int64_t S, int64_t M) {
  return P < 0 || R < 1 || S < 0 || M < 0 || (P > 0 && (S < 1 || M < 1));
}

}  // namespace

extern "C" {

// req (P, R) int32, sig_ids (P,) int32 in [0, S), compat (S, M) uint8,
// free_in (M, R) int32, all row-major and contiguous; free_out (M, R)
// int32 (may not alias free_in) and assign (P,) int32 are written.
// Returns an error code without running when the arguments break that
// contract (sig_ids are the caller's to check).
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int pack_existing_launch(const void* req, const void* sig_ids, const void* compat,
                         const void* free_in, int64_t P, int64_t R, int64_t S, int64_t M,
                         void* free_out, void* assign, void* stream) {
  if (bad_args(P, R, S, M)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t free_bytes = static_cast<size_t>(M) * R * 4;
  const int in_smem = free_bytes <= SMEM_BUDGET;
  const size_t smem = in_smem ? free_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(pack_existing_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_existing_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(req), static_cast<const int32_t*>(sig_ids),
      static_cast<const uint8_t*>(compat), static_cast<const int32_t*>(free_in),
      static_cast<int>(P), static_cast<int>(R), static_cast<int>(M), in_smem,
      static_cast<int32_t*>(free_out), static_cast<int32_t*>(assign));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same step on the CPU, host pointers, same layout as the launch.
int pack_existing_host(const void* req, const void* sig_ids, const void* compat,
                       const void* free_in, int64_t P, int64_t R, int64_t S, int64_t M,
                       void* free_out, void* assign) {
  if (bad_args(P, R, S, M)) return 1;
  const int32_t* rq = static_cast<const int32_t*>(req);
  const int32_t* sg = static_cast<const int32_t*>(sig_ids);
  const uint8_t* cm = static_cast<const uint8_t*>(compat);
  int32_t* fr = static_cast<int32_t*>(free_out);
  int32_t* out = static_cast<int32_t*>(assign);
  for (int64_t i = 0; i < M * R; ++i) fr[i] = static_cast<const int32_t*>(free_in)[i];
  for (int64_t p = 0; p < P; ++p) {
    if (sg[p] < 0 || sg[p] >= S) return 1;
    const uint8_t* row = cm + static_cast<int64_t>(sg[p]) * M;
    int best = -1;
    for (int64_t m = 0; m < M && best < 0; ++m) {
      if (row[m] && node_fits(fr + m * R, rq + p * R, R)) best = static_cast<int>(m);
    }
    if (best >= 0) take(fr + best * R, rq + p * R, R);
    out[p] = best;
  }
  return 0;
}
#endif

}  // extern "C"
