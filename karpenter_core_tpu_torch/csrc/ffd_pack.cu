// K-open first-fit-decreasing pack of many jobs on Hopper (sm_90a).
//
// Replaces karpenter_core_tpu/solver/pack.py::ffd_pack (a lax.scan over
// the pods of one job) and ::ffd_pack_batched (the jax.vmap of it over a
// solve's jobs): one thread block per job, every job of a size class in
// one launch, so the grid is the vmap and the pod loop inside the block
// is the scan.
//
// What it computes, per job (requests (P, R) sorted descending on the
// primary axis, frontier (F, R) the Pareto frontier of the job's viable
// allocatable vectors, a per-node pod cap), exactly as the reference's
// step does:
//   - K open slots, each with a usage row, a pod count and a node id
//     (-1: closed). Slot k fits the pod when some frontier row f has
//     usage[k] <= frontier[f] - req on every axis (int32, in that form:
//     closed slots hold INT_INF usage and must not overflow), the slot
//     is open and its count is under the cap;
//   - the pod goes to the fitting slot of least key count + id * 1e-7
//     (float32, first index on ties, as jnp.argmin); the key is computed
//     with __fmul_rn / __fadd_rn so nvcc cannot contract it into an FMA:
//     near-equal keys must round as the reference's separate multiply
//     and add do;
//   - otherwise, if some frontier row holds the pod alone, a new node
//     opens in the first closed slot, or, with every slot open, in the
//     slot of least primary-axis headroom (frontier max - usage, first
//     index on ties), which is closed for good;
//   - otherwise the pod is unschedulable (-1) and touches nothing. A
//     padding pod (requests above the frontier max) is such a pod, so
//     the kernel stops at each job's real pod count.
// Outputs: node id per pod (-1 past the job's pods) and node count per
// job.
//
// Design. The fit test is the only wide step: (K + 1) x F x R compares
// (item K is the fresh node: usage zero). Warp w takes items w, w + 8,
// ...; its lanes walk the frontier rows and __any_sync ends the walk at
// the first fitting row. Slot state (usage rows, counts, ids) and, when
// it fits, the job's frontier live in shared memory. Thread 0 then makes
// the choice and the update (K = 16 keys and headrooms: a serial walk is
// shorter than a reduction tree with its barriers).
//
// Bound. Bytes: the job's requests and frontier read once, the ids
// written once: (P + F) * R * 4 + P * 4 per job. Operations: up to
// P * (K + 1) * F * R int32 compares. Neither bounds it: each pod waits
// for the previous pod's update, so the time is P times the latency of
// one step (two block barriers, a shared-memory walk of the frontier
// and a 16-slot serial choice), and jobs run side by side on the SMs.
// That dependency makes the bytes/operations bound a loose one.
//
// Host build. row_fits and choose_and_update are __host__ __device__.
// Compiled by g++ as C++ (no __CUDACC__), this file exports
// ffd_pack_host instead of the launch: the same step, thread work run in
// sequence, so the CPU tests hold it to the reference
// (tests/test_torch_pack_device.py).

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
#define F_INF __int_as_float(0x7f800000)
#else
#define FMUL(a, b) ((a) * (b))
#define FADD(a, b) ((a) + (b))
#define F_INF INFINITY
#endif

namespace {

constexpr int MAX_K = 32;
constexpr int32_t INT_INF = 2147483647;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// dynamic shared memory a block may take (of the H100's 227 KB)
constexpr size_t SMEM_BUDGET = 200 * 1024;

struct Slots {
  int32_t count[MAX_K];
  int32_t node_id[MAX_K];
  int32_t fit[MAX_K + 1];  // [K]: the pod fits a fresh node
  int32_t next_id;
};

// usage + req fits frontier row `front`, in the overflow-safe form
// usage <= front - req (usage may be INT_INF; front and req are < 2^30)
HD bool row_fits(const int32_t* usage, const int32_t* front, const int32_t* req, int R) {
  for (int r = 0; r < R; ++r) {
    if (usage[r] > front[r] - req[r]) return false;
  }
  return true;
}

HD bool slot_open(const Slots& s, int k, int32_t cap) {
  return s.node_id[k] >= 0 && s.count[k] < cap;
}

// The step after the fit test (s.fit filled for the open, uncapped
// slots and the fresh node): choose the slot, update it, return the
// pod's node id or -1.
HD int32_t choose_and_update(int32_t* usage, Slots& s, const int32_t* req, int R, int K,
                             int32_t cap, int32_t fmax0) {
  int k_star = 0;
  float best = F_INF;
  int k_evict = 0;
  int32_t least = INT_INF;
  int first_closed = -1;
  for (int k = 0; k < K; ++k) {
    const bool active = s.node_id[k] >= 0;
    const bool fit = s.fit[k] && active && s.count[k] < cap;
    const float key = fit ? FADD(static_cast<float>(s.count[k]),
                                 FMUL(static_cast<float>(s.node_id[k]), 1e-7f))
                          : F_INF;
    if (key < best) {  // strict: the first index wins ties, as jnp.argmin
      best = key;
      k_star = k;
    }
    const int32_t head = active ? fmax0 - usage[k * R] : INT_INF;
    if (head < least) {
      least = head;
      k_evict = k;
    }
    if (!active && first_closed < 0) first_closed = k;
  }
  const bool any_fit = s.fit[k_star] && s.node_id[k_star] >= 0 && s.count[k_star] < cap;
  int32_t* row;
  if (any_fit) {
    row = usage + k_star * R;
    for (int r = 0; r < R; ++r) row[r] += req[r];
    s.count[k_star] += 1;
    return s.node_id[k_star];
  }
  if (!s.fit[K]) return -1;
  const int k_new = first_closed >= 0 ? first_closed : k_evict;
  row = usage + k_new * R;
  for (int r = 0; r < R; ++r) row[r] = req[r];
  s.count[k_new] = 1;
  s.node_id[k_new] = s.next_id;
  s.next_id += 1;
  return s.node_id[k_new];
}

HD int32_t frontier_max0(const int32_t* front, int F, int R) {
  int32_t m = front[0];
  for (int f = 1; f < F; ++f) m = front[f * R] > m ? front[f * R] : m;
  return m;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(THREADS)
    ffd_pack_kernel(const int32_t* __restrict__ req, const int32_t* __restrict__ front,
                    const int32_t* __restrict__ caps, const int32_t* __restrict__ n_pods,
                    int P_ld, int F, int R, int K, int front_in_smem, int32_t* __restrict__ node_ids,
                    int32_t* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  __shared__ Slots s;
  __shared__ int32_t fmax0;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* jreq = req + static_cast<int64_t>(g) * P_ld * R;
  const int32_t* gfront = front + static_cast<int64_t>(g) * F * R;
  int32_t* out = node_ids + static_cast<int64_t>(g) * P_ld;
  const int P = n_pods[g];
  const int32_t cap = caps[g];
  int32_t* usage = smem;  // (K + 1) x R; row K stays zero (the fresh node)
  int32_t* sfront = smem + (K + 1) * R;
  for (int i = tid; i < (K + 1) * R; i += THREADS) usage[i] = i < K * R ? INT_INF : 0;
  if (front_in_smem) {
    for (int i = tid; i < F * R; i += THREADS) sfront[i] = gfront[i];
  }
  if (tid < K) {
    s.count[tid] = 0;
    s.node_id[tid] = -1;
  }
  if (tid == 0) s.next_id = 0;
  for (int p = P + tid; p < P_ld; p += THREADS) out[p] = -1;
  __syncthreads();
  const int32_t* fr = front_in_smem ? sfront : gfront;
  if (tid == 0) fmax0 = frontier_max0(fr, F, R);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    const int32_t* rq = jreq + static_cast<int64_t>(p) * R;
    for (int k = warp; k <= K; k += NWARPS) {
      bool fit = false;
      if (k == K || slot_open(s, k, cap)) {
        const int32_t* u = usage + k * R;
        for (int base = 0; base < F; base += 32) {
          const int f = base + lane;
          const bool hit = f < F && row_fits(u, fr + f * R, rq, R);
          if (__any_sync(0xffffffffu, hit)) {
            fit = true;
            break;
          }
        }
      }
      if (lane == 0) s.fit[k] = fit;
    }
    __syncthreads();
    if (tid == 0) out[p] = choose_and_update(usage, s, rq, R, K, cap, fmax0);
    __syncthreads();
  }
  if (tid == 0) counts[g] = s.next_id;
}
#else
void pack_job_host(const int32_t* jreq, const int32_t* fr, int P, int P_ld, int F, int R, int K,
                   int32_t cap, int32_t* out, int32_t* count) {
  std::vector<int32_t> usage((K + 1) * R);
  for (int i = 0; i < (K + 1) * R; ++i) usage[i] = i < K * R ? INT_INF : 0;
  Slots s;
  for (int k = 0; k < K; ++k) {
    s.count[k] = 0;
    s.node_id[k] = -1;
  }
  s.next_id = 0;
  for (int p = P; p < P_ld; ++p) out[p] = -1;
  const int32_t fmax0 = frontier_max0(fr, F, R);
  for (int p = 0; p < P; ++p) {
    const int32_t* rq = jreq + static_cast<int64_t>(p) * R;
    for (int k = 0; k <= K; ++k) {
      bool fit = false;
      if (k == K || slot_open(s, k, cap)) {
        for (int f = 0; f < F && !fit; ++f) fit = row_fits(usage.data() + k * R, fr + f * R, rq, R);
      }
      s.fit[k] = fit;
    }
    out[p] = choose_and_update(usage.data(), s, rq, R, K, cap, fmax0);
  }
  *count = s.next_id;
}
#endif

bool bad_args(int G, int P_ld, int F, int R, int K) {
  return G < 0 || P_ld < 0 || F < 1 || R < 1 || K < 1 || K > MAX_K;
}

}  // namespace

extern "C" {

// req (G, P_ld, R), front (G, F, R) int32 row-major and contiguous;
// caps (G,) and n_pods (G,) int32 (n_pods[g] <= P_ld: the job's real
// pods, padding past it is never read); node_ids (G, P_ld) int32, -1
// past n_pods; counts (G,) int32. Returns an error code without running
// when the arguments break that contract.
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int ffd_pack_launch(const void* req, const void* front, const void* caps, const void* n_pods,
                    int64_t G, int64_t P_ld, int64_t F, int64_t R, int64_t K, void* node_ids,
                    void* counts, void* stream) {
  if (bad_args(G, P_ld, F, R, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  const size_t usage_bytes = static_cast<size_t>(K + 1) * R * 4;
  const size_t front_bytes = static_cast<size_t>(F) * R * 4;
  const int in_smem = usage_bytes + front_bytes <= SMEM_BUDGET;
  const size_t smem = usage_bytes + (in_smem ? front_bytes : 0);
  if (smem > SMEM_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ffd_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffd_pack_kernel<<<static_cast<unsigned>(G), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(req), static_cast<const int32_t*>(front),
      static_cast<const int32_t*>(caps), static_cast<const int32_t*>(n_pods),
      static_cast<int>(P_ld), static_cast<int>(F), static_cast<int>(R), static_cast<int>(K), in_smem,
      static_cast<int32_t*>(node_ids), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same step on the CPU, host pointers, same layout as the launch.
int ffd_pack_host(const void* req, const void* front, const void* caps, const void* n_pods,
                  int64_t G, int64_t P_ld, int64_t F, int64_t R, int64_t K, void* node_ids,
                  void* counts) {
  if (bad_args(G, P_ld, F, R, K)) return 1;
  const int32_t* rq = static_cast<const int32_t*>(req);
  const int32_t* fr = static_cast<const int32_t*>(front);
  const int32_t* cp = static_cast<const int32_t*>(caps);
  const int32_t* np = static_cast<const int32_t*>(n_pods);
  int32_t* out = static_cast<int32_t*>(node_ids);
  int32_t* cnt = static_cast<int32_t*>(counts);
  for (int64_t g = 0; g < G; ++g) {
    if (np[g] < 0 || np[g] > P_ld) return 1;
    pack_job_host(rq + g * P_ld * R, fr + g * F * R, np[g], P_ld, F, R, K, cp[g], out + g * P_ld,
                  cnt + g);
  }
  return 0;
}
#endif

}  // extern "C"
