// First-fit of pods onto existing nodes on Hopper (sm_90a).
//
// Replaces karpenter_core_tpu/solver/pack.py::pack_existing (a lax.scan
// over the pods): each pod, in order, takes the first node, in the fixed
// node order, that its signature admits (compat[sig] row) and whose free
// capacity holds its request on every axis; that node's free capacity
// drops by the request. A pod that fits nowhere gets -1 and changes
// nothing. Outputs: the node index per pod and the remaining free (M, R).
//
// Design: one block for the whole scan (each pod depends on every
// earlier pod's update, so there is nothing to spread over blocks), one
// barrier per pod. Thread t of T owns nodes t, t + T, ...: only it reads
// or writes their free rows and compat bits, so neither needs a barrier.
// Three paths, by shape:
//   - register paths (S <= 64): the thread's nodes' free rows and
//     signature masks (bit s: signature s admits the node, as two 32-bit
//     halves) are staged once into registers, beside the pod's request
//     row, unrolled to 4 axes (8 nodes a thread, M <= 4,096) or to 16
//     axes (4 nodes a thread, M <= 2,048: the stateful existing pass's
//     host-port and CSI-driver columns), zero past R. Each thread checks
//     all its nodes by predicated selects, no branch. T is as small as
//     that allows (128 for 1,000 nodes on the narrow path, 256 on the
//     wide): every warp runs the whole per-pod instruction stream, so
//     fewer warps spend fewer instruction slots on the same checks;
//   - the generic path (wider rows, more nodes, more signatures): one
//     node a thread up to 1,024 nodes, the free rows worked in place in
//     the output, the compat bytes read in place, the thread's first
//     admissible node with room by a walk that stops there.
// Pods come in chunks (256 signature ids and request rows, fewer for wide
// rows), copied by cp.async into a double buffer in shared memory while
// the chunk before is packed. Per pod a warp min (__reduce_min_sync) of
// the threads' first fits goes to a shared array double-buffered by the
// pod's parity, and after the one barrier every thread takes the least
// of the warp minima (one 16-byte load up to four warps, else a second
// warp min); the owner of the winning node subtracts the request, and
// thread 0 writes the pod's node.
//
// Bound. Bytes, as chip_smoke.py counts them: requests and signature ids
// read once, the compat matrix once, free read and written once, assign
// written once: P * (R + 1) * 4 + S * M + 2 * M * R * 4 + P * 4.
// Operations: the node checks this data needs (each pod walks the nodes
// up to the one it takes, all of them when it fits none, R compares
// each), microseconds of the card's time. Neither bounds it: each pod
// waits for the previous pod's update, so the time is P times one step,
// the chain of the thread's node checks (run by every warp, so with many
// warps the instruction throughput, not the latency, bounds the step,
// hence the small blocks), a warp min, a shared store, the barrier and
// the read of the warp minima, and the owner's update. On phase 12's
// first-fit (1,000 nodes, R = 3, S = 4, T = 128) it takes about 0.215
// us, some 425 cycles at the 1,980 MHz maximum SM clock; the wide path
// about 0.43 us at 1,000 nodes and R = 5 to 12, the generic path 0.8 to
// 3 us (chip_smoke.py's step_us and its synthetic cases, on an H100
// 80GB HBM3 at 700 W).
//
// Host build. The thread work (stage, thread_first_fit, node_take,
// unstage) is __host__ __device__; compiled by g++ as C++ this file
// exports pack_existing_host: the same thread functions on the same
// node types, the warp and block minima loops over the threads
// (tests/test_torch_pack_device.py).

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

#ifdef __CUDA_ARCH__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

namespace {

constexpr int THREADS = 1024;     // the largest block
constexpr int MAX_WARPS = THREADS / 32;
constexpr int MASK_S = 64;        // signatures a 64-bit mask holds
// The register paths: rows of up to 4 axes, 8 nodes a thread (M <=
// 4,096), or of up to 16 axes, 4 nodes a thread (M <= 2,048), in
// blocks of at most REG_THREADS threads (128 registers a thread).
constexpr int REG_THREADS = 512;
constexpr int NARROW_NODES = 8;
constexpr int NARROW_AXES = 4;
constexpr int WIDE_NODES = 4;
constexpr int WIDE_AXES = 16;
constexpr int CHUNK = 256;        // pods per prefetched chunk, fewer for wide rows
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// Thread t's nodes t + i * T, i < NPT, in registers: free rows of R <= N
// axes (loops unrolled to N; axes past R hold 0, as the request row
// does, so they always fit) and signature masks as two 32-bit halves,
// 0 past the last node so it admits nothing.
template <int NPT, int N>
struct RegNodes {
  int32_t v[NPT][N];
  uint32_t lo[NPT], hi[NPT];
  int t, T;
  HD int node(int i) const { return i * T + t; }
};

// Thread t's nodes t + i * T, i < n, in place: node m's free row is row
// m of the output, its signatures the (S, M) compat bytes' column m.
struct MemNodes {
  int32_t* free;
  const uint8_t* compat;
  int M, R, t, T, n;
  HD int node(int i) const { return i * T + t; }
  HD int32_t* row(int i) const { return free + static_cast<int64_t>(node(i)) * R; }
  HD bool admits(int i, int sig) const { return compat[static_cast<int64_t>(sig) * M + node(i)] != 0; }
};

// node m's signatures as bits (S <= 64)
HD uint64_t signature_mask(const uint8_t* compat, int S, int M, int m) {
  uint64_t mask = 0;
  for (int s = 0; s < S; ++s) mask |= static_cast<uint64_t>(compat[static_cast<int64_t>(s) * M + m] != 0) << s;
  return mask;
}

template <int NPT, int N>
HD void stage(RegNodes<NPT, N>& nd, int t, int T, int M, int R, int S, const int32_t* free_in,
              const uint8_t* compat, int32_t*) {
  nd.t = t;
  nd.T = T;
  UNROLL
  for (int i = 0; i < NPT; ++i) {
    const int m = nd.node(i);
    const uint64_t mask = m < M ? signature_mask(compat, S, M, m) : 0;
    nd.lo[i] = static_cast<uint32_t>(mask);
    nd.hi[i] = static_cast<uint32_t>(mask >> 32);
    UNROLL
    for (int r = 0; r < N; ++r) nd.v[i][r] = m < M && r < R ? free_in[static_cast<int64_t>(m) * R + r] : 0;
  }
}

// the thread's free rows copied to the output, where it works on them
HD void stage(MemNodes& nd, int t, int T, int M, int R, int, const int32_t* free_in, const uint8_t* compat,
              int32_t* free_out) {
  nd.free = free_out;
  nd.compat = compat;
  nd.M = M;
  nd.R = R;
  nd.t = t;
  nd.T = T;
  nd.n = t < M ? (M - 1 - t) / T + 1 : 0;
  for (int i = 0; i < nd.n; ++i) {
    for (int r = 0; r < R; ++r) nd.row(i)[r] = free_in[static_cast<int64_t>(nd.node(i)) * R + r];
  }
}

template <int NPT, int N>
HD void unstage(const RegNodes<NPT, N>& nd, int M, int R, int32_t* free_out) {
  UNROLL
  for (int i = 0; i < NPT; ++i) {
    UNROLL
    for (int r = 0; r < N; ++r) {
      if (nd.node(i) < M && r < R) free_out[static_cast<int64_t>(nd.node(i)) * R + r] = nd.v[i][r];
    }
  }
}

HD void unstage(const MemNodes&, int, int, int32_t*) {}  // worked in place

// The pod's request: registers on the register path (zero past R), the
// chunk's row in place otherwise.
template <class Nodes>
struct Request {
  const int32_t* p;
  HD void load(const int32_t* row, int) { p = row; }
  HD int32_t operator[](int r) const { return p[r]; }
};
template <int NPT, int N>
struct Request<RegNodes<NPT, N>> {
  int32_t v[N];
  HD void load(const int32_t* row, int R) {
    UNROLL
    for (int r = 0; r < N; ++r) v[r] = r < R ? row[r] : 0;
  }
  HD int32_t operator[](int r) const { return v[r]; }
};

// The thread's first admissible node with room for the pod (its nodes
// ascend with i), INT_MAX if none: on registers every node is checked
// and the lowest hit selected, without a branch.
template <int NPT, int N>
HD int thread_first_fit(const RegNodes<NPT, N>& nd, int sig, const Request<RegNodes<NPT, N>>& rq, int) {
  const uint32_t bit = 1u << (sig & 31);
  const bool high = sig >= 32;
  int first = INT_MAX;
  UNROLL
  for (int i = NPT - 1; i >= 0; --i) {
    bool ok = ((high ? nd.hi[i] : nd.lo[i]) & bit) != 0;
    UNROLL
    for (int r = 0; r < N; ++r) ok &= nd.v[i][r] >= rq[r];
    first = ok ? nd.node(i) : first;
  }
  return first;
}

HD int thread_first_fit(const MemNodes& nd, int sig, const Request<MemNodes>& rq, int R) {
  for (int i = 0; i < nd.n; ++i) {
    if (!nd.admits(i, sig)) continue;
    const int32_t* f = nd.row(i);
    bool ok = true;
    for (int r = 0; r < R; ++r) ok &= f[r] >= rq[r];
    if (ok) return nd.node(i);
  }
  return INT_MAX;
}

// node i's row less the request: a select per register, no branch
template <int NPT, int N>
HD void node_take(RegNodes<NPT, N>& nd, int i, const Request<RegNodes<NPT, N>>& rq, int) {
  UNROLL
  for (int ii = 0; ii < NPT; ++ii) {
    UNROLL
    for (int r = 0; r < N; ++r) nd.v[ii][r] -= ii == i ? rq[r] : 0;
  }
}

HD void node_take(MemNodes& nd, int i, const Request<MemNodes>& rq, int R) {
  for (int r = 0; r < R; ++r) nd.row(i)[r] -= rq[r];
}

// one int32 into shared memory, asynchronously on the card
HD void copy_async(int32_t* dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// pods [base, base + n): signature ids into buf[0, chunk), request rows
// after them, spread over `threads` callers (the host: one does all)
HD void fetch_pods(int32_t* buf, int chunk, const int32_t* req, const int32_t* sig_ids, int base, int n, int R,
                   int t, int threads) {
  for (int i = t; i < n; i += threads) copy_async(buf + i, sig_ids + base + i);
  const int32_t* src = req + static_cast<int64_t>(base) * R;
  for (int i = t; i < n * R; i += threads) copy_async(buf + chunk + i, src + i);
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// The path and the block from the shapes: with S <= 64 the narrow
// register path up to 4 axes and 4,096 nodes, the wide one up to 16
// axes and 2,048 nodes, else the generic one (a node a thread up to
// 1,024 nodes); the block as small as its nodes per thread allow
// (warps that find nothing still issue every per-pod instruction). The
// pod buffers take at most half the budget: 256 pods a chunk up to R =
// 49, fewer for wider rows.
enum class Path { Narrow, Wide, Generic };

struct Layout {
  Path path;
  int threads, chunk;
  size_t smem;
};

Layout plan(int64_t R, int64_t S, int64_t M) {
  Layout L{};
  const bool masks = S <= MASK_S;
  if (masks && R <= NARROW_AXES && M <= static_cast<int64_t>(REG_THREADS) * NARROW_NODES) {
    L.path = Path::Narrow;
  } else if (masks && R <= WIDE_AXES && M <= static_cast<int64_t>(REG_THREADS) * WIDE_NODES) {
    L.path = Path::Wide;
  } else {
    L.path = Path::Generic;
  }
  const int64_t per_thread = L.path == Path::Narrow ? NARROW_NODES : L.path == Path::Wide ? WIDE_NODES : 1;
  for (L.threads = 32; L.threads < THREADS && L.threads * per_thread < M;) L.threads *= 2;
  L.chunk = CHUNK;
  while (L.chunk > 1 && static_cast<size_t>(2 * L.chunk) * (R + 1) * 4 > SMEM_BUDGET / 2) L.chunk /= 2;
  L.smem = static_cast<size_t>(2 * L.chunk) * (R + 1) * 4;
  return L;
}

#ifdef __CUDACC__
// the least of the block's warp minima, read by every thread: up to
// four warps one 16-byte load of the parity's row (entries past the
// block's warps hold INT_MAX) and three mins; more, lane i reads
// minimum i and the warp reduces them
__device__ __forceinline__ int block_min(const int* row, int warps, int lane) {
  if (warps <= 4) {
    const int4 w = *reinterpret_cast<const int4*>(row);
    return min(min(w.x, w.y), min(w.z, w.w));
  }
  return __reduce_min_sync(FULL, row[lane]);
}

template <class Nodes>
__device__ void scan_pods(Nodes& nd, int32_t* pods, int chunk, const int32_t* __restrict__ req,
                          const int32_t* __restrict__ sig_ids, int P, int R, int M, int32_t* __restrict__ assign) {
  __shared__ __align__(16) int warp_min[2][MAX_WARPS];
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5, warps = T >> 5;
  const int log_t = __ffs(T) - 1;  // T is a power of two
  for (int i = t; i < 2 * MAX_WARPS; i += T) warp_min[i / MAX_WARPS][i % MAX_WARPS] = INT_MAX;
  fetch_pods(pods, chunk, req, sig_ids, 0, P < chunk ? P : chunk, R, t, T);
  for (int base = 0, p = 0; base < P; base += chunk) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the chunk landed and the other buffer was read
    const int32_t* cur = pods + ((base / chunk) & 1) * chunk * (R + 1);
    if (base + chunk < P) {
      const int n_next = P - base - chunk < chunk ? P - base - chunk : chunk;
      fetch_pods(pods + (((base / chunk) + 1) & 1) * chunk * (R + 1), chunk, req, sig_ids, base + chunk,
                 n_next, R, t, T);
    }
    const int n = P - base < chunk ? P - base : chunk;
    for (int j = 0; j < n; ++j, ++p) {
      Request<Nodes> rq;
      rq.load(cur + chunk + j * R, R);
      const int cand = __reduce_min_sync(FULL, thread_first_fit(nd, cur[j], rq, R));
      if (lane == 0) warp_min[p & 1][warp] = cand;
      __syncthreads();
      const int best = block_min(warp_min[p & 1], warps, lane);
      if (best < M && (best & (T - 1)) == t) node_take(nd, best >> log_t, rq, R);
      if (t == 0) assign[p] = best < M ? best : -1;
    }
  }
}

// The scan on `Nodes`, in a block of at most MAX_T threads (the
// register path's bound leaves its rows 128 registers a thread).
template <class Nodes, int MAX_T>
__global__ void __launch_bounds__(MAX_T)
    pack_existing_kernel(const int32_t* __restrict__ req, const int32_t* __restrict__ sig_ids,
                         const uint8_t* __restrict__ compat, const int32_t* __restrict__ free_in, int P, int R,
                         int S, int M, int chunk, int32_t* __restrict__ free_out, int32_t* __restrict__ assign) {
  extern __shared__ __align__(16) unsigned char smem[];
  Nodes nd;
  stage(nd, threadIdx.x, blockDim.x, M, R, S, free_in, compat, free_out);
  scan_pods(nd, reinterpret_cast<int32_t*>(smem), chunk, req, sig_ids, P, R, M, assign);
  unstage(nd, M, R, free_out);
}

template <class Nodes, int MAX_T>
int launch(const Layout& L, const int32_t* rq, const int32_t* sg, const uint8_t* cm, const int32_t* fi, int P,
           int R, int S, int M, int32_t* fo, int32_t* as, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(pack_existing_kernel<Nodes, MAX_T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_existing_kernel<Nodes, MAX_T><<<1, L.threads, L.smem, st>>>(rq, sg, cm, fi, P, R, S, M, L.chunk, fo, as);
  return static_cast<int>(cudaGetLastError());
}
#else
// The scan on the host: per pod, every thread's first fit, the warp
// minima, the block minimum, the owner's take, in the kernel's order.
template <class Nodes>
void scan_pods_host(std::vector<Nodes>& nd, int chunk, const int32_t* req, const int32_t* sig_ids, int P, int R,
                    int M, int32_t* assign) {
  const int T = static_cast<int>(nd.size());
  std::vector<int32_t> buf(static_cast<size_t>(chunk) * (R + 1));
  for (int base = 0, p = 0; base < P; base += chunk) {
    const int n = P - base < chunk ? P - base : chunk;
    fetch_pods(buf.data(), chunk, req, sig_ids, base, n, R, 0, 1);
    for (int j = 0; j < n; ++j, ++p) {
      Request<Nodes> rq;
      rq.load(buf.data() + chunk + j * R, R);
      int warp_min[MAX_WARPS];
      for (int w = 0; w < T / 32; ++w) {
        warp_min[w] = INT_MAX;
        for (int lane = 0; lane < 32; ++lane) {
          const int cand = thread_first_fit(nd[w * 32 + lane], buf[j], rq, R);
          warp_min[w] = cand < warp_min[w] ? cand : warp_min[w];
        }
      }
      int best = INT_MAX;
      for (int w = 0; w < T / 32; ++w) best = warp_min[w] < best ? warp_min[w] : best;
      if (best < M) node_take(nd[best % T], best / T, rq, R);
      assign[p] = best < M ? best : -1;
    }
  }
}

template <class Nodes>
void run_host(std::vector<Nodes>& nd, const Layout& L, const int32_t* rq, const int32_t* sg, const uint8_t* cm,
              const int32_t* fi, int P, int R, int S, int M, int32_t* fo, int32_t* assign) {
  for (int t = 0; t < L.threads; ++t) stage(nd[t], t, L.threads, M, R, S, fi, cm, fo);
  scan_pods_host(nd, L.chunk, rq, sg, P, R, M, assign);
  for (int t = 0; t < L.threads; ++t) unstage(nd[t], M, R, fo);
}
#endif

bool bad_args(int64_t P, int64_t R, int64_t S, int64_t M) {
  return P < 0 || R < 1 || S < 0 || M < 0 || (P > 0 && (S < 1 || M < 1)) || P > INT32_MAX ||
         M > INT32_MAX || R > INT32_MAX / THREADS || plan(R, S, M).smem > SMEM_BUDGET / 2;
}

}  // namespace

extern "C" {

// req (P, R) int32, sig_ids (P,) int32 in [0, S), compat (S, M) uint8,
// free_in (M, R) int32, all row-major and contiguous; free_out (M, R)
// int32 (may not alias free_in) and assign (P,) int32 are written. The
// pod buffers (two chunks of ids and request rows, at least one pod
// each) must fit 100 KB, so R <= 12,799. Returns an error code without
// running when the arguments break that contract (sig_ids are the
// caller's to check).
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int pack_existing_launch(const void* req, const void* sig_ids, const void* compat,
                         const void* free_in, int64_t P, int64_t R, int64_t S, int64_t M,
                         void* free_out, void* assign, void* stream) {
  if (bad_args(P, R, S, M)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = plan(R, S, M);
  auto* rq = static_cast<const int32_t*>(req);
  auto* sg = static_cast<const int32_t*>(sig_ids);
  auto* cm = static_cast<const uint8_t*>(compat);
  auto* fi = static_cast<const int32_t*>(free_in);
  auto* fo = static_cast<int32_t*>(free_out);
  auto* as = static_cast<int32_t*>(assign);
  auto st = static_cast<cudaStream_t>(stream);
  switch (L.path) {
    case Path::Narrow:
      return launch<RegNodes<NARROW_NODES, NARROW_AXES>, REG_THREADS>(L, rq, sg, cm, fi, P, R, S, M, fo, as, st);
    case Path::Wide:
      return launch<RegNodes<WIDE_NODES, WIDE_AXES>, REG_THREADS>(L, rq, sg, cm, fi, P, R, S, M, fo, as, st);
    default:
      return launch<MemNodes, THREADS>(L, rq, sg, cm, fi, P, R, S, M, fo, as, st);
  }
}
#else
// The same step on the CPU, host pointers, same layout as the launch.
int pack_existing_host(const void* req, const void* sig_ids, const void* compat,
                       const void* free_in, int64_t P, int64_t R, int64_t S, int64_t M,
                       void* free_out, void* assign) {
  if (bad_args(P, R, S, M)) return 1;
  auto* rq = static_cast<const int32_t*>(req);
  auto* sg = static_cast<const int32_t*>(sig_ids);
  auto* cm = static_cast<const uint8_t*>(compat);
  auto* fi = static_cast<const int32_t*>(free_in);
  auto* fo = static_cast<int32_t*>(free_out);
  auto* as = static_cast<int32_t*>(assign);
  for (int64_t p = 0; p < P; ++p) {
    if (sg[p] < 0 || sg[p] >= S) return 1;
  }
  const Layout L = plan(R, S, M);
  if (L.path == Path::Narrow) {
    std::vector<RegNodes<NARROW_NODES, NARROW_AXES>> nd(L.threads);
    run_host(nd, L, rq, sg, cm, fi, P, R, S, M, fo, as);
  } else if (L.path == Path::Wide) {
    std::vector<RegNodes<WIDE_NODES, WIDE_AXES>> nd(L.threads);
    run_host(nd, L, rq, sg, cm, fi, P, R, S, M, fo, as);
  } else {
    std::vector<MemNodes> nd(L.threads);
    run_host(nd, L, rq, sg, cm, fi, P, R, S, M, fo, as);
  }
  return 0;
}
#endif

}  // extern "C"
