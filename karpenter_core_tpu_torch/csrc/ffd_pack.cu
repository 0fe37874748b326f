// K-open first-fit-decreasing pack of many jobs on Hopper (sm_90a).
//
// Replaces karpenter_core_tpu/solver/pack.py::ffd_pack (a lax.scan over
// the pods of one job) and ::ffd_pack_batched (the jax.vmap of it over a
// solve's jobs): one warp per job, several jobs per block, every job of
// a size class in one launch, so the grid is the vmap and the pod loop
// inside the warp is the scan.
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
//     (float32, first slot index on ties, as jnp.argmin); the key is
//     computed with __fmul_rn / __fadd_rn so nvcc cannot contract it
//     into an FMA: near-equal keys must round as the reference's
//     separate multiply and add do;
//   - otherwise, if some frontier row holds the pod alone, a new node
//     opens in the first closed slot, or, with every slot open, in the
//     slot of least primary-axis headroom (frontier max - usage, first
//     index on ties), which is closed for good;
//   - otherwise the pod is unschedulable (-1) and touches nothing. A
//     padding pod (requests above the frontier max) is such a pod, so
//     the kernel stops at each job's real pod count and never reads the
//     padding.
// Outputs: node id per pod (-1 past the job's pods) and node count per
// job.
//
// Design: a warp-synchronous step. Lane k < K owns slot k: its usage row
// (in registers for R <= 4, unrolled to 4 axes, zero past R; else a
// column of the warp's shared block), its count, id and key (the
// float bits of count + id * 1e-7, recomputed only when the slot
// changes). Per pod each lane checks its own slot against frontier row 0
// (registers, beside the pod's request row, which is loaded while the
// step before runs) and the further rows (broadcast reads of shared
// memory), and bids its key or +inf. The choice takes no serial walk and
// no block barrier: __reduce_min_sync over the bids (keys are >= 0 or
// +inf, so their bits order as the floats do), then __ballot_sync(bid ==
// min): the lane with no lower bit set, the one __ffs would give, is the
// first slot index on ties. With no fit, the same ballot over the closed
// slots gives the first closed slot, or min + ballot over the int32
// headroom the slot to evict; the chosen lane updates its own registers
// by selects every lane runs, so the step does not branch, and writes
// the pod's node id to the warp's shared block. Requests come in chunks
// of 32 pods, copied by cp.async into a double buffer in shared memory
// while the chunk before is packed; when a chunk lands, lane i computes
// "some frontier row holds pod i alone" (the fresh-node test,
// independent of the slots) and one ballot keeps it for the 32 steps;
// the chunk's ids go out in one coalesced store. The frontier is staged
// in the warp's shared block when it fits (else read from device
// memory); jobs per block drop from 4 to 2 or 1 for wide R or large F.
//
// Bound. Bytes, as chip_smoke.py counts them: each real pod's requests
// read once, the frontiers once, the ids and counts written once:
// pods * R * 4 + G * F * R * 4 + pods * 4 + G * 8. Operations: up to
// pods * (K + 1) * F * R int32 compares (microseconds of the card's
// time). Neither bounds it: each pod waits for the previous pod's
// update, so a job takes P times the latency of one step, and jobs run
// side by side on the SMs. The step is a dependent chain: the slot's
// compares against frontier row 0 (registers), the bid, the warp min,
// the ballot and the lane test, the selects that update the chosen
// slot. On phase 12's jobs (R = 3, F = 1, K = 16) it takes about 0.185
// us, some 370 cycles at the 1,980 MHz maximum SM clock; with the usage
// rows in shared columns (R = 12, F = 3) about 1.1 us (chip_smoke.py's
// step_us and its synthetic case, on an H100 80GB HBM3 at 700 W).
//
// Host build. The lane work (lane_bid, lane_closed, lane_headroom,
// lane_take, lane_open, pod_fresh) is __host__ __device__. Compiled by
// g++ as C++ (no __CUDACC__), this file exports ffd_pack_host instead
// of the launch: the same lane functions on the same row types, each
// warp collective (min, ballot, first lane) a loop over the 32 lanes,
// so the CPU tests hold the step the card runs
// (tests/test_torch_pack_device.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif

#ifdef __CUDA_ARCH__
#define FMUL(a, b) __fmul_rn((a), (b))
#define FADD(a, b) __fadd_rn((a), (b))
#define UNROLL _Pragma("unroll")
#else
#define FMUL(a, b) ((a) * (b))
#define FADD(a, b) ((a) + (b))
#define UNROLL
#endif

namespace {

constexpr int MAX_K = 32;
constexpr int32_t INT_INF = 2147483647;
constexpr int WARPS = 4;   // jobs per block at most: one warp each
constexpr int CHUNK = 32;  // pods per prefetched chunk: one per lane
// dynamic shared memory a block may take (of the H100's 227 KB)
constexpr size_t SMEM_BUDGET = 200 * 1024;
constexpr uint32_t NO_BID = 0x7f800000u;  // +inf's bits: the slot does not fit
constexpr unsigned FULL = 0xffffffffu;

HD uint32_t float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// the id's share of a slot's key, id * 1e-7 in float32
HD float id_tie(int32_t id) { return FMUL(static_cast<float>(id), 1e-7f); }

// the float32 bits of a slot's key, count + id * 1e-7: fewest pods
// first, ties to the oldest node; >= 0, so the bits order as the values
HD uint32_t slot_key(int32_t count, float tie) { return float_bits(FADD(static_cast<float>(count), tie)); }

// A row of R <= N axes in registers, loops unrolled to N: a slot's
// usage, and the pod's request and the frontier's first row beside it.
// Axes past R hold 0 in all three, so they always fit and never change,
// and the loops over them need no test of R.
template <int N>
struct RegRow {
  static constexpr int kAxes = N;
  using Vec = RegRow<N>;
  int32_t v[N];
  HD int32_t& operator[](int r) { return v[r]; }
  HD int32_t operator[](int r) const { return v[r]; }
};

// A row read in place (request chunk, frontier) for wide R.
struct PtrRow {
  static constexpr int kAxes = 0;
  const int32_t* p;
  HD int32_t operator[](int r) const { return p[r]; }
};

// A slot's usage row as a column of the warp's shared block: axis r of
// slot k at block[r * K + k], so a lane per slot reads without bank
// conflicts.
struct SmemRow {
  static constexpr int kAxes = 0;
  using Vec = PtrRow;
  int32_t* p;
  int stride;
  HD int32_t& operator[](int r) const { return p[r * stride]; }
};

template <int N>
HD void load_row(RegRow<N>& q, const int32_t* src, int R) {
  UNROLL
  for (int r = 0; r < N; ++r) q[r] = r < R ? src[r] : 0;
}
HD void load_row(PtrRow& q, const int32_t* src, int) { q.p = src; }

template <int N>
HD void bind_row(RegRow<N>&, int32_t*, int, int) {}
// lanes past K read slot 0's column and never write it
HD void bind_row(SmemRow& row, int32_t* block, int lane, int K) {
  row.p = block + (lane < K ? lane : 0);
  row.stride = K;
}

template <class Row>
struct Slot {
  Row u;          // usage row, INT_INF while closed
  int32_t count;  // pods on the node
  int32_t id;     // node id, -1 while closed
  float tie;      // id_tie(id) while open
  uint32_t key;   // slot_key(count, tie) while open
};

// usage + req fits frontier row `front`, in the overflow-safe form
// usage <= front - req (usage may be INT_INF; front and req are >= 0);
// a frontier row read in place is not read past R
template <class Row, class Front, class Vec>
HD bool row_fits(const Row& u, const Front& front, const Vec& rq, int R) {
  constexpr int NA = Row::kAxes;
  constexpr bool padded = NA > 0 && !std::is_pointer<Front>::value;
  bool ok = true;
  UNROLL
  for (int r = 0; r < (NA ? NA : R); ++r) {
    if (padded || r < R) ok &= u[r] <= front[r] - rq[r];
  }
  return ok;
}

template <class Row>
HD void lane_init(Slot<Row>& s, int R) {
  constexpr int NA = Row::kAxes;
  UNROLL
  for (int r = 0; r < (NA ? NA : R); ++r) s.u[r] = r < R ? INT_INF : 0;
  s.count = 0;
  s.id = -1;
  s.tie = 0.0f;
  s.key = NO_BID;
}

// The slot's bid for the pod: its key when it is a real slot (lane <
// K), open, under the cap, and some frontier row holds its usage plus
// the pod (row 0 from `f0`, the rest from `fr`); else NO_BID.
template <class Row, class Vec>
HD uint32_t lane_bid(const Slot<Row>& s, bool real, const Vec& rq, const Vec& f0, const int32_t* fr, int F,
                     int R, int32_t cap) {
  const bool ok = real & (s.id >= 0) & (s.count < cap);
  bool hit = row_fits(s.u, f0, rq, R);
  for (int f = 1; ok && !hit && f < F; ++f) hit = row_fits(s.u, fr + f * R, rq, R);
  return ok & hit ? s.key : NO_BID;
}

template <class Row>
HD bool lane_closed(const Slot<Row>& s, bool real) {
  return real && s.id < 0;
}

// primary-axis headroom of an open slot (the eviction order), INT_INF
// for a closed or absent one
template <class Row>
HD int32_t lane_headroom(const Slot<Row>& s, bool real, int32_t fmax0) {
  return real && s.id >= 0 ? fmax0 - s.u[0] : INT_INF;
}

// The pod onto the slot when `me` (the chosen lane): in registers by
// selects every lane runs, so the warp does not branch; a shared usage
// column is written by its own lane only.
template <class Row, class Vec>
HD void lane_take(Slot<Row>& s, const Vec& rq, int R, bool me) {
  constexpr int NA = Row::kAxes;
  if (NA == 0 && !me) return;
  UNROLL
  for (int r = 0; r < (NA ? NA : R); ++r) s.u[r] += me ? rq[r] : 0;
  s.count += me;
  s.key = me ? slot_key(s.count, s.tie) : s.key;
}

// A new node `id` in the slot when `me`, the same way.
template <class Row, class Vec>
HD void lane_open(Slot<Row>& s, const Vec& rq, int R, int32_t id, bool me) {
  constexpr int NA = Row::kAxes;
  if (NA == 0 && !me) return;
  UNROLL
  for (int r = 0; r < (NA ? NA : R); ++r) s.u[r] = me ? rq[r] : s.u[r];
  s.count = me ? 1 : s.count;
  s.id = me ? id : s.id;
  s.tie = me ? id_tie(id) : s.tie;
  s.key = me ? slot_key(1, s.tie) : s.key;
}

// some frontier row holds the pod alone (a fresh node can take it)
HD bool pod_fresh(const int32_t* rq, const int32_t* fr, int F, int R) {
  for (int f = 0; f < F; ++f) {
    bool ok = true;
    for (int r = 0; r < R; ++r) ok &= rq[r] <= fr[f * R + r];
    if (ok) return true;
  }
  return false;
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

HD void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

HD void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// pods [base, base + n) of the job's requests into `buf`, n * R int32
// spread over the 32 lanes (on the host, one caller does all lanes)
HD void fetch_chunk(int32_t* buf, const int32_t* jreq, int base, int n, int R, int lane, int lanes) {
  const int32_t* src = jreq + static_cast<int64_t>(base) * R;
  for (int i = lane; i < n * R; i += lanes) copy_async(buf + i, src + i);
  copy_commit();
}

// int32 of one warp's shared block: the chunk's node ids, the two
// request chunks, the frontier when staged, the usage columns when rows
// live there
HD size_t warp_ints(int F, int R, int K, bool front_in_smem, bool smem_rows) {
  return CHUNK + static_cast<size_t>(2 * CHUNK) * R + (front_in_smem ? static_cast<size_t>(F) * R : 0) +
         (smem_rows ? static_cast<size_t>(K) * R : 0);
}

// Jobs per block and whether the frontier is staged, for `smem_rows`;
// false when one warp's block does not fit the budget.
bool plan_blocks(int F, int R, int K, bool smem_rows, int* warps, bool* front_in_smem) {
  for (int staged = 1; staged >= 0; --staged) {
    for (int w = WARPS; w >= 1; w /= 2) {
      if (warp_ints(F, R, K, staged, smem_rows) * 4 * w <= SMEM_BUDGET) {
        *warps = w;
        *front_in_smem = staged;
        return true;
      }
    }
  }
  return false;
}

#ifdef __CUDACC__
// whether this lane is the first lane of the warp for which `pred`
// holds: __ballot_sync, then no lower lane set (the lane __ffs would
// give, without the bit scan on the step's chain)
__device__ __forceinline__ bool first_lane(bool pred, unsigned below) {
  const unsigned set = __ballot_sync(FULL, pred);  // every lane votes
  return pred && (set & below) == 0u;
}

template <class Row>
__global__ void __launch_bounds__(WARPS * 32)
    ffd_pack_kernel(const int32_t* __restrict__ req, const int32_t* __restrict__ front,
                    const int32_t* __restrict__ caps, const int32_t* __restrict__ n_pods, int G, int P_ld,
                    int F, int R, int K, int front_in_smem, int32_t* __restrict__ node_ids,
                    int32_t* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  const int g = blockIdx.x * (blockDim.x >> 5) + warp;
  if (g >= G) return;  // whole warps leave; no block barrier follows
  constexpr bool smem_rows = Row::kAxes == 0;
  int32_t* sout = smem + warp * warp_ints(F, R, K, front_in_smem, smem_rows);
  int32_t* chunk0 = sout + CHUNK;
  int32_t* sfront = chunk0 + 2 * CHUNK * R;
  int32_t* usage = sfront + (front_in_smem ? F * R : 0);
  const int32_t* jreq = req + static_cast<int64_t>(g) * P_ld * R;
  const int32_t* gfront = front + static_cast<int64_t>(g) * F * R;
  int32_t* out = node_ids + static_cast<int64_t>(g) * P_ld;
  const int P = n_pods[g];
  const int32_t cap = caps[g];
  fetch_chunk(chunk0, jreq, 0, P < CHUNK ? P : CHUNK, R, lane, 32);
  if (front_in_smem) {
    for (int i = lane; i < F * R; i += 32) sfront[i] = gfront[i];
  }
  for (int p = P + lane; p < P_ld; p += 32) out[p] = -1;
  __syncwarp();
  const int32_t* fr = front_in_smem ? sfront : gfront;
  int32_t fmax0 = -INT_INF;
  for (int f = lane; f < F; f += 32) fmax0 = fr[f * R] > fmax0 ? fr[f * R] : fmax0;
  fmax0 = __reduce_max_sync(FULL, fmax0);
  const bool real = lane < K;
  using Vec = typename Row::Vec;
  Vec f0;
  load_row(f0, fr, R);
  Slot<Row> s;
  bind_row(s.u, usage, lane, K);
  if (real || !smem_rows) lane_init(s, R);
  int32_t next_id = 0;
  for (int base = 0; base < P; base += CHUNK) {
    copy_wait();
    __syncwarp();  // the chunk landed, every lane's copies visible
    const int32_t* buf = chunk0 + ((base / CHUNK) & 1) * CHUNK * R;
    if (base + CHUNK < P) {
      const int n_next = P - base - CHUNK < CHUNK ? P - base - CHUNK : CHUNK;
      fetch_chunk(chunk0 + (((base / CHUNK) + 1) & 1) * CHUNK * R, jreq, base + CHUNK, n_next, R, lane, 32);
    }
    const int n = P - base < CHUNK ? P - base : CHUNK;
    const uint32_t fresh = __ballot_sync(FULL, lane < n && pod_fresh(buf + lane * R, fr, F, R));
    Vec rq;
    load_row(rq, buf, R);
    for (int j = 0; j < n; ++j) {
      Vec next = rq;  // the next pod's row, loaded while this step runs
      if (j + 1 < n) load_row(next, buf + (j + 1) * R, R);
      const uint32_t bid = lane_bid(s, real, rq, f0, fr, F, R, cap);
      const uint32_t best = __reduce_min_sync(FULL, bid);
      if (best != NO_BID) {
        const bool me = first_lane(bid == best, below);
        lane_take(s, rq, R, me);
        if (me) sout[j] = s.id;
      } else if ((fresh >> j) & 1u) {
        const bool closed = lane_closed(s, real);
        bool me;
        if (__any_sync(FULL, closed)) {
          me = first_lane(closed, below);
        } else {
          const int32_t head = lane_headroom(s, real, fmax0);
          me = first_lane(head == __reduce_min_sync(FULL, head), below);
        }
        lane_open(s, rq, R, next_id, me);
        if (me) sout[j] = next_id;
        ++next_id;
      } else if (lane == 0) {
        sout[j] = -1;
      }
      rq = next;
    }
    __syncwarp();  // the chunk's ids written
    if (lane < n) out[base + lane] = sout[lane];
    __syncwarp();  // the chunk and its ids read before their buffers are refilled
  }
  if (lane == 0) counts[g] = next_id;
}

template <class Row>
int launch_rows(const int32_t* req, const int32_t* front, const int32_t* caps, const int32_t* n_pods,
                int G, int P_ld, int F, int R, int K, int32_t* node_ids, int32_t* counts,
                cudaStream_t stream) {
  int warps;
  bool front_in_smem;
  if (!plan_blocks(F, R, K, Row::kAxes == 0, &warps, &front_in_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = warp_ints(F, R, K, front_in_smem, Row::kAxes == 0) * 4 * warps;
  cudaError_t err = cudaFuncSetAttribute(ffd_pack_kernel<Row>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((G + warps - 1) / warps);
  ffd_pack_kernel<Row><<<blocks, warps * 32, smem, stream>>>(req, front, caps, n_pods, G, P_ld, F, R, K,
                                                               front_in_smem, node_ids, counts);
  return static_cast<int>(cudaGetLastError());
}
#else
// The host form of the warp collectives: loops over the 32 lanes.
template <class T>
T lanes_min(const T (&v)[32]) {
  T m = v[0];
  for (int l = 1; l < 32; ++l) m = v[l] < m ? v[l] : m;
  return m;
}

uint32_t lanes_ballot(const bool (&pred)[32]) {
  uint32_t b = 0;
  for (int l = 0; l < 32; ++l) b |= static_cast<uint32_t>(pred[l]) << l;
  return b;
}

template <class T>
uint32_t lanes_equal(const T (&v)[32], T x) {
  bool pred[32];
  for (int l = 0; l < 32; ++l) pred[l] = v[l] == x;
  return lanes_ballot(pred);
}

// One job, the warp's lanes run in turn between collectives, on the
// kernel's row type.
template <class Row>
void pack_job_host(const int32_t* jreq, const int32_t* fr, int P, int P_ld, int F, int R, int K,
                   int32_t cap, int32_t* out, int32_t* count) {
  constexpr bool smem_rows = Row::kAxes == 0;
  std::vector<int32_t> usage(static_cast<size_t>(K) * R), buf(static_cast<size_t>(CHUNK) * R);
  using Vec = typename Row::Vec;
  Vec f0;
  load_row(f0, fr, R);
  Slot<Row> s[32];
  for (int l = 0; l < 32; ++l) {
    bind_row(s[l].u, usage.data(), l, K);
    if (l < K || !smem_rows) lane_init(s[l], R);
  }
  for (int p = P; p < P_ld; ++p) out[p] = -1;
  int32_t fmax0 = -INT_INF;
  for (int f = 0; f < F; ++f) fmax0 = fr[f * R] > fmax0 ? fr[f * R] : fmax0;
  int32_t next_id = 0;
  for (int base = 0; base < P; base += CHUNK) {
    const int n = P - base < CHUNK ? P - base : CHUNK;
    fetch_chunk(buf.data(), jreq, base, n, R, 0, 1);
    bool fresh_lane[32];
    for (int l = 0; l < 32; ++l) fresh_lane[l] = l < n && pod_fresh(buf.data() + l * R, fr, F, R);
    const uint32_t fresh = lanes_ballot(fresh_lane);
    for (int j = 0; j < n; ++j) {
      Vec rq;
      load_row(rq, buf.data() + j * R, R);
      uint32_t bid[32];
      for (int l = 0; l < 32; ++l) bid[l] = lane_bid(s[l], l < K, rq, f0, fr, F, R, cap);
      const uint32_t best = lanes_min(bid);
      int32_t id = -1;
      if (best != NO_BID) {
        const int k = __builtin_ffs(lanes_equal(bid, best)) - 1;
        for (int l = 0; l < 32; ++l) lane_take(s[l], rq, R, l == k);
        id = s[k].id;
      } else if ((fresh >> j) & 1u) {
        bool closed_lane[32];
        for (int l = 0; l < 32; ++l) closed_lane[l] = lane_closed(s[l], l < K);
        const uint32_t closed = lanes_ballot(closed_lane);
        int k;
        if (closed) {
          k = __builtin_ffs(closed) - 1;
        } else {
          int32_t head[32];
          for (int l = 0; l < 32; ++l) head[l] = lane_headroom(s[l], l < K, fmax0);
          k = __builtin_ffs(lanes_equal(head, lanes_min(head))) - 1;
        }
        for (int l = 0; l < 32; ++l) lane_open(s[l], rq, R, next_id, l == k);
        id = next_id++;
      }
      out[base + j] = id;
    }
  }
  *count = next_id;
}

template <class Row>
int host_rows(const int32_t* rq, const int32_t* fr, const int32_t* cp, const int32_t* np, int64_t G,
              int64_t P_ld, int64_t F, int64_t R, int64_t K, int32_t* out, int32_t* cnt) {
  int warps;
  bool front_in_smem;
  if (!plan_blocks(F, R, K, Row::kAxes == 0, &warps, &front_in_smem)) return 1;
  for (int64_t g = 0; g < G; ++g) {
    if (np[g] < 0 || np[g] > P_ld) return 1;
    pack_job_host<Row>(rq + g * P_ld * R, fr + g * F * R, np[g], P_ld, F, R, K, cp[g], out + g * P_ld,
                       cnt + g);
  }
  return 0;
}
#endif

bool bad_args(int64_t G, int64_t P_ld, int64_t F, int64_t R, int64_t K) {
  return G < 0 || P_ld < 0 || F < 1 || R < 1 || K < 1 || K > MAX_K || G > INT32_MAX ||
         P_ld > INT32_MAX || F * R > INT32_MAX;
}

}  // namespace

extern "C" {

// req (G, P_ld, R), front (G, F, R) int32 row-major and contiguous;
// caps (G,) and n_pods (G,) int32 (n_pods[g] <= P_ld: the job's real
// pods, padding past it is never read); node_ids (G, P_ld) int32, -1
// past n_pods; counts (G,) int32. Rows of up to 4 axes live in
// registers, wider ones in shared memory; one warp's shared block (the
// chunk's ids, two 32-pod request chunks and, past 4 axes, the K usage
// columns) must fit 200 KB, so R <= 639 at K = 16 (533 at K = 32).
// Returns an error code without running when the arguments break that
// contract.
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int ffd_pack_launch(const void* req, const void* front, const void* caps, const void* n_pods,
                    int64_t G, int64_t P_ld, int64_t F, int64_t R, int64_t K, void* node_ids,
                    void* counts, void* stream) {
  if (bad_args(G, P_ld, F, R, K)) return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  auto* rq = static_cast<const int32_t*>(req);
  auto* fr = static_cast<const int32_t*>(front);
  auto* cp = static_cast<const int32_t*>(caps);
  auto* np = static_cast<const int32_t*>(n_pods);
  auto* ids = static_cast<int32_t*>(node_ids);
  auto* cnt = static_cast<int32_t*>(counts);
  auto st = static_cast<cudaStream_t>(stream);
  if (R <= 4) return launch_rows<RegRow<4>>(rq, fr, cp, np, G, P_ld, F, R, K, ids, cnt, st);
  return launch_rows<SmemRow>(rq, fr, cp, np, G, P_ld, F, R, K, ids, cnt, st);
}
#else
// The same step on the CPU, host pointers, same layout as the launch.
int ffd_pack_host(const void* req, const void* front, const void* caps, const void* n_pods,
                  int64_t G, int64_t P_ld, int64_t F, int64_t R, int64_t K, void* node_ids,
                  void* counts) {
  if (bad_args(G, P_ld, F, R, K)) return 1;
  auto* rq = static_cast<const int32_t*>(req);
  auto* fr = static_cast<const int32_t*>(front);
  auto* cp = static_cast<const int32_t*>(caps);
  auto* np = static_cast<const int32_t*>(n_pods);
  auto* ids = static_cast<int32_t*>(node_ids);
  auto* cnt = static_cast<int32_t*>(counts);
  if (R <= 4) return host_rows<RegRow<4>>(rq, fr, cp, np, G, P_ld, F, R, K, ids, cnt);
  return host_rows<SmemRow>(rq, fr, cp, np, G, P_ld, F, R, K, ids, cnt);
}
#endif

}  // extern "C"
