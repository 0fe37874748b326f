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
// one fused multiply-add, taken exactly in double), the order of the
// plain version (backends/lp.py::dual_ascent_reference), so the two
// agree bit for bit on the card.
//
// Design. One thread block runs the whole loop; what bounds it is the
// latency of one iteration, so the design shortens the chain each
// iteration waits on:
//   - type rows owned by threads: the block holds `groups` replicas of
//     `owners` threads; in each, thread i owns types i, i + owners, ...:
//     their rows of alloc, w, mu (reused as demand), price and fit bits
//     are its own in every step, in registers for up to 2 types of up to
//     4 axes (zero past R, so no test of R) and 64 signatures, else in
//     columns of the block's work area that only their owner touches.
//     Project, demand and update need no barrier and no exchange;
//   - fit computed once: valid and req <= alloc on every axis, one bit
//     per (signature, owned type), before the loop; has_fit is a warp OR
//     and one shared atomic a warp;
//   - route: replica g takes every groups-th batch of 4 signatures
//     (replicas fill the block where the types leave threads over, so a
//     small catalog routes its signatures side by side); per signature
//     each thread takes its least cost over its types, the warp its least
//     (cost bits, type) key with two __reduce_min_sync (costs are >= 0
//     or the 1e18 mask, so their bits order as the values; the least
//     key is the first index on ties whatever the ownership), and lane 0
//     writes it into a partial buffer double-buffered by iteration parity.
//     The 4 signatures of a batch interleave their chains;
//   - the argmin's finish: with one warp a replica, its key is t*, and
//     after the iteration's one barrier every warp reads all S of them;
//     with more, warp w reduces signature w's partials and writes t*_w,
//     and a second barrier publishes them (one barrier and every warp
//     reducing every signature itself ran 15 % slower at T = 2,048 on
//     an H100 80GB HBM3 at 700 W);
//   - demand: the owner of type t walks s = 0 ... S-1 and adds count_s *
//     req_s where t*_s = t, the order of the plain version's one
//     index_add_ per signature, without atomics (in registers by selects
//     every thread runs);
//   - the step sizes of the first 512 iterations are filled into shared
//     memory before the loop, one thread each, with the same rounding.
// The signature rows, count_s * req_s, the step sizes and the partials
// live in shared memory, read by broadcast; when a block's work area
// does not fit 220 KB (T = 2048 with R = 12 and S = 64, say) it lives in
// a device-memory scratch buffer the wrapper passes.
//
// Bound. Bytes: inputs read once and outputs written once, about
// (S * R + S + T * (2R + 2)) * 4 + T * R * 4 + S * 5. Operations: per
// iteration S * T * 2R flops of routing, T * 4R of projection and update,
// S * R of demand, over the published 67 TFLOP/s float32 rate. Neither
// bounds it: each iteration waits for the last, so the time is `iters`
// times one iteration's latency: at config 5's S = 16 x T = 2,048 the
// route's S x 2 dot products a thread and the reductions, at config 10's
// T <= 32 the chain of one warp (the correctly rounded divisions of
// project and update among it).
//
// Host build. The per-thread steps (thread_init, thread_project,
// thread_route, thread_demand, thread_update) are __host__ __device__
// on the same row types as the card. Compiled by g++ as C++ this file
// exports dual_ascent_host: the same plan and work area, each thread's
// step run in order and each warp reduction a loop over its lanes
// (tests/test_torch_lp.py).

#include <climits>
#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <cmath>
#include <cstring>
#include <vector>
#define HD inline
#endif

#ifdef __CUDA_ARCH__
#define FMUL(a, b) __fmul_rn((a), (b))
#define FADD(a, b) __fadd_rn((a), (b))
#define FDIV(a, b) __fdiv_rn((a), (b))
#define DMUL(a, b) __dmul_rn((a), (b))
#define DADD(a, b) __dadd_rn((a), (b))
#define DDIV(a, b) __ddiv_rn((a), (b))
#define DSQRT(a) __dsqrt_rn(a)
#define D2F(a) __double2float_rn(a)
#define UNROLL _Pragma("unroll")
#else
#define FMUL(a, b) ((a) * (b))
#define FADD(a, b) ((a) + (b))
#define FDIV(a, b) ((a) / (b))
#define DMUL(a, b) ((a) * (b))
#define DADD(a, b) ((a) + (b))
#define DDIV(a, b) ((a) / (b))
#define DSQRT(a) std::sqrt(a)
#define D2F(a) static_cast<float>(a)
#define UNROLL
#endif

namespace {

constexpr int MAX_THREADS = 1024;  // threads of a block
constexpr int MAX_R = 16;
constexpr int LR_TABLE = 512;      // step sizes filled before the loop
constexpr size_t SMEM_BUDGET = 220 * 1024;
// the bits of the reference's mask value, float32(_BIG * 1e6) = 1e18
// (_BIG = float32(1e12)), the cost where a signature does not fit a type
constexpr uint32_t MASKED_BITS = 0x5d5e0b6bu;
constexpr uint32_t NO_KEY = 0xffffffffu;
// the register path: up to 2 types a thread, 4 axes, 64 signatures
constexpr int REG_TYPES = 2, REG_AXES = 4, REG_WORDS = 2;
// signatures a warp routes together: their chains interleave
constexpr int BATCH = 4;

HD uint32_t float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t b;
  memcpy(&b, &x, sizeof b);
  return b;
#endif
}

// 0.5 / sqrt(it + 1) as 0.5 times 1 / sqrt(it + 1) rounded once to float
// (backends/lp.py::step_lr)
HD float step_lr(int it) {
  return FMUL(0.5f, D2F(DDIV(1.0, DSQRT(static_cast<double>(it) + 1.0))));
}

// How one relax call is laid out: one block of `threads` threads, in
// `groups` replicas of `owners` threads each (a replica's threads own
// every type, `types` types a thread, and route every groups-th batch of
// signatures), fit bits in `words` words a type, rows in registers
// (`regs`: 4 axes, zero past R, and the signature rows staged at a pitch
// of 4) or in the work area, the work area (`bytes`) in shared or device
// memory.
struct Plan {
  int threads, owners, groups, types, words, regs, global;
  int64_t bytes;
};

HD int64_t round8(int64_t n) { return (n + 7) / 8 * 8; }

// floats of one replica's owned rows in a block's work area
HD int64_t replica_floats(int64_t R, int64_t owners, int64_t types, int64_t words) {
  return owners * types * (3 * R + 1 + words);
}

// the pitch of the staged signature rows
HD int64_t row_pitch(int64_t R, bool regs) { return regs ? REG_AXES : R; }

// bytes of one block's work area
int64_t block_bytes(int64_t S, int64_t R, int64_t owners, int64_t groups, int64_t types, int64_t words, bool regs) {
  int64_t n = 16 * (owners / 32) * S;                                     // partial keys, two parities
  n += round8(4 * (owners / 32) * groups * S);                            // each warp's routes
  n += round8(8 * S * row_pitch(R, regs) + 4 * LR_TABLE + 4 * words);     // signature rows, weights, steps, has_fit
  if (!regs) n += 4 * groups * replica_floats(R, owners, types, words);  // the owned rows
  return n;
}

// The plan for (S, T, R); false when the arguments are out of range.
bool make_plan(int64_t S, int64_t T, int64_t R, Plan* p) {
  if (S < 1 || T < 1 || R < 1 || R > MAX_R || S > INT32_MAX / 64 || T > INT32_MAX / 2) return false;
  int64_t n = 32;
  while (n < T && n < MAX_THREADS) n <<= 1;
  // replicas fill the block, up to one per batch of signatures
  const int64_t batches = (S + BATCH - 1) / BATCH;
  int64_t groups = 1;
  while (groups < batches && groups * 2 * n <= MAX_THREADS) groups <<= 1;
  const int64_t types = (T + n - 1) / n;
  const int64_t words = (S + 31) / 32;
  bool regs = types <= REG_TYPES && R <= REG_AXES && words <= REG_WORDS;
  int64_t bytes = block_bytes(S, R, n, groups, types, words, regs);
  // replicas of rows in the work area give way before it leaves shared memory
  while (groups > 1 && bytes > static_cast<int64_t>(SMEM_BUDGET)) {
    groups >>= 1;
    bytes = block_bytes(S, R, n, groups, types, words, regs);
  }
  const bool global = bytes > static_cast<int64_t>(SMEM_BUDGET);
  if (global && regs) {  // the device-memory layout keeps its rows there too
    regs = false;
    bytes = block_bytes(S, R, n, groups, types, words, regs);
  }
  *p = Plan{static_cast<int>(n * groups), static_cast<int>(n), static_cast<int>(groups),
            static_cast<int>(types), static_cast<int>(words), regs, global, bytes};
  return true;
}

// One block's work area, carved from `bytes` bytes (8-byte aligned).
struct Block {
  uint64_t* part;  // (2, owners / 32, S) warp keys by iteration parity, written
                   // by the replica that routes s
  int32_t* wt;     // (warps, S) the routes each warp reads, -1 where s fits
                   // no type (row 0 the block's, with more than one warp a
                   // replica)
  float* reqs;     // (S, pitch) signature rows, zero past R
  float* wts;      // (S, pitch) count_s * req_s, zero past R
  float* lrs;      // (LR_TABLE,)
  uint32_t* hfw;   // (words,) has_fit bits
  float* rows;     // the owned rows past the register path, per replica:
                   // alloc, w, mu (types, R, owners) each, price (types,
                   // owners), fit (types, words, owners)
};

HD Block carve(unsigned char* base, const Plan& p, int S, int R) {
  const int64_t warps = p.threads / 32, owner_warps = p.owners / 32, P = row_pitch(R, p.regs);
  Block b;
  b.part = reinterpret_cast<uint64_t*>(base);
  b.wt = reinterpret_cast<int32_t*>(b.part + 2 * owner_warps * S);
  b.reqs = reinterpret_cast<float*>(base + 16 * owner_warps * S + round8(4 * warps * S));
  b.wts = b.reqs + S * P;
  b.lrs = b.wts + S * P;
  b.hfw = reinterpret_cast<uint32_t*>(b.lrs + LR_TABLE);
  b.rows = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(b.reqs) +
                                    round8(8 * S * P + 4 * LR_TABLE + 4 * p.words));
  return b;
}

// What every thread knows: the shape, the pitch P of the staged
// signature rows, its index g among its replica's NT threads (a power of
// two, 1 << shift).
struct Ctx {
  int S, T, R, P, words, types, g, NT, shift;
};

HD int type_of(const Ctx& c, int j) { return c.g + j * c.NT; }

// A thread's types in registers: KT types of RA axes (zero past R, so
// the loops run to the constants with no test of R), NW fit words.
template <int KT, int RA, int NW>
struct RegRows {
  static constexpr int kTypes = KT, kAxes = RA, kWords = NW;
  float al[KT][RA], wv[KT][RA], mv[KT][RA], pr[KT];
  uint32_t ft[KT][NW];
  HD void bind(const Block&, const Plan&, int, int, int) {}
  HD float& alloc(int j, int r) { return al[j][r]; }
  HD float& w(int j, int r) { return wv[j][r]; }
  HD float& mu(int j, int r) { return mv[j][r]; }
  HD float& price(int j) { return pr[j]; }
  HD uint32_t& fit(int j, int m) { return ft[j][m]; }
  // word m of type j's fit bits, m known only at run time: a select over
  // the constant indices, so the rows stay in registers
  HD uint32_t fit_word(int j, int m) const {
    uint32_t v = ft[j][0];
    UNROLL
    for (int k = 1; k < NW; ++k) v = m == k ? ft[j][k] : v;
    return v;
  }
};

// A thread's types as columns of its replica's part of the block's work
// area, touched by their owner only: axis r of the thread's j-th type at
// [(j * R + r) * owners + i], i the thread's index in the replica, so a
// warp's lanes touch consecutive words.
struct MemRows {
  static constexpr int kTypes = 0, kAxes = 0, kWords = 0;
  float *al, *wv, *mv, *pr;
  uint32_t* ft;
  int n, R, words;
  HD void bind(const Block& b, const Plan& p, int tid, int R_, int words_) {
    n = p.owners;
    R = R_;
    words = words_;
    const int64_t col = static_cast<int64_t>(p.types) * R * n;
    al = b.rows + tid / n * replica_floats(R, n, p.types, words) + tid % n;
    wv = al + col;
    mv = wv + col;
    pr = mv + col;
    ft = reinterpret_cast<uint32_t*>(pr + static_cast<int64_t>(p.types) * n);
  }
  HD float& alloc(int j, int r) { return al[(j * R + r) * n]; }
  HD float& w(int j, int r) { return wv[(j * R + r) * n]; }
  HD float& mu(int j, int r) { return mv[(j * R + r) * n]; }
  HD float& price(int j) { return pr[j * n]; }
  HD uint32_t& fit(int j, int m) { return ft[(j * words + m) * n]; }
  HD uint32_t fit_word(int j, int m) const { return ft[(j * words + m) * n]; }
};

// loops over a thread's types, axes and fit words: to the register
// path's constants, else to the call's counts
#define FOR_TYPES(Rows, j, c) \
  UNROLL for (int j = 0; j < (Rows::kTypes ? Rows::kTypes : (c).types); ++j) if (j < (c).types)
#define FOR_AXES(Rows, r, c) UNROLL for (int r = 0; r < (Rows::kAxes ? Rows::kAxes : (c).R); ++r)
#define FOR_WORDS(Rows, m, c) UNROLL for (int m = 0; m < (Rows::kWords ? Rows::kWords : (c).words); ++m) if (m < (c).words)

// Load the thread's types and compute their fit bits against the
// block's signature rows; slots past T hold zeros and no fit.
template <class Rows>
HD void thread_init(Rows& rw, const Ctx& c, const float* alloc, const float* prices, const uint8_t* valid,
                    const float* w0, const float* reqs) {
  FOR_TYPES(Rows, j, c) {
    const int t = type_of(c, j);
    const bool real = t < c.T;
    FOR_AXES(Rows, r, c) {
      const bool in = real && r < c.R;
      rw.alloc(j, r) = in ? alloc[static_cast<int64_t>(t) * c.R + r] : 0.0f;
      rw.w(j, r) = in ? w0[static_cast<int64_t>(t) * c.R + r] : 0.0f;
    }
    rw.price(j) = real ? prices[t] : 0.0f;
    const bool ok = real && valid[t] != 0;
    FOR_WORDS(Rows, m, c) {
      uint32_t bits = 0;
      for (int b = 0; b < 32 && ok; ++b) {
        const int s = 32 * m + b;
        if (s >= c.S) break;
        bool fits = true;
        FOR_AXES(Rows, r, c) fits &= reqs[s * c.P + r] <= rw.alloc(j, r);
        bits |= static_cast<uint32_t>(fits) << b;
      }
      rw.fit(j, m) = bits;
    }
  }
}

// mu_t = price_t * w_t / max(w_t . alloc_t, 1e-6), the dot in axis order;
// a zero numerator skips its division (0 over a positive divisor)
template <class Rows>
HD void thread_project(Rows& rw, const Ctx& c) {
  FOR_TYPES(Rows, j, c) {
    float d = FMUL(rw.w(j, 0), rw.alloc(j, 0));
    FOR_AXES(Rows, r, c) {
      if (r > 0) d = FADD(d, FMUL(rw.w(j, r), rw.alloc(j, r)));
    }
    d = d > 1e-6f ? d : 1e-6f;
    FOR_AXES(Rows, r, c) {
      const float num = FMUL(rw.price(j), rw.w(j, r));
      rw.mu(j, r) = num == 0.0f ? num : FDIV(num, d);
    }
  }
}

// The thread's least (cost bits, type) for signature s over its real
// types, the lower type on ties: cost req_s . mu_t in axis order where
// s fits t, else the mask; (NO_KEY, NO_KEY) when it owns none.
template <class Rows>
HD void thread_route(Rows& rw, const Ctx& c, int s, const float* req, uint32_t* best, uint32_t* idx) {
  uint32_t bv = NO_KEY, bi = NO_KEY;
  const int m = s >> 5;
  const uint32_t bit = 1u << (s & 31);
  FOR_TYPES(Rows, j, c) {
    const int t = type_of(c, j);
    float v = FMUL(req[0], rw.mu(j, 0));
    FOR_AXES(Rows, r, c) {
      if (r > 0) v = FADD(v, FMUL(req[r], rw.mu(j, r)));
    }
    const uint32_t key = (rw.fit_word(j, m) & bit) ? float_bits(v) : t < c.T ? MASKED_BITS : NO_KEY;
    const bool take = key < bv;
    bv = take ? key : bv;
    bi = take ? static_cast<uint32_t>(t) : bi;
  }
  *best = bv;
  *idx = bi;
}

HD uint64_t key_of(uint32_t bits, uint32_t idx) { return (static_cast<uint64_t>(bits) << 32) | idx; }

// demand_t = sum of count_s * req_s over the signatures routed to t, in
// signature order (wt: the warp's routes, -1 where s fits no type), into
// the mu rows. The register path adds by selects every thread runs; the
// work-area path only at the owner.
template <class Rows>
HD void thread_demand(Rows& rw, const Ctx& c, const int32_t* wt, const float* wts) {
  FOR_TYPES(Rows, j, c) {
    FOR_AXES(Rows, r, c) rw.mu(j, r) = 0.0f;
  }
  const int mask = c.NT - 1;
  for (int s0 = 0; s0 < c.S; s0 += BATCH) {
    int ts[BATCH];  // read together, added in signature order
    UNROLL
    for (int u = 0; u < BATCH; ++u) ts[u] = s0 + u < c.S ? wt[s0 + u] : -1;
    UNROLL
    for (int u = 0; u < BATCH; ++u) {
      const float* add = wts + (s0 + u < c.S ? s0 + u : c.S - 1) * c.P;
      if constexpr (Rows::kTypes == 0) {
        if (ts[u] < 0 || (ts[u] & mask) != c.g) continue;
        const int own = ts[u] >> c.shift;
        for (int r = 0; r < c.R; ++r) rw.mu(own, r) = FADD(rw.mu(own, r), add[r]);
      } else {
        UNROLL
        for (int j = 0; j < Rows::kTypes; ++j) {
          const bool hit = ts[u] == type_of(c, j);
          UNROLL
          for (int r = 0; r < Rows::kAxes; ++r) rw.mu(j, r) = hit ? FADD(rw.mu(j, r), add[r]) : rw.mu(j, r);
        }
      }
    }
  }
}

// w *= 1 + lr * util / max(rowmax(util), 1e-30), util = demand / max(alloc, 1),
// rounded as the reference's compiled step rounds it: the normalised
// utilisation as demand / (max(alloc, 1) * peak) (XLA folds the two
// divisions into one), then lr * it + 1 with one rounding (a fused
// multiply-add; the product is exact in double), times w. A zero demand
// skips its divisions. Axes past R (register path) hold zeros: their
// utilisation is 0, which never raises the peak past axis 0's.
template <class Rows>
HD void thread_update(Rows& rw, const Ctx& c, float lr) {
  FOR_TYPES(Rows, j, c) {
    float peak = 0.0f;
    FOR_AXES(Rows, r, c) {
      const float safe = rw.alloc(j, r) > 1.0f ? rw.alloc(j, r) : 1.0f;
      const float dm = rw.mu(j, r);
      const float util = dm == 0.0f ? dm : FDIV(dm, safe);
      peak = r == 0 || util > peak ? util : peak;
    }
    peak = peak > 1e-30f ? peak : 1e-30f;
    FOR_AXES(Rows, r, c) {
      const float safe = rw.alloc(j, r) > 1.0f ? rw.alloc(j, r) : 1.0f;
      const float dm = rw.mu(j, r);
      const float norm = dm == 0.0f ? dm : FDIV(dm, FMUL(safe, peak));
      const double step = DADD(DMUL(static_cast<double>(lr), static_cast<double>(norm)), 1.0);
      rw.w(j, r) = FMUL(rw.w(j, r), D2F(step));
    }
  }
}

template <class Rows>
HD void thread_write(Rows& rw, const Ctx& c, float* w_out) {
  FOR_TYPES(Rows, j, c) {
    const int t = type_of(c, j);
    if (t >= c.T) continue;
    FOR_AXES(Rows, r, c) {
      if (r < c.R) w_out[static_cast<int64_t>(t) * c.R + r] = rw.w(j, r);
    }
  }
}

struct Args {
  const float* reqs;
  const float* counts;
  const float* alloc;
  const float* prices;
  const uint8_t* valid;
  const float* w0;
  int S, T, R, iters;
  unsigned char* scratch;
  float* w_out;
  int32_t* tstar_out;
  uint8_t* hasfit_out;
};

int log2_of(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// the block's signature rows and count_s * req_s at the plan's pitch
// (zero past R), step sizes; has_fit zeroed
HD void stage_block(const Block& b, const Args& a, int P, int tid, int nthreads) {
  for (int i = tid; i < a.S * P; i += nthreads) {
    const int s = i / P, r = i % P;
    const float req = r < a.R ? a.reqs[s * a.R + r] : 0.0f;
    b.reqs[i] = req;
    b.wts[i] = FMUL(a.counts[s], req);
  }
  const int n_lr = a.iters < LR_TABLE ? a.iters : LR_TABLE;
  for (int i = tid; i < n_lr; i += nthreads) b.lrs[i] = step_lr(i);
  for (int m = tid; m < (a.S + 31) / 32; m += nthreads) b.hfw[m] = 0u;
}

HD float lr_at(const Block& b, int it) { return it < LR_TABLE ? b.lrs[it] : step_lr(it); }

#ifdef __CUDACC__
constexpr unsigned FULL = 0xffffffffu;

// The warp's keys of the batch of signatures from s0 into `part`, lane u
// writing signature s0 + u: each thread's least over its types, then the
// warp's least cost and, among the lanes holding it, the least type.
template <class Rows>
__device__ __forceinline__ void route_batch(Rows& rw, const Ctx& c, const float* reqs, int s0, int lane,
                                            uint64_t* part) {
  uint32_t v[BATCH], i[BATCH], least[BATCH];
  UNROLL
  for (int u = 0; u < BATCH; ++u) {
    v[u] = i[u] = NO_KEY;
    if (s0 + u < c.S) thread_route(rw, c, s0 + u, reqs + (s0 + u) * c.P, &v[u], &i[u]);
  }
  UNROLL
  for (int u = 0; u < BATCH; ++u) least[u] = __reduce_min_sync(FULL, v[u]);
  UNROLL
  for (int u = 0; u < BATCH; ++u) i[u] = __reduce_min_sync(FULL, v[u] == least[u] ? i[u] : NO_KEY);
  UNROLL
  for (int u = 0; u < BATCH; ++u) {
    if (lane == u && s0 + u < c.S) part[s0 + u] = key_of(least[u], i[u]);
  }
}

// t*_s from its least key into the routes `wt` (-1 where s fits no
// type), and into the outputs on the last iteration
__device__ __forceinline__ void take_route(const Block& b, const Args& a, int s, uint64_t best, bool last,
                                           int32_t* wt) {
  const int t = static_cast<int>(best & 0xffffffffu);
  const bool hf = (b.hfw[s >> 5] >> (s & 31)) & 1u;
  wt[s] = hf ? t : -1;
  if (last) {
    a.tstar_out[s] = t;
    a.hasfit_out[s] = hf;
  }
}

// kShared: the work area is the block's shared memory (addressed as
// such), else the device-memory scratch buffer
template <class Rows, bool kShared>
__global__ void __launch_bounds__(MAX_THREADS, 1) dual_ascent_kernel(const Args a, const Plan p, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = p.threads >> 5;
  // replica `rep` of the types; `own` the thread's index in it, `ow` its warp's
  const int rep = tid / p.owners, own = tid % p.owners, ow = own >> 5, owner_warps = p.owners >> 5;
  const Block b = carve(kShared ? smem : a.scratch, p, a.S, a.R);
  const int P = static_cast<int>(row_pitch(a.R, p.regs));
  const Ctx c{a.S, a.T, a.R, P, p.words, p.types, own, p.owners, shift};
  stage_block(b, a, P, tid, p.threads);
  __syncthreads();
  Rows rw;
  rw.bind(b, p, tid, a.R, p.words);
  thread_init(rw, c, a.alloc, a.prices, a.valid, a.w0, b.reqs);
  FOR_WORDS(Rows, m, c) {
    uint32_t bits = 0;
    FOR_TYPES(Rows, j, c) bits |= rw.fit(j, m);
    bits = __reduce_or_sync(FULL, bits);
    if (rep == 0 && lane == 0 && bits != 0u) atomicOr(b.hfw + m, bits);
  }
  __syncthreads();
  // with one warp a replica, each warp reads every route itself; else
  // row 0 holds the block's
  int32_t* wt = b.wt + (owner_warps == 1 ? warp * a.S : 0);
  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    thread_project(rw, c);
    uint64_t* part = b.part + (it & 1) * owner_warps * a.S;
    for (int s0 = rep * BATCH; s0 < a.S; s0 += p.groups * BATCH) route_batch(rw, c, b.reqs, s0, lane, part + ow * a.S);
    __syncthreads();
    if (owner_warps == 1) {
      // the replica's one warp took the least over every type: its key is t*
      for (int s = lane; s < a.S; s += 32) take_route(b, a, s, part[s], last && warp == 0, wt);
      __syncwarp();
    } else {
      // warp w finishes signature w over the replica's warps
      for (int s = warp; s < a.S; s += warps) {
        const uint64_t key = lane < owner_warps ? part[lane * a.S + s] : ~0ull;
        const uint32_t least = __reduce_min_sync(FULL, static_cast<uint32_t>(key >> 32));
        const uint32_t first =
            __reduce_min_sync(FULL, static_cast<uint32_t>(key >> 32) == least ? static_cast<uint32_t>(key) : NO_KEY);
        if (lane == 0) take_route(b, a, s, key_of(least, first), last, wt);
      }
      __syncthreads();  // the iteration's second barrier: the routes out
    }
    if (last) break;
    thread_demand(rw, c, wt, b.wts);
    thread_update(rw, c, lr_at(b, it));
  }
  if (rep == 0) thread_write(rw, c, a.w_out);
}

template <class Rows, bool kShared>
int launch_plan(const Args& a, const Plan& p, cudaStream_t stream) {
  // the largest dynamic shared size set so far, per device: the attribute
  // is set once per size, not on every launch
  static int64_t set_bytes[64] = {};
  const int64_t smem = kShared ? p.bytes : 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > set_bytes[dev]) {
    err = cudaFuncSetAttribute(dual_ascent_kernel<Rows, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set_bytes[dev] = smem;
  }
  dual_ascent_kernel<Rows, kShared><<<1, p.threads, smem, stream>>>(a, p, log2_of(p.owners));
  return static_cast<int>(cudaGetLastError());
}
#else
// The block on the CPU: its work area, every thread's rows, the threads'
// steps in order and each warp reduction a loop over its lanes.
template <class Rows>
int host_plan(const Args& a, const Plan& p) {
  const int n = p.threads, owner_warps = p.owners / 32;
  const int P = static_cast<int>(row_pitch(a.R, p.regs));
  std::vector<uint64_t> area(static_cast<size_t>(p.bytes / 8 + 1));
  const Block b = carve(reinterpret_cast<unsigned char*>(area.data()), p, a.S, a.R);
  stage_block(b, a, P, 0, 1);
  // thread tid: replica tid / owners, index tid % owners
  std::vector<Rows> rows(n);
  std::vector<Ctx> ctx(n);
  for (int tid = 0; tid < n; ++tid) {
    ctx[tid] = Ctx{a.S, a.T, a.R, P, p.words, p.types, tid % p.owners, p.owners, log2_of(p.owners)};
    rows[tid].bind(b, p, tid, a.R, p.words);
    thread_init(rows[tid], ctx[tid], a.alloc, a.prices, a.valid, a.w0, b.reqs);
  }
  for (int m = 0; m < p.words; ++m) {
    for (int tid = 0; tid < p.owners; ++tid) {
      for (int j = 0; j < p.types; ++j) b.hfw[m] |= rows[tid].fit(j, m);
    }
  }
  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    for (int tid = 0; tid < n; ++tid) thread_project(rows[tid], ctx[tid]);
    uint64_t* part = b.part + (it & 1) * owner_warps * a.S;
    for (int rep = 0; rep < p.groups; ++rep) {
      for (int v = 0; v < owner_warps; ++v) {
        for (int s0 = rep * BATCH; s0 < a.S; s0 += p.groups * BATCH) {
          for (int s = s0; s < s0 + BATCH && s < a.S; ++s) {
            uint32_t val[32], idx[32];
            for (int l = 0; l < 32; ++l) {
              const int tid = rep * p.owners + v * 32 + l;
              thread_route(rows[tid], ctx[tid], s, b.reqs + s * P, &val[l], &idx[l]);
            }
            uint32_t least = NO_KEY, first = NO_KEY;
            for (int l = 0; l < 32; ++l) least = val[l] < least ? val[l] : least;
            for (int l = 0; l < 32; ++l) first = val[l] == least && idx[l] < first ? idx[l] : first;
            part[v * a.S + s] = key_of(least, first);
          }
        }
      }
    }
    // the finish: one warp a replica reads its keys, else one key a
    // signature over the replica's warps into row 0
    const int readers = owner_warps == 1 ? n / 32 : 1;
    for (int w = 0; w < readers; ++w) {
      int32_t* wt = b.wt + w * a.S;
      for (int s = 0; s < a.S; ++s) {
        uint64_t best = ~0ull;
        for (int v = 0; v < owner_warps; ++v) best = part[v * a.S + s] < best ? part[v * a.S + s] : best;
        const int t = static_cast<int>(best & 0xffffffffu);
        const bool hf = (b.hfw[s >> 5] >> (s & 31)) & 1u;
        wt[s] = hf ? t : -1;
        if (last && w == 0) {
          a.tstar_out[s] = t;
          a.hasfit_out[s] = hf;
        }
      }
    }
    if (last) break;
    for (int tid = 0; tid < n; ++tid) {
      thread_demand(rows[tid], ctx[tid], b.wt + (owner_warps == 1 ? tid / 32 * a.S : 0), b.wts);
      thread_update(rows[tid], ctx[tid], lr_at(b, it));
    }
  }
  for (int tid = 0; tid < p.owners; ++tid) thread_write(rows[tid], ctx[tid], a.w_out);
  return 0;
}
#endif

using RegPath = RegRows<REG_TYPES, REG_AXES, REG_WORDS>;

Args make_args(const void* reqs, const void* counts, const void* alloc, const void* prices, const void* valid,
               const void* w0, int64_t S, int64_t T, int64_t R, int64_t iters, void* scratch, void* w_out,
               void* tstar_out, void* hasfit_out) {
  return Args{static_cast<const float*>(reqs), static_cast<const float*>(counts),
              static_cast<const float*>(alloc), static_cast<const float*>(prices),
              static_cast<const uint8_t*>(valid), static_cast<const float*>(w0), static_cast<int>(S),
              static_cast<int>(T), static_cast<int>(R), static_cast<int>(iters),
              static_cast<unsigned char*>(scratch), static_cast<float*>(w_out),
              static_cast<int32_t*>(tstar_out), static_cast<uint8_t*>(hasfit_out)};
}

}  // namespace

extern "C" {

// The plan for (S, T, R) into out[0..7): threads, owners (threads of a
// replica), groups (replicas), types a thread, registers (1) or
// work-area rows (0), device-memory (1) or shared (0) work area, bytes
// of the work area. Returns 0, or 1 when no plan exists.
int dual_ascent_plan(int64_t S, int64_t T, int64_t R, int64_t* out) {
  Plan p;
  if (!make_plan(S, T, R, &p)) return 1;
  const int64_t v[7] = {p.threads, p.owners, p.groups, p.types, p.regs, p.global, p.bytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// reqs (S, R), counts (S,), alloc (T, R), prices (T,), w0 (T, R) float32
// and valid (T,) uint8, row-major and contiguous; w_out (T, R) float32,
// tstar_out (S,) int32, hasfit_out (S,) uint8 are written. scratch: a
// device buffer of the plan's `bytes` (8-byte aligned) where the plan
// puts the work area in device memory, else unused (null). Returns an
// error code without running when the arguments break that contract.
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int dual_ascent_launch(const void* reqs, const void* counts, const void* alloc, const void* prices,
                       const void* valid, const void* w0, int64_t S, int64_t T, int64_t R, int64_t iters,
                       void* scratch, void* w_out, void* tstar_out, void* hasfit_out, void* stream) {
  Plan p;
  if (iters < 0 || iters > INT32_MAX - 1 || !make_plan(S, T, R, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(reqs, counts, alloc, prices, valid, w0, S, T, R, iters, scratch, w_out, tstar_out,
                           hasfit_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (p.global) return launch_plan<MemRows, false>(a, p, st);
  return p.regs ? launch_plan<RegPath, true>(a, p, st) : launch_plan<MemRows, true>(a, p, st);
}
#else
// The same iterations on the CPU, host pointers, same layout as the launch.
int dual_ascent_host(const void* reqs, const void* counts, const void* alloc, const void* prices,
                     const void* valid, const void* w0, int64_t S, int64_t T, int64_t R, int64_t iters,
                     void* w_out, void* tstar_out, void* hasfit_out) {
  Plan p;
  if (iters < 0 || iters > INT32_MAX - 1 || !make_plan(S, T, R, &p)) return 1;
  const Args a = make_args(reqs, counts, alloc, prices, valid, w0, S, T, R, iters, nullptr, w_out, tstar_out,
                           hasfit_out);
  return p.regs ? host_plan<RegPath>(a, p) : host_plan<MemRows>(a, p);
}
#endif

}  // extern "C"
