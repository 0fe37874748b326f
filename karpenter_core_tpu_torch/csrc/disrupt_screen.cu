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
// Why a kernel of its own. Once partial sums pass 2^24 (memory columns
// do on bench configs 4 and 9), float32 addition is not associative, and
// a row's verdict can flip at a near-tie with the order of the additions.
// A cumsum or a matrix product in PyTorch takes whatever order CUB or
// cuBLAS picks on the card, and another on the CPU. Here every sum runs
// over the candidates in candidate order, one float32 add at a time with
// round-to-nearest (__fadd_rn: no contraction), so the card, this file
// built by g++ for the CPU and the plain PyTorch versions
// (karpenter_core_tpu_torch/disruption/screen_kernels.py) give the same
// bits. No tree reduction and no reassociation anywhere. Products by a
// 0/1 mask are exact, so they are written as selects: adding +0.0 leaves
// a sum as it was (no sum here is ever -0.0).
//
// What bounds each entry. Bytes and operations are a few microseconds at
// most at the sizes of bench configs 4 and 9 (N <= 1,000 candidates,
// S <= 8,193 subsets, R <= 8 columns). What a fixed order costs is the
// chain: each (row, column) sum is N dependent float32 adds of about
// 4 cycles each, so a row cannot finish in less than about 4 N cycles
// (2 us at N = 1,000); at config 9's sizes (N <= 26) the launch
// dominates. The designs keep that chain free of device-memory
// loads:
//
// Subset (subset_kernel): one thread per subset row, 32 rows a block,
// and a second warp that stages. A thread holds the row's 2C running
// sums of a chunk of C <= 8 columns in registers (the masked load and
// the unmasked free of each column), so every candidate issues 2C
// independent adds; past 8 columns it walks the candidates again for the
// next chunk, each column still in candidate order. The block stages the
// candidates in shared memory with Hopper's bulk copies (cp.async.bulk,
// completing on an mbarrier): the raw rows of loads and free, converted
// once to float32 (__int2float_rn) into a per-candidate record of loads,
// zeros and free, and the block's mask rows. A row's select is one
// address: it reads loads and zeros when the candidate is masked, zeros
// and free when not, so every lane of a warp reads within one 48-byte
// record. Mask bytes are read as aligned 32-bit words (a funnel shift
// for the row's offset), two batches ahead of the adds, the addends one
// batch ahead. N up to 1,024 is one tile, staged once: one copy of the
// block's contiguous mask rows (config 4's 999 rows take 32 blocks, the
// S = 8,193 family cap 257, two to an SM). Past that, tiles of 512
// candidates in two buffers, the next tile's copies (a copy a row,
// issued by the second warp) in flight behind the current tile's adds.
//
// Prefix (prefix_kernel): one block, one pass of running sums instead of
// one walk per row. The block stages the tile by bulk copy and converts
// it into columns; thread r owns column r and walks the candidates once,
// the running load and the running free together (two chains), 16 a
// batch in registers with the loads two batches ahead, writing the sums
// back in place; the total free is the running free at N - 1 (the same
// fold, so the same bits). Then every thread takes rows and votes across
// columns. Past one tile of shared memory a first walk folds the total,
// and the second walks the tiles with the running sums carried over: at
// most 2 N steps in the chain, O(N R) work in all instead of O(N^2 R).
//
// Single (single_kernel): one warp per row, lane r owning column r, as
// first written: it walks the candidates once for the total and beats the
// reference formula in PyTorch at every captured shape.
//
// A bulk copy moves whole aligned 16-byte blocks: the bytes around a
// copied range in its first and last block are copied, never read (a
// 16-byte block that holds a byte of a tensor lies inside its
// allocation, which is at least 256-byte aligned and sized).
//
// Host build. The per-step arithmetic (to_f32, add, sub, fits,
// subset_add, running) is __host__ __device__; compiled by g++ as C++
// this file exports disrupt_{prefix,subsets,singles}_host, which run the
// card's step order: one running-sum pass for the prefix, each row's
// sums over the candidates chunk by chunk for the subsets
// (tests/test_torch_disrupt_screen.py).

#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <atomic>
#define HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif

namespace {

constexpr int WARPS = 8;  // single: rows a block
constexpr int LANES = 32;
constexpr int CHUNK = 8;             // subset: columns a thread holds at a time
constexpr int SUBSET_ROWS = 32;      // subset: rows a block, one warp's threads
constexpr int SUBSET_THREADS = 64;   // subset: a second warp helps stage and convert
constexpr int SUBSET_TILE = 512;     // subset: candidates a shared-memory tile, two buffers
constexpr int SUBSET_ONE_TILE = 1024;  // subset: N up to this is one tile, staged once
constexpr int MASK_PAD = 36;         // subset: a mask row's pitch is tile + 36 bytes, an odd count of words
constexpr int PREFIX_THREADS = 256;  // prefix: threads of the one block
constexpr int MAX_SMEM = 232448;     // shared memory a block can use on sm_90

HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

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

// One candidate of a subset row, one column, its two addends selected:
// the candidate's load or +0.0, its free or +0.0 (adding +0.0 leaves a
// sum as it is).
HD void subset_add(float load_or_zero, float free_or_zero, float& load, float& surviving) {
  load = add(load, load_or_zero);
  surviving = add(surviving, free_or_zero);
}

// The same with the selects: the load joins the row's load when the
// candidate is masked, its free the surviving free when it is not.
HD void subset_step(bool m, float l, float f, float& load, float& surviving) {
  subset_add(m ? l : 0.0f, m ? 0.0f : f, load, surviving);
}

// One candidate of the prefix pass, one column: the running sum takes
// the candidate's value, and the value's slot takes the running sum.
HD void running(float& acc, float& slot) {
  acc = add(acc, slot);
  slot = acc;
}

// Single row i, column r: candidate i's load against everyone else's free.
HD bool single_column(const int32_t* loads, const int32_t* free, const int32_t* fleet,
                      const int32_t* cap, int64_t N, int64_t R, int64_t i, int64_t r) {
  float total = 0.0f;
  for (int64_t n = 0; n < N; ++n) total = add(total, to_f32(free[n * R + r]));
  return fits(to_f32(loads[i * R + r]), sub(total, to_f32(free[i * R + r])), fleet, cap, r);
}

bool bad_args(int64_t rows, int64_t N, int64_t R) { return rows < 0 || N < 0 || R < 0; }

#ifdef __CUDACC__

// A kernel's dynamic shared-memory limit is an attribute of the current
// device: raise it to MAX_SMEM once on each device the process launches
// on. `done` is the calling kernel's own table, indexed by device.
constexpr int MAX_DEVICES = 64;

template <class Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// -- single: one warp per row ----------------------------------------------------

__global__ void __launch_bounds__(WARPS * LANES)
single_kernel(const int32_t* __restrict__ loads, const int32_t* __restrict__ free,
              const int32_t* __restrict__ fleet, const int32_t* __restrict__ cap, int64_t N,
              int64_t R, bool* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / LANES;
  if (row >= N) return;  // the whole warp: a row is one warp
  const int lane = threadIdx.x % LANES;
  bool ok = true;
  for (int64_t r = lane; r < R; r += LANES) {
    ok = ok && single_column(loads, free, fleet, cap, N, R, row, r);
  }
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) out[row] = ok;
}

// -- Hopper's bulk copies (TMA), completing on an mbarrier in shared memory -----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// The initialized barriers visible to the copy engine (the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// An arrival, with the bytes of the copies it answers for.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory, counted off the barrier's expected bytes as they land.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// The 16-byte blocks that hold [p, p + bytes): → (their start, their size).
__device__ __forceinline__ const unsigned char* cover(const void* p, int64_t bytes, unsigned* size) {
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  *size = static_cast<unsigned>((a + bytes + 15) & ~int64_t{15});
  return static_cast<const unsigned char*>(p) - a;
}

// -- subset: one thread per row over staged candidates ---------------------------

// A staged candidate: its C loads, C zeros, its C free, each third padded
// to 16 bytes (H floats). A row reads two thirds from where its select
// puts it: loads and zeros when the candidate is masked, zeros and free
// when it is not; one address select for the candidate, not one select a
// column, and every lane of a warp reads within the same 48 bytes.
template <int C>
struct Staged {
  static constexpr int H = (C + 3) / 4 * 4;
  static constexpr int STRIDE = 3 * H;
};

// Bytes that hold n bytes copied at any 16-byte offset, in whole blocks.
HD int64_t covered(int64_t n) { return (n + 31) / 16 * 16; }

// The subset kernel's shared memory: two barriers; the chunk's staged
// candidates [tile][STRIDE] floats; one buffer when N is one tile, else
// two (the tile being added, the next in flight), of raw rows of loads
// and of free ([tile][R] int32 each, at their global alignment) and of
// mask rows ([ROWS][pitch] bytes); fleet and cap (at their global
// alignment).
struct SubsetLayout {
  int64_t floats, raw, masks, fc, bytes, raw_bytes;
  HD SubsetLayout(int tile, int64_t R, int stride, int buffers) {
    raw_bytes = covered(static_cast<int64_t>(tile) * R * 4);
    floats = 16;
    raw = floats + static_cast<int64_t>(tile) * stride * 4;
    masks = raw + 2 * buffers * raw_bytes;
    fc = masks + buffers * static_cast<int64_t>(SUBSET_ROWS) * (tile + MASK_PAD);
    bytes = fc + 2 * covered(R * 4);
  }
  HD int64_t raw_at(int b, int which) const { return raw + (2 * b + which) * raw_bytes; }  // 0 loads, 1 free
};

// Mask row r of a buffer: its copy starts at the row's first 16-byte
// aligned byte in shared memory, with the 16-byte block that holds its
// byte n0 (whose address is g); → where byte n0 lands in the row's pitch.
__device__ __forceinline__ int mask_offset(const uint8_t* g, int r, int pitch) {
  return (16 - (r * pitch) % 16) % 16 + static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
}

// A batch of U candidates of a subset row (U a multiple of 4): the
// aligned 32-bit words that hold its U mask bytes at any byte offset.
template <int C>
struct Words {
  static constexpr int U = C <= 4 ? 8 : 4;
  static constexpr int W = U / 4 + 1;
  uint32_t w[W];
};

// The batch's addends, selected: a masked candidate's loads and zeros for
// its free, zeros and its free when it is not masked.
template <int C>
struct Batch {
  float l[Words<C>::U][Staged<C>::H], f[Words<C>::U][Staged<C>::H];
};

template <int C>
__device__ __forceinline__ void load_words(Words<C>& wd, const uint32_t* mwords, int j0) {
#pragma unroll
  for (int q = 0; q < Words<C>::W; ++q) wd.w[q] = mwords[j0 / 4 + q];
}

// The batch's addends, two thirds of each staged candidate from where
// the mask byte's select puts them.
template <int C>
__device__ __forceinline__ void load_batch(Batch<C>& b, const Words<C>& wd, unsigned shift, const float* cand,
                                           int j0) {
  constexpr int H = Staged<C>::H, STRIDE = Staged<C>::STRIDE;
#pragma unroll
  for (int q = 0; q < Words<C>::U / 4; ++q) {
    const uint32_t bytes = __funnelshift_r(wd.w[q], wd.w[q + 1], shift);
#pragma unroll
    for (int u = 4 * q; u < 4 * q + 4; ++u) {
      const bool m = (bytes & (0xffu << (8 * (u - 4 * q)))) != 0;
      const float* at = cand + (j0 + u) * STRIDE + (m ? 0 : H);
      const float4* pl = reinterpret_cast<const float4*>(at);
      const float4* pf = reinterpret_cast<const float4*>(at + H);
#pragma unroll
      for (int h = 0; h < H / 4; ++h) {
        const float4 xl = pl[h], xf = pf[h];
        b.l[u][4 * h] = xl.x;
        b.l[u][4 * h + 1] = xl.y;
        b.l[u][4 * h + 2] = xl.z;
        b.l[u][4 * h + 3] = xl.w;
        b.f[u][4 * h] = xf.x;
        b.f[u][4 * h + 1] = xf.y;
        b.f[u][4 * h + 2] = xf.z;
        b.f[u][4 * h + 3] = xf.w;
      }
    }
  }
}

// The batch's candidates in order, onto the row's 2C sums.
template <int C>
__device__ __forceinline__ void add_batch(const Batch<C>& b, float (&load)[C], float (&surviving)[C]) {
#pragma unroll
  for (int u = 0; u < Words<C>::U; ++u) {
#pragma unroll
    for (int c = 0; c < C; ++c) subset_add(b.l[u][c], b.f[u][c], load[c], surviving[c]);
  }
}

template <int C>
__global__ void __launch_bounds__(SUBSET_THREADS)
subset_kernel(const uint8_t* __restrict__ masks, const int32_t* __restrict__ loads,
              const int32_t* __restrict__ free, const int32_t* __restrict__ fleet,
              const int32_t* __restrict__ cap, int64_t S, int64_t N, int64_t R, int tile,
              bool* __restrict__ out) {
  constexpr int H = Staged<C>::H, STRIDE = Staged<C>::STRIDE;
  constexpr int U = Words<C>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = N > 0 ? static_cast<int>((N + tile - 1) / tile) : 1;
  const bool one_tile = tiles == 1;  // staged once, for every chunk
  const SubsetLayout lay(tile, R, STRIDE, one_tile ? 1 : 2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* cand = reinterpret_cast<float*>(smem + lay.floats);
  const int pitch = tile + MASK_PAD;
  const int64_t fc_bytes = covered(R * 4);
  const int32_t* fleet_s = reinterpret_cast<const int32_t*>(smem + lay.fc + (reinterpret_cast<uintptr_t>(fleet) & 15));
  const int32_t* cap_s = reinterpret_cast<const int32_t*>(smem + lay.fc + fc_bytes + (reinterpret_cast<uintptr_t>(cap) & 15));
  const int tid = threadIdx.x;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * SUBSET_ROWS;
  const int rows_here = static_cast<int>(imin(SUBSET_ROWS, S - s0));
  const int chunks = static_cast<int>((R + C - 1) / C);
  unsigned uses[2] = {0, 0};  // completed phases of each buffer's barrier

  // Tile t's copies into buffer b, all started by the second warp, so the
  // first never waits to issue them: the block's mask rows (one copy of
  // the block's contiguous rows when N is one tile, else a copy a lane for
  // its row), the tile's raw loads and free (lanes 0 and 1), fleet and cap
  // with the first tile (lanes 2 and 3). Lane 0 arrives on the buffer's
  // barrier with the bytes of the warp's copies, before any of them starts.
  auto stage = [&](int t, int b, bool first) {
    const int lane = tid - SUBSET_ROWS;
    if (lane < 0) return;
    const int64_t n0 = static_cast<int64_t>(t) * tile;
    const int64_t tn = imin(tile, N - n0);
    unsigned mask_size = 0, raw_size = 0;
    const unsigned char *mask_src = nullptr, *raw_src = nullptr;
    unsigned char *mask_dst = nullptr, *raw_dst = nullptr;
    if (tn > 0 && one_tile && lane == 0) {
      mask_src = cover(masks + s0 * N, rows_here * N, &mask_size);
      mask_dst = smem + lay.masks + b * SUBSET_ROWS * pitch;
    } else if (tn > 0 && !one_tile && lane < rows_here) {
      const uint8_t* g = masks + (s0 + lane) * N + n0;
      mask_src = cover(g, tn, &mask_size);
      mask_dst = smem + lay.masks + (b * SUBSET_ROWS + lane) * pitch + mask_offset(g, lane, pitch) - (g - mask_src);
    }
    if ((lane == 0 || lane == 1) && tn > 0) {
      raw_src = cover((lane ? free : loads) + n0 * R, tn * R * 4, &raw_size);
      raw_dst = smem + lay.raw_at(b, lane);
    } else if (first && (lane == 2 || lane == 3)) {
      raw_src = cover(lane == 3 ? cap : fleet, R * 4, &raw_size);
      raw_dst = smem + lay.fc + (lane - 2) * fc_bytes;
    }
    const unsigned warp_bytes = __reduce_add_sync(0xffffffffu, mask_size + raw_size);
    if (lane == 0) mbar_arrive_expect(&bars[b], warp_bytes);
    __syncwarp();
    if (mask_size > 0) bulk_copy(mask_dst, mask_src, mask_size, &bars[b]);
    if (raw_size > 0) bulk_copy(raw_dst, raw_src, raw_size, &bars[b]);
  };

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  float load[C], surviving[C];
#pragma unroll
  for (int c = 0; c < C; ++c) load[c] = surviving[c] = 0.0f;
  bool ok = true;
  if (chunks > 0) stage(0, 0, true);  // R > 0 from here on
  for (int k = 0, t = 0, b = 0; k < chunks;) {  // (chunk, tile) steps in order
    const int nk = t + 1 < tiles ? k : k + 1, nt = t + 1 < tiles ? t + 1 : 0;
    if (!one_tile && nk < chunks) stage(nt, b ^ 1, false);  // the next step's copies in flight behind this one
    if (!one_tile || k == 0) {
      mbar_wait(&bars[b], uses[b] & 1);
      ++uses[b];
    }
    const int64_t n0 = static_cast<int64_t>(t) * tile, c0 = static_cast<int64_t>(k) * C;
    const int tn = static_cast<int>(imin(tile, N - n0));
    const int w = static_cast<int>(imin(C, R - c0));
    const int padded = (tn + U - 1) / U * U;
    // the chunk's columns of the tile, float32 once, zero past the tile
    // and past R (adding +0.0 leaves a sum as it is)
    const int32_t* raw_l = reinterpret_cast<const int32_t*>(
        smem + lay.raw_at(b, 0) + (reinterpret_cast<uintptr_t>(loads + n0 * R) & 15));
    const int32_t* raw_f = reinterpret_cast<const int32_t*>(
        smem + lay.raw_at(b, 1) + (reinterpret_cast<uintptr_t>(free + n0 * R) & 15));
    const int r = static_cast<int>(R), c0i = static_cast<int>(c0);  // a tile holds under 2^16 values
#pragma unroll 4
    for (int e = tid; e < padded * C; e += SUBSET_THREADS) {
      const int n = e / C, c = e - n * C;
      const bool in = n < tn && c < w;
      cand[n * STRIDE + c] = in ? to_f32(raw_l[n * r + c0i + c]) : 0.0f;
      cand[n * STRIDE + H + c] = 0.0f;
      cand[n * STRIDE + 2 * H + c] = in ? to_f32(raw_f[n * r + c0i + c]) : 0.0f;
    }
    __syncthreads();
    if (tid < rows_here) {
      // the row's mask bytes as aligned words, from the word that holds
      // byte n0, and how far into it byte n0 sits: in the block's rows as
      // they lie in device memory, or in the row's pitch
      const uint8_t* g = masks + (s0 + tid) * N + n0;
      const int64_t at = one_tile ? static_cast<int64_t>(reinterpret_cast<uintptr_t>(masks + s0 * N) & 15) + tid * N
                                  : static_cast<int64_t>(tid) * pitch + mask_offset(g, tid, pitch);
      const uint32_t* mwords = reinterpret_cast<const uint32_t*>(
          smem + lay.masks + b * SUBSET_ROWS * pitch + (at & ~int64_t{3}));
      const unsigned shift = 8u * (at & 3);
      // a pipeline in registers: the mask words two batches ahead of the
      // adds, the selected addends one batch ahead, so every shared load
      // is in flight behind a batch of adds
      Words<C> w0, w1;
      Batch<C> x, y;
      if (padded > 0) {
        load_words(w0, mwords, 0);
        load_batch(x, w0, shift, cand, 0);
      }
      if (U < padded) load_words(w1, mwords, U);
      for (int j0 = 0; j0 < padded; j0 += 2 * U) {
        if (j0 + U < padded) {
          load_batch(y, w1, shift, cand, j0 + U);
          if (j0 + 2 * U < padded) load_words(w0, mwords, j0 + 2 * U);
        }
        add_batch(x, load, surviving);
        if (j0 + U >= padded) break;
        if (j0 + 2 * U < padded) {
          load_batch(x, w0, shift, cand, j0 + 2 * U);
          if (j0 + 3 * U < padded) load_words(w1, mwords, j0 + 3 * U);
        }
        add_batch(y, load, surviving);
      }
    }
    if (t == tiles - 1) {  // the chunk's last tile: its columns' verdicts
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < w) ok = fits(load[c], surviving[c], fleet_s, cap_s, c0 + c) && ok;
        load[c] = surviving[c] = 0.0f;
      }
    }
    __syncthreads();  // buffer b and the floats are free for the steps after
    k = nk;
    t = nt;
    if (!one_tile) b ^= 1;
  }
  if (tid < rows_here) out[s0 + tid] = ok;
}

// The tile of candidates: all of N (rounded up to 8) in one buffer when
// that fits a block's shared memory and N <= SUBSET_ONE_TILE, else the
// longest multiple of 8 up to SUBSET_TILE whose two buffers fit; 0 when
// not even 8 do.
template <int C>
int subset_tile(int64_t N, int64_t R) {
  const int whole = static_cast<int>(N > 8 ? (N + 7) / 8 * 8 : 8);
  if (N <= SUBSET_ONE_TILE && SubsetLayout(whole, R, Staged<C>::STRIDE, 1).bytes <= MAX_SMEM) return whole;
  int tile = static_cast<int>(imin(SUBSET_TILE, whole));
  while (tile >= 8 && SubsetLayout(tile, R, Staged<C>::STRIDE, 2).bytes > MAX_SMEM) tile -= 8;
  return tile >= 8 ? tile : 0;
}

template <int C>
int launch_subsets_c(const uint8_t* masks, const int32_t* loads, const int32_t* free,
                     const int32_t* fleet, const int32_t* cap, int64_t S, int64_t N, int64_t R,
                     bool* out, cudaStream_t stream) {
  static std::atomic<bool> attr_set[MAX_DEVICES];
  const cudaError_t attr = allow_max_smem(subset_kernel<C>, attr_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tile = subset_tile<C>(N, R);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int buffers = N <= tile ? 1 : 2;
  const size_t bytes = static_cast<size_t>(SubsetLayout(tile, R, Staged<C>::STRIDE, buffers).bytes);
  const int64_t blocks = (S + SUBSET_ROWS - 1) / SUBSET_ROWS;
  subset_kernel<C><<<static_cast<unsigned>(blocks), SUBSET_THREADS, bytes, stream>>>(
      masks, loads, free, fleet, cap, S, N, R, tile, out);
  return static_cast<int>(cudaGetLastError());
}

// -- prefix: one pass of running sums --------------------------------------------

// Column-major running sums: a column's slots are padded to whole
// batches of 16 (zeros: adding +0.0 leaves a sum as it is) plus 4 floats,
// so the threads' columns start on distinct banks.
HD int64_t prefix_pitch(int64_t tile) { return (tile + 15) / 16 * 16 + 4; }

// NC columns of a prefix tile side by side, each in candidate order (NC
// independent chains), 16 candidates a batch in registers, two batches
// in turn. WRITE: store the running sums back in place.
template <int NC>
struct PrefixBatch {
  float4 x[NC][4];
};

template <int NC>
__device__ __forceinline__ void prefix_load(PrefixBatch<NC>& p, float* const (&col)[NC], int64_t k) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) p.x[j][q] = reinterpret_cast<const float4*>(col[j])[4 * k + q];
}

template <int NC, bool WRITE>
__device__ __forceinline__ void prefix_run(PrefixBatch<NC>& p, float (&acc)[NC], float* const (&col)[NC],
                                           int64_t k) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      running(acc[j], p.x[j][q].x);
      running(acc[j], p.x[j][q].y);
      running(acc[j], p.x[j][q].z);
      running(acc[j], p.x[j][q].w);
    }
  }
  if (WRITE) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) reinterpret_cast<float4*>(col[j])[4 * k + q] = p.x[j][q];
  }
}

template <int NC, bool WRITE>
__device__ __forceinline__ void prefix_walk(float (&acc)[NC], float* const (&col)[NC], int64_t tn) {
  const int64_t batches = (tn + 15) / 16;
  PrefixBatch<NC> a, b;
  if (batches > 0) prefix_load(a, col, 0);
  if (batches > 1) prefix_load(b, col, 1);
  // each batch's loads are issued two batches ahead, in their own branch,
  // so the compiler keeps them ahead of the other batch's adds
  for (int64_t k = 0; k < batches; k += 2) {
    prefix_run<NC, WRITE>(a, acc, col, k);
    if (k + 2 < batches) prefix_load(a, col, k + 2);
    if (k + 1 >= batches) break;
    prefix_run<NC, WRITE>(b, acc, col, k + 1);
    if (k + 3 < batches) prefix_load(b, col, k + 3);
  }
}

// The prefix kernel's shared memory: a barrier; the running sums, column
// by column ([R][pitch] floats each for loads and free); totals and
// carries ([R] each); the tile's raw rows of loads and free ([tile][R]
// int32) and fleet and cap, each at its global alignment.
struct PrefixLayout {
  int64_t pitch, cl, cf, total, carry_l, carry_f, raw_l, raw_f, fleet, cap, bytes;
  HD PrefixLayout(int64_t tile, int64_t R) {
    pitch = prefix_pitch(tile);
    cl = 16;
    cf = cl + R * pitch * 4;
    total = cf + R * pitch * 4;
    carry_l = total + R * 4;
    carry_f = carry_l + R * 4;
    raw_l = (carry_f + R * 4 + 15) / 16 * 16;
    raw_f = raw_l + covered(tile * R * 4);
    fleet = raw_f + covered(tile * R * 4);
    cap = fleet + covered(R * 4);
    bytes = cap + covered(R * 4);
  }
};

__global__ void __launch_bounds__(PREFIX_THREADS)
prefix_kernel(const int32_t* __restrict__ loads, const int32_t* __restrict__ free,
              const int32_t* __restrict__ fleet, const int32_t* __restrict__ cap, int64_t N,
              int64_t R, int64_t tile, bool* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PrefixLayout lay(tile, R);
  const int64_t pitch = lay.pitch;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* cl = reinterpret_cast<float*>(smem + lay.cl);  // loads, then running loads
  float* cf = reinterpret_cast<float*>(smem + lay.cf);  // free, then running free
  float* total = reinterpret_cast<float*>(smem + lay.total);
  float* carry_l = reinterpret_cast<float*>(smem + lay.carry_l);  // running sums past the last tile
  float* carry_f = reinterpret_cast<float*>(smem + lay.carry_f);
  const auto at = [&](int64_t off, const void* g) {  // a copy's data, at its global alignment
    return reinterpret_cast<const int32_t*>(smem + off + (reinterpret_cast<uintptr_t>(g) & 15));
  };
  const int32_t* fleet_s = at(lay.fleet, fleet);
  const int32_t* cap_s = at(lay.cap, cap);
  const int tid = threadIdx.x;
  const int64_t tiles = (N + tile - 1) / tile;
  unsigned phase = 0;
  // The tile's rows n0 .. n0 + tn - 1 into columns, float32, zero-padded
  // to whole batches: one thread starts the bulk copies (raw loads only
  // when wanted, fleet and cap with the first), every thread converts.
  auto stage = [&](int64_t n0, int64_t tn, bool with_loads, bool first) {
    const int padded = static_cast<int>((tn + 15) / 16 * 16), r = static_cast<int>(R);
    if (tid == 0) {
      unsigned sl = 0, sf = 0, sfl = 0, sc = 0;
      const unsigned char* gl = with_loads ? cover(loads + n0 * R, tn * R * 4, &sl) : nullptr;
      const unsigned char* gf = cover(free + n0 * R, tn * R * 4, &sf);
      const unsigned char* gfl = first ? cover(fleet, R * 4, &sfl) : nullptr;
      const unsigned char* gc = first ? cover(cap, R * 4, &sc) : nullptr;
      mbar_arrive_expect(bar, sl + sf + sfl + sc);
      if (sl > 0) bulk_copy(smem + lay.raw_l, gl, sl, bar);
      if (sf > 0) bulk_copy(smem + lay.raw_f, gf, sf, bar);
      if (sfl > 0) bulk_copy(smem + lay.fleet, gfl, sfl, bar);
      if (sc > 0) bulk_copy(smem + lay.cap, gc, sc, bar);
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    const int32_t* rl = at(lay.raw_l, loads + n0 * R);
    const int32_t* rf = at(lay.raw_f, free + n0 * R);
    for (int e = tid; e < padded * r; e += PREFIX_THREADS) {  // a tile holds under 2^16 values
      const int n = e / r, c = e - n * r;
      const bool in = n < tn;
      cf[c * pitch + n] = in ? to_f32(rf[e]) : 0.0f;
      if (with_loads) cl[c * pitch + n] = in ? to_f32(rl[e]) : 0.0f;
    }
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  for (int64_t c = tid; c < R; c += PREFIX_THREADS) carry_l[c] = carry_f[c] = 0.0f;
  __syncthreads();
  if (tiles > 1) {  // first walk: the total free, the same fold as the running sum at N - 1
    for (int64_t t = 0; t < tiles; ++t) {
      const int64_t n0 = t * tile, tn = imin(tile, N - n0);
      stage(n0, tn, false, t == 0);
      __syncthreads();
      for (int64_t c = tid; c < R; c += PREFIX_THREADS) {
        float acc[1] = {carry_f[c]};
        float* const col[1] = {cf + c * pitch};
        prefix_walk<1, false>(acc, col, tn);
        carry_f[c] = acc[0];
      }
      __syncthreads();
    }
    for (int64_t c = tid; c < R; c += PREFIX_THREADS) {
      total[c] = carry_f[c];
      carry_f[c] = 0.0f;
    }
  }
  for (int64_t t = 0; t < tiles; ++t) {
    const int64_t n0 = t * tile, tn = imin(tile, N - n0);
    stage(n0, tn, true, tiles == 1);
    __syncthreads();
    for (int64_t c = tid; c < R; c += PREFIX_THREADS) {
      float acc[2] = {carry_l[c], carry_f[c]};
      float* const col[2] = {cl + c * pitch, cf + c * pitch};
      prefix_walk<2, true>(acc, col, tn);  // the running load and the running free together
      carry_l[c] = acc[0];
      carry_f[c] = acc[1];
      if (tiles == 1) total[c] = acc[1];
    }
    __syncthreads();
    for (int64_t k = tid; k < tn; k += PREFIX_THREADS) {
      bool ok = true;
      for (int64_t c = 0; c < R; ++c) {
        ok = fits(cl[c * pitch + k], sub(total[c], cf[c * pitch + k]), fleet_s, cap_s, c) && ok;
      }
      out[n0 + k] = ok;
    }
    __syncthreads();
  }
}

int launch_prefix(const int32_t* loads, const int32_t* free, const int32_t* fleet,
                  const int32_t* cap, int64_t N, int64_t R, bool* out, cudaStream_t stream) {
  static std::atomic<bool> attr_set[MAX_DEVICES];
  const cudaError_t attr = allow_max_smem(prefix_kernel, attr_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the longest tile (all of N, or a multiple of 16) whose buffers fit
  int64_t tile = N;
  if (PrefixLayout(tile, R).bytes > MAX_SMEM) {
    tile = imin(N, MAX_SMEM / (16 * (R > 0 ? R : 1))) / 16 * 16;
    while (tile >= 16 && PrefixLayout(tile, R).bytes > MAX_SMEM) tile -= 16;
    if (tile < 16) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = static_cast<size_t>(PrefixLayout(tile, R).bytes);
  prefix_kernel<<<1, PREFIX_THREADS, bytes, stream>>>(loads, free, fleet, cap, N, R, tile, out);
  return static_cast<int>(cudaGetLastError());
}

#else

// -- the host build: the same steps in the card's order --------------------------

int prefix_host(const int32_t* loads, const int32_t* free, const int32_t* fleet, const int32_t* cap,
                int64_t N, int64_t R, uint8_t* out) {
  std::vector<float> cl(N * R), cf(N * R), total(R, 0.0f);
  for (int64_t e = 0; e < N * R; ++e) {
    cl[e] = to_f32(loads[e]);
    cf[e] = to_f32(free[e]);
  }
  for (int64_t c = 0; c < R; ++c) {
    float a = 0.0f, f = 0.0f;
    for (int64_t k = 0; k < N; ++k) {
      running(a, cl[k * R + c]);
      running(f, cf[k * R + c]);
    }
    total[c] = f;
  }
  for (int64_t k = 0; k < N; ++k) {
    bool ok = true;
    for (int64_t c = 0; c < R; ++c) ok = fits(cl[k * R + c], sub(total[c], cf[k * R + c]), fleet, cap, c) && ok;
    out[k] = ok ? 1 : 0;
  }
  return 0;
}

int subsets_host(const uint8_t* masks, const int32_t* loads, const int32_t* free,
                 const int32_t* fleet, const int32_t* cap, int64_t S, int64_t N, int64_t R,
                 uint8_t* out) {
  for (int64_t s = 0; s < S; ++s) {
    bool ok = true;
    for (int64_t c0 = 0; c0 < R; c0 += CHUNK) {
      const int w = static_cast<int>(imin(CHUNK, R - c0));
      float load[CHUNK] = {}, surviving[CHUNK] = {};
      for (int64_t n = 0; n < N; ++n) {
        const bool m = masks[s * N + n] != 0;
        for (int c = 0; c < w; ++c) {
          subset_step(m, to_f32(loads[n * R + c0 + c]), to_f32(free[n * R + c0 + c]), load[c], surviving[c]);
        }
      }
      for (int c = 0; c < w; ++c) ok = fits(load[c], surviving[c], fleet, cap, c0 + c) && ok;
    }
    out[s] = ok ? 1 : 0;
  }
  return 0;
}

int singles_host(const int32_t* loads, const int32_t* free, const int32_t* fleet, const int32_t* cap,
                 int64_t N, int64_t R, uint8_t* out) {
  for (int64_t i = 0; i < N; ++i) {
    bool ok = true;
    for (int64_t r = 0; r < R; ++r) ok = single_column(loads, free, fleet, cap, N, R, i, r) && ok;
    out[i] = ok ? 1 : 0;
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
  if (bad_args(N, N, R)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  return launch_prefix(static_cast<const int32_t*>(loads), static_cast<const int32_t*>(free),
                       static_cast<const int32_t*>(fleet), static_cast<const int32_t*>(cap), N, R,
                       static_cast<bool*>(out), static_cast<cudaStream_t>(stream));
}

int disrupt_subsets_launch(const void* masks, const void* loads, const void* free,
                           const void* fleet, const void* cap, int64_t S, int64_t N, int64_t R,
                           void* out, void* stream) {
  if (bad_args(S, N, R)) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const auto* m = static_cast<const uint8_t*>(masks);
  const auto* l = static_cast<const int32_t*>(loads);
  const auto* f = static_cast<const int32_t*>(free);
  const auto* fl = static_cast<const int32_t*>(fleet);
  const auto* cp = static_cast<const int32_t*>(cap);
  auto* o = static_cast<bool*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (imin(R, CHUNK)) {  // the chunk's width: R itself up to 8 columns
    case 0:
    case 1: return launch_subsets_c<1>(m, l, f, fl, cp, S, N, R, o, st);
    case 2: return launch_subsets_c<2>(m, l, f, fl, cp, S, N, R, o, st);
    case 3: return launch_subsets_c<3>(m, l, f, fl, cp, S, N, R, o, st);
    case 4: return launch_subsets_c<4>(m, l, f, fl, cp, S, N, R, o, st);
    case 5: return launch_subsets_c<5>(m, l, f, fl, cp, S, N, R, o, st);
    case 6: return launch_subsets_c<6>(m, l, f, fl, cp, S, N, R, o, st);
    case 7: return launch_subsets_c<7>(m, l, f, fl, cp, S, N, R, o, st);
    default: return launch_subsets_c<CHUNK>(m, l, f, fl, cp, S, N, R, o, st);
  }
}

int disrupt_singles_launch(const void* loads, const void* free, const void* fleet, const void* cap,
                           int64_t N, int64_t R, void* out, void* stream) {
  if (bad_args(N, N, R)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (N + WARPS - 1) / WARPS;
  single_kernel<<<static_cast<unsigned>(blocks), WARPS * LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(loads), static_cast<const int32_t*>(free),
      static_cast<const int32_t*>(fleet), static_cast<const int32_t*>(cap), N, R,
      static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same steps on the CPU, host pointers; out holds 0 or 1.
int disrupt_prefix_host(const void* loads, const void* free, const void* fleet, const void* cap,
                        int64_t N, int64_t R, void* out) {
  if (bad_args(N, N, R)) return 1;
  return prefix_host(static_cast<const int32_t*>(loads), static_cast<const int32_t*>(free),
                     static_cast<const int32_t*>(fleet), static_cast<const int32_t*>(cap), N, R,
                     static_cast<uint8_t*>(out));
}

int disrupt_subsets_host(const void* masks, const void* loads, const void* free,
                         const void* fleet, const void* cap, int64_t S, int64_t N, int64_t R,
                         void* out) {
  if (bad_args(S, N, R)) return 1;
  return subsets_host(static_cast<const uint8_t*>(masks), static_cast<const int32_t*>(loads),
                      static_cast<const int32_t*>(free), static_cast<const int32_t*>(fleet),
                      static_cast<const int32_t*>(cap), S, N, R, static_cast<uint8_t*>(out));
}

int disrupt_singles_host(const void* loads, const void* free, const void* fleet, const void* cap,
                         int64_t N, int64_t R, void* out) {
  if (bad_args(N, N, R)) return 1;
  return singles_host(static_cast<const int32_t*>(loads), static_cast<const int32_t*>(free),
                      static_cast<const int32_t*>(fleet), static_cast<const int32_t*>(cap), N, R,
                      static_cast<uint8_t*>(out));
}
#endif

}  // extern "C"
