// Signature x instance-type "allowed" matrix for Hopper (sm_90a):
// requirement compat AND offering availability AND signature validity,
// written once as (S, T) uint8.
//
// Replaces karpenter_core_tpu/solver/pallas_kernels.py::compat_pallas
// (body _compat_tile_kernel, one MXU matmul per key over 128-lane f32
// chunks) and ::allowed_pallas (compat AND valid AND offering_kernel).
//
// What it computes. The host (solver/compat_kernels.py::pack_side) packs
// each key's 0/1 mask into 32-bit words and appends three flag bits
// after a requirement key's Vk value bits:
//     bit   signature side   type side
//     U_s   !has_s           1
//     U_t   1                !has_t
//     N     neg_s            neg_t
// so any(sig_word & typ_word) over the key's words is exactly
//     !(has_s & has_t) | overlap | (neg_s & neg_t)
// (requirements.go Intersects with the both-negative carve-out). The
// offering is one more key over the flattened zone x capacity-type axis
// (sig bits = zone_ok x ct_ok x valid, type bits = avail), without flag
// bits: an invalid signature's offering bits are zero, so its cells are
// 0. A cell keeps ok = min(ok, x_k), x_k the OR of sig & typ over key k's
// words, and its result is ok != 0: one LOP3 per cell-word and one IMNMX
// per cell-key, with nothing else in the inner loop. Pad bits are zero
// on both sides.
//
// Layout. Both sides are word-major planes: word w of signature s at
// sig[w * sig_ld + s], of type t at typ[w * typ_ld + t], so a chunk of
// words is a tile of rows that stage contiguously along S and T.
// key_off (K + 1 int32) gives each key's first word; every key has at
// least one word and key_off[K] = W.
//
// Tiling. A thread owns R signature rows x C type columns of cells in
// registers (ok and the open key's x). Words stream through a ring of
// NSTAGE shared-memory stages of WC words each, filled with 16-byte
// cp.async copies, so the next chunk lands while this one is walked; per
// word a thread reads its R signature words and C type words as 16-byte
// vectors. Key offsets sit in shared memory; the key walk is uniform
// across the block. Two instantiations, picked by the wrapper on S:
//   Large: 8 x 4 cells per thread, 8 x 16 threads, a 64 x 64 block, 2
//          stages of 32 words; per word 3 LDS.128 feed 32 LOP3;
//   Small: 4 x 1 cells per thread, 64 threads along T, a 4 x 64 block, 2
//          stages of 64 words, so the solve's S = 4 leaves no idle rows,
//          spreads over ceil(T / 64) blocks and walks W in few chunks
//          (one block's walk is a serial chain of W words: each chunk's
//          wait and barrier lengthens it).
// The result is written once, coalesced along T: the large tile stores 4
// cells per 32-bit store when T is a multiple of 4.
//
// Bound. Bytes: (S + T) * W * 4 read, S * T written. Operations: one
// LOP3 per (s, t, word) and one IMNMX per (s, t, key), on the CUDA
// cores' 64 32-bit logic results per clock per SM: S * T * (W + K) /
// (132 * 64 * f_SM). At S = 8192 x T = 2048 x W = 133 that is about
// 0.14 ms, and operations bound it; at the solve's S = 4 bytes bound it
// at well under a microsecond and launch latency dominates.
//
// Host build. The tile body (stage / walk / write) is __host__ __device__.
// Compiled by g++ as C++ (no __CUDACC__), this file exports
// compat_allowed_host instead of the launch: it runs the same tile body,
// ring stages included, block by block and thread by thread on the CPU,
// so the tests check the kernel's indexing, staging and padding against
// the reference without a card (tests/test_torch_compat.py).

#include <cstdint>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TILE_FN __host__ __device__ __forceinline__
#else
#define TILE_FN inline
#endif
#ifdef __CUDA_ARCH__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
#endif

namespace {

constexpr int MAX_KEYS = 1023;  // key offsets held in shared memory
constexpr int TILE_SMALL = 0;
constexpr int TILE_LARGE = 1;

// the launch contract: key count, tile shape, 16-byte-aligned planes with
// a pitch of 4k words
bool bad_args(const void* sig, const void* typ, int64_t K, int64_t sig_ld, int64_t typ_ld,
              int tile) {
  const auto aligned = [](const void* p, int64_t ld) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
  };
  return K < 1 || K > MAX_KEYS || (tile != TILE_SMALL && tile != TILE_LARGE) ||
         !aligned(sig, sig_ld) || !aligned(typ, typ_ld);
}

struct Args {
  const uint32_t* __restrict__ sig;      // (W, sig_ld) word-major
  const uint32_t* __restrict__ typ;      // (W, typ_ld) word-major
  const int32_t* __restrict__ key_off;   // (K + 1,)
  int64_t S, T, W, K, sig_ld, typ_ld;
  uint8_t* __restrict__ out;             // (S, T)
};

// R rows x C consecutive columns per thread, TS x TT threads, NSTAGE
// ring stages of WC words
template <int R_, int C_, int TS_, int TT_, int WC_, int NSTAGE_>
struct Shape {
  static constexpr int R = R_, C = C_, TS = TS_, TT = TT_, THREADS = TS_ * TT_;
  static constexpr int TILE_S = R_ * TS_, TILE_T = C_ * TT_;
  static constexpr int WC = WC_, NSTAGE = NSTAGE_;
};
using Large = Shape<8, 4, 8, 16, 32, 2>;  // 64 x 64, 128 threads
using Small = Shape<4, 1, 1, 64, 64, 2>;  // 4 x 64, 64 threads

template <class SH>
struct Tiles {
  alignas(16) uint32_t sig[SH::NSTAGE][SH::WC][SH::TILE_S];
  alignas(16) uint32_t typ[SH::NSTAGE][SH::WC][SH::TILE_T];
  int32_t koff[MAX_KEYS + 1];
};

template <class SH>
struct Cells {
  uint32_t ok[SH::R][SH::C];
  uint32_t x[SH::R][SH::C];
  int k;  // the open key (the same in every thread of a block)
};

template <class SH>
TILE_FN void init_cells(Cells<SH>& c) {
  UNROLL
  for (int i = 0; i < SH::R; ++i) {
    UNROLL
    for (int j = 0; j < SH::C; ++j) {
      c.ok[i][j] = 0xffffffffu;
      c.x[i][j] = 0u;
    }
  }
  c.k = 0;
}

// four words (16 bytes) into shared memory; zero where `ok` is false
TILE_FN void copy4(uint32_t* dst, const uint32_t* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
#else
  for (int q = 0; q < 4; ++q) dst[q] = ok ? src[q] : 0u;
#endif
}

TILE_FN void commit_stage() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
TILE_FN void wait_stages() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// N words from 16-byte-aligned shared memory
template <int N>
TILE_FN void load_words(const uint32_t* p, uint32_t (&v)[N]) {
#ifdef __CUDA_ARCH__
  if constexpr (N % 4 == 0) {
    UNROLL
    for (int q = 0; q < N / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else {
    UNROLL
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
#else
  for (int q = 0; q < N; ++q) v[q] = p[q];
#endif
}

// thread `tid` copies its share of words [w0, w0 + wn) of rows [n0, n0 +
// N) of one plane into dst, 16 bytes per copy, a fixed count per thread:
// consecutive threads take consecutive rows of one word (coalesced). A
// copy that starts below n may read up to 3 rows past it; they lie in
// the plane's padded storage (compat_kernels.to_planes)
template <class SH, int N>
TILE_FN void stage_plane(uint32_t (*dst)[N], const uint32_t* plane, int64_t ld, int64_t n0,
                         int64_t n, int64_t w0, int wn, int tid) {
  constexpr int PER_ROW = N / 4;
  constexpr int TOTAL = SH::WC * PER_ROW;
  const uint32_t* base = plane + w0 * ld + n0;
  UNROLL
  for (int it = 0; it < (TOTAL + SH::THREADS - 1) / SH::THREADS; ++it) {
    const int idx = tid + it * SH::THREADS;
    if (TOTAL % SH::THREADS != 0 && idx >= TOTAL) break;
    const int w = idx / PER_ROW, r = (idx % PER_ROW) * 4;
    const bool ok = w < wn && n0 + r < n;
    copy4(&dst[w][r], ok ? base + w * ld + r : plane, ok);
  }
}

// thread `tid` stages its share of words [w0, w0 + wn) into ring stage `st`
template <class SH>
TILE_FN void stage(const Args& a, Tiles<SH>& sh, int st, int tid, int64_t s0, int64_t t0,
                   int64_t w0, int wn) {
  stage_plane<SH, SH::TILE_S>(sh.sig[st], a.sig, a.sig_ld, s0, a.S, w0, wn, tid);
  stage_plane<SH, SH::TILE_T>(sh.typ[st], a.typ, a.typ_ld, t0, a.T, w0, wn, tid);
}

// thread (tx, ty)'s R signature words and C type words of word w
template <class SH>
TILE_FN void load_row(const Tiles<SH>& sh, int st, int w, int tx, int ty, uint32_t (&sv)[SH::R],
                      uint32_t (&tv)[SH::C]) {
  load_words<SH::R>(&sh.sig[st][w][ty * SH::R], sv);
  load_words<SH::C>(&sh.typ[st][w][tx * SH::C], tv);
}

// fold words [wa, wb) of ring stage `st` into the open key's x; `fresh`
// when wa is the key's first word (x starts from that word's AND)
template <class SH>
TILE_FN void walk_words(const Tiles<SH>& sh, int st, int wa, int wb, bool fresh, Cells<SH>& c,
                        int tx, int ty) {
  uint32_t sv[SH::R];
  uint32_t tv[SH::C];
  int w = wa;
  if (fresh && w < wb) {
    load_row<SH>(sh, st, w, tx, ty, sv, tv);
    UNROLL
    for (int i = 0; i < SH::R; ++i) {
      UNROLL
      for (int j = 0; j < SH::C; ++j) c.x[i][j] = sv[i] & tv[j];
    }
    ++w;
  }
  for (; w < wb; ++w) {
    load_row<SH>(sh, st, w, tx, ty, sv, tv);
    UNROLL
    for (int i = 0; i < SH::R; ++i) {
      UNROLL
      for (int j = 0; j < SH::C; ++j) c.x[i][j] |= sv[i] & tv[j];
    }
  }
}

TILE_FN uint32_t umin32(uint32_t a, uint32_t b) { return a < b ? a : b; }

// walk the chunk [w0, w0 + wn) of ring stage `st`, closing each key at
// its last word
template <class SH>
TILE_FN void walk(const Tiles<SH>& sh, int st, int64_t w0, int wn, Cells<SH>& c, int tx,
                  int ty) {
  int w = 0;
  while (w < wn) {
    const int64_t kbeg = sh.koff[c.k];
    const int64_t kend = sh.koff[c.k + 1];
    const int e = kend - w0 < wn ? static_cast<int>(kend - w0) : wn;
    walk_words<SH>(sh, st, w, e, w0 + w == kbeg, c, tx, ty);
    w = e;
    if (w0 + w == kend) {
      UNROLL
      for (int i = 0; i < SH::R; ++i) {
        UNROLL
        for (int j = 0; j < SH::C; ++j) c.ok[i][j] = umin32(c.ok[i][j], c.x[i][j]);
      }
      ++c.k;
    }
  }
}

template <class SH>
TILE_FN void write(const Args& a, const Cells<SH>& c, int tx, int ty, int64_t s0, int64_t t0) {
  UNROLL
  for (int i = 0; i < SH::R; ++i) {
    const int64_t s = s0 + ty * SH::R + i;
    if (s >= a.S) continue;
    uint8_t* row = a.out + s * a.T;
    const int64_t t = t0 + tx * SH::C;
    if (SH::C == 4 && a.T % 4 == 0 && t + 3 < a.T) {
      uint32_t v = 0u;
      UNROLL
      for (int j = 0; j < SH::C; ++j) v |= static_cast<uint32_t>(c.ok[i][j] != 0u) << (8 * j);
#ifdef __CUDA_ARCH__
      *reinterpret_cast<uint32_t*>(row + t) = v;
#else
      std::memcpy(row + t, &v, 4);  // little-endian, as on the card
#endif
      continue;
    }
    UNROLL
    for (int j = 0; j < SH::C; ++j) {
      if (t + j < a.T) row[t + j] = c.ok[i][j] != 0u ? 1 : 0;
    }
  }
}

TILE_FN int chunk_words(int64_t W, int64_t w0, int wc) {
  return static_cast<int>(W - w0 < wc ? W - w0 : wc);
}

TILE_FN Args make_args(const void* sig, const void* typ, const void* key_off, int64_t S, int64_t T,
                       int64_t W, int64_t K, int64_t sig_ld, int64_t typ_ld, void* out) {
  return Args{static_cast<const uint32_t*>(sig), static_cast<const uint32_t*>(typ),
              static_cast<const int32_t*>(key_off), S, T, W, K, sig_ld, typ_ld,
              static_cast<uint8_t*>(out)};
}

#ifdef __CUDACC__
// one block: ring prologue, then per chunk wait -> sync -> refill the
// stage walked last -> walk; blockIdx.x runs along S, blockIdx.y along T
template <class SH>
__device__ __forceinline__ void block_body(const Args& a) {
  __shared__ Tiles<SH> sh;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * SH::TT + tx;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * SH::TILE_S;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * SH::TILE_T;
  for (int i = tid; i <= a.K; i += SH::THREADS) sh.koff[i] = a.key_off[i];
  const int64_t nchunks = (a.W + SH::WC - 1) / SH::WC;
  for (int c = 0; c < SH::NSTAGE - 1; ++c) {
    if (c < nchunks) {
      stage<SH>(a, sh, c, tid, s0, t0, int64_t(c) * SH::WC, chunk_words(a.W, int64_t(c) * SH::WC, SH::WC));
    }
    commit_stage();
  }
  Cells<SH> cells;
  init_cells<SH>(cells);
  for (int64_t c = 0; c < nchunks; ++c) {
    wait_stages<SH::NSTAGE - 2>();
    __syncthreads();
    const int64_t nxt = c + SH::NSTAGE - 1;
    if (nxt < nchunks) {
      stage<SH>(a, sh, static_cast<int>(nxt % SH::NSTAGE), tid, s0, t0, nxt * SH::WC,
                chunk_words(a.W, nxt * SH::WC, SH::WC));
    }
    commit_stage();
    const int64_t w0 = c * SH::WC;
    walk<SH>(sh, static_cast<int>(c % SH::NSTAGE), w0, chunk_words(a.W, w0, SH::WC), cells, tx, ty);
  }
  write<SH>(a, cells, tx, ty, s0, t0);
}

__global__ void __launch_bounds__(Large::THREADS, 4) compat_allowed_large_kernel(Args a) {
  block_body<Large>(a);
}

__global__ void __launch_bounds__(Small::THREADS) compat_allowed_small_kernel(Args a) {
  block_body<Small>(a);
}

template <class SH>
int launch_shape(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  const int64_t grid_x = (a.S + SH::TILE_S - 1) / SH::TILE_S;
  const int64_t grid_y = (a.T + SH::TILE_T - 1) / SH::TILE_T;
  if (grid_x > 2147483647LL || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  dim3 block(SH::TT, SH::TS);
  dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  kernel<<<grid, block, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
// the block body on the CPU: each phase of the kernel run for all of the
// block's threads before the next (the __syncthreads() points), in the
// kernel's order of ring stages
template <class SH>
void host_blocks(const Args& a) {
  Tiles<SH> sh;
  Cells<SH> cells[SH::THREADS];
  for (int i = 0; i <= a.K; ++i) sh.koff[i] = a.key_off[i];
  const int64_t nchunks = (a.W + SH::WC - 1) / SH::WC;
  for (int64_t s0 = 0; s0 < a.S; s0 += SH::TILE_S) {
    for (int64_t t0 = 0; t0 < a.T; t0 += SH::TILE_T) {
      for (int c = 0; c < SH::NSTAGE - 1 && c < nchunks; ++c) {
        for (int tid = 0; tid < SH::THREADS; ++tid) {
          stage<SH>(a, sh, c, tid, s0, t0, int64_t(c) * SH::WC, chunk_words(a.W, int64_t(c) * SH::WC, SH::WC));
        }
      }
      for (int tid = 0; tid < SH::THREADS; ++tid) init_cells<SH>(cells[tid]);
      for (int64_t c = 0; c < nchunks; ++c) {
        const int64_t nxt = c + SH::NSTAGE - 1;
        if (nxt < nchunks) {
          for (int tid = 0; tid < SH::THREADS; ++tid) {
            stage<SH>(a, sh, static_cast<int>(nxt % SH::NSTAGE), tid, s0, t0, nxt * SH::WC,
                      chunk_words(a.W, nxt * SH::WC, SH::WC));
          }
        }
        const int64_t w0 = c * SH::WC;
        for (int tid = 0; tid < SH::THREADS; ++tid) {
          walk<SH>(sh, static_cast<int>(c % SH::NSTAGE), w0, chunk_words(a.W, w0, SH::WC),
                   cells[tid], tid % SH::TT, tid / SH::TT);
        }
      }
      for (int tid = 0; tid < SH::THREADS; ++tid) {
        write<SH>(a, cells[tid], tid % SH::TT, tid / SH::TT, s0, t0);
      }
    }
  }
}
#endif

}  // namespace

extern "C" {

// sig (W, sig_ld) and typ (W, typ_ld) are word-major uint32 planes
// (row pitch in words), each 16-byte aligned with a pitch of 4k words
// and storage to the next multiple of 4 rows; key_off (K + 1,) int32
// with key_off[K] = W; out (S, T) uint8 row-major and contiguous. tile:
// 0 small, 1 large. Returns an error code without running when the
// arguments break that contract.
#ifdef __CUDACC__
// Device pointers; launches on `stream` and returns cudaGetLastError().
int compat_allowed_launch(const void* sig, const void* typ, const void* key_off, int64_t S,
                          int64_t T, int64_t W, int64_t K, int64_t sig_ld, int64_t typ_ld,
                          void* out, int tile, void* stream) {
  if (S <= 0 || T <= 0) return 0;
  if (bad_args(sig, typ, K, sig_ld, typ_ld, tile)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(sig, typ, key_off, S, T, W, K, sig_ld, typ_ld, out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tile == TILE_SMALL ? launch_shape<Small>(compat_allowed_small_kernel, a, st)
                            : launch_shape<Large>(compat_allowed_large_kernel, a, st);
}
#else
// The same tile body on the CPU, host pointers, same layout as the launch.
int compat_allowed_host(const void* sig, const void* typ, const void* key_off, int64_t S,
                        int64_t T, int64_t W, int64_t K, int64_t sig_ld, int64_t typ_ld,
                        void* out, int tile) {
  if (S <= 0 || T <= 0) return 0;
  if (bad_args(sig, typ, K, sig_ld, typ_ld, tile)) return 1;
  const Args a = make_args(sig, typ, key_off, S, T, W, K, sig_ld, typ_ld, out);
  if (tile == TILE_SMALL) {
    host_blocks<Small>(a);
  } else {
    host_blocks<Large>(a);
  }
  return 0;
}
#endif

}  // extern "C"
