// K6: the backward of the one-hot QR lookup for every dense mult/add QR
// pair of a training step's embed stage, in one grouped pass (Hopper,
// sm_90a).  For pair p with output gradient g_p (B, D), remainder table A_p
// and quotient table B_p, and the rows r_n, q_n of each sample n:
//
//   grad A_p[r] = sum over n with r_n = r of g_p[n] * B_p[q_n]   (add: g_p[n])
//   grad B_p[q] = sum over n with q_n = q of g_p[n] * A_p[r_n]   (add: g_p[n])
//
// written into one flat (rows, D) buffer that holds every table's gradient
// in turn and that the caller zeroed.
//
// Replaces no Pallas kernel: the TPU kernel K1
// (repro/kernels/qr_gather.py::qr_gather) has no backward, and the reference
// trains through XLA's scatter-add of its plain gathers.  This is the
// backward of K1's function, added because the backward PyTorch gives the
// plain gathers (index_put_ with accumulate) sums every duplicate of a row
// in one thread per lane, one add after another, and a QR table's rows are
// nearly all duplicates: a quotient table of c = 4 rows takes ~B/4 of a
// batch's rows on each, and a skewed id stream piles tens of thousands on
// the remainder table's first rows.
//
// Bound on the card: memory.  Each (pair, side, sample) entry reads its key,
// its position, the other table's row id and row and the output gradient's
// row, and every gradient row is written once (at the Kaggle DCN's B = 65,536
// over 26 pairs at D = 16 in f32: ~1 GB, ~0.3 ms at 3.35 TB/s; the zero fill
// of the 540 MB buffer is the caller's).  Three passes, each parallel over
// entries, not rows:
//   1. keys: entry e = (side, pair, sample) gets the key offset + row, its
//      row of the flat buffer; the caller sorts the keys, stably;
//   2. chunks: a group of `lanes` threads takes `chunk` consecutive sorted
//      entries and sums each run of equal keys in sorted order, in f32.  A
//      run wholly inside the chunk is rounded once and written; the chunk's
//      first run, where it began in an earlier chunk, leaves its sum in
//      `piece`, and its last run, where it goes on past the chunk and began
//      in it, in `owned`;
//   3. carry: the chunk that owns a run that crosses its end adds its
//      `owned` sum and the `piece` of every later chunk the run reaches, a
//      warp's lane groups taking every (32 / lanes)-th piece in order, then a
//      fixed butterfly across the groups; it rounds once and writes.
// No run is summed by one thread: a run of 65,536 entries is 1,024 chunks
// and one warp's ordered sum of their pieces.  Every sum has a fixed order,
// so the same inputs give the same bits on every call (no atomics).
//
// Numerics: g * row and the sums in f32 with __fmul_rn / __fadd_rn (no FMA
// contraction), bf16 operands widened exactly, one rounding to the table
// dtype per gradient row.
//
// Contract (the Python wrapper checks it): 1 <= P <= kMaxPairs; every
// pointer lies on one device; tables are contiguous (rows, D) of one dtype
// (f32, or bf16 as its 16 bits) and width; g_p's rows are g_stride elements
// apart, its elements contiguous; the ids of both sides are int64 when ids64,
// else int32, contiguous (B,), in [-rows, rows) (a negative id counts from
// the end, as table[ids] reads it); every key offset + row < 2^31; the keys
// handed to pass 2 are pass 1's, sorted, with `perm` their entries; vec_bytes
// divides D * sizeof(element), is at most 16 (f32) or 8 (bf16) and at least
// one element, and every table and g pointer, and g_stride in bytes, are
// aligned to it; `piece` and `owned` hold ceil(N / chunk) rows of
// D f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxPairs = 40;   // keeps the parameter under the classic 4 KB
constexpr int kThreads = 128;
constexpr int kUnroll = 4;      // sorted entries whose loads are in flight together
constexpr int kPtrs = 5;        // per-pair pointers in the host arrays
constexpr int kInts = 6;        // per-pair integers in the host arrays

struct Pair {
  const void* ids[2];           // each sample's row of the remainder / quotient table
  const void* w[2];             // the remainder and quotient tables
  const void* g;                // the pair's output gradient
  long long g_stride;           // elements between its rows
  int rows[2];
  int key_off[2];               // each table's first row in the flat buffer
  int op_mult;
};

// The kernels' parameter: the pairs and the operands of the launch.
struct Group {
  Pair pairs[kMaxPairs];
  const int* keys;              // sorted keys (pass 1 writes them unsorted)
  const long long* perm;        // the entry of each sorted key
  void* flat;                   // (rows, D) gradients, zeroed
  float* piece;                 // (chunks, D)
  float* owned;                 // (chunks, D)
  long long B, N, chunks;       // samples, entries (2 P B), chunks of entries
  int P, D, ids64, lanes, chunk;
};
static_assert(sizeof(Group) <= 4096, "kernel parameter over 4 KB");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
template <typename S> __device__ __forceinline__ S from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ unsigned short from_f32<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int VB> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };

// N elements of type S at p (one load of N * sizeof(S) bytes), widened to f32.
template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float (&x)[N]) {
  using W = typename Word<N * sizeof(S)>::type;
  const W word = __ldg(reinterpret_cast<const W*>(p));
  S v[N];
  memcpy(v, &word, sizeof(W));
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_f32(v[i]);
}

// x rounded to S, stored at p with one store.
template <typename S, int N>
__device__ __forceinline__ void store(S* p, const float (&x)[N]) {
  using W = typename Word<N * sizeof(S)>::type;
  S v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = from_f32<S>(x[i]);
  W word;
  memcpy(&word, v, sizeof(W));
  *reinterpret_cast<W*>(p) = word;
}

// Entry e -> (side, pair, sample): entries run side by side, pair by pair.
__device__ __forceinline__ void decode(const Group& g, long long e, int& side, int& p,
                                       long long& n) {
  const long long per_side = g.P * g.B;
  side = e >= per_side ? 1 : 0;
  const long long r = e - side * per_side;
  p = static_cast<int>(r / g.B);
  n = r - p * g.B;
}

__device__ __forceinline__ long long row_of(const Pair& pr, int side, long long n, int ids64) {
  const long long r = ids64 ? static_cast<const long long*>(pr.ids[side])[n]
                            : static_cast<const int*>(pr.ids[side])[n];
  return r < 0 ? r + pr.rows[side] : r;
}

__global__ void __launch_bounds__(kThreads) keys_kernel(const __grid_constant__ Group g,
                                                        int* keys) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < g.N;
       e += stride) {
    int side, p;
    long long n;
    decode(g, e, side, p, n);
    const Pair& pr = g.pairs[p];
    keys[e] = pr.key_off[side] + static_cast<int>(row_of(pr, side, n, g.ids64));
  }
}

// Pass 2.  S is the tables' storage type, VB the bytes a lane loads of a row.
template <typename S, int VB>
__global__ void __launch_bounds__(kThreads) chunk_kernel(const __grid_constant__ Group g) {
  constexpr int N = VB / sizeof(S);
  const int lanes = g.lanes;
  const long long c = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) / lanes;
  const int col = (blockIdx.y * lanes + static_cast<int>(threadIdx.x % lanes)) * N;
  if (c >= g.chunks || col >= g.D) return;
  const long long start = c * g.chunk;
  const long long end = min(start + g.chunk, g.N);
  const int before = start > 0 ? g.keys[start - 1] : -1;
  const int after = end < g.N ? g.keys[end] : -1;
  S* flat = static_cast<S*>(g.flat);
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  int cur = g.keys[start];
  bool first = true;

  auto flush = [&](bool last) {
    if (first && cur == before) {
      store<float, N>(g.piece + c * g.D + col, acc);
    } else if (last && cur == after) {
      store<float, N>(g.owned + c * g.D + col, acc);
    } else {
      store<S, N>(flat + static_cast<long long>(cur) * g.D + col, acc);
    }
  };

  for (long long i0 = start; i0 < end; i0 += kUnroll) {
    // keys and entries of kUnroll sorted entries ...
    int key[kUnroll];
    const S* gp[kUnroll];
    const S* op[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u;
      key[u] = 0;
      gp[u] = op[u] = nullptr;
      if (i < end) {
        key[u] = g.keys[i];
        int side, p;
        long long n;
        decode(g, g.perm[i], side, p, n);
        const Pair& pr = g.pairs[p];
        gp[u] = static_cast<const S*>(pr.g) + n * pr.g_stride + col;
        if (pr.op_mult) {
          const int other = 1 - side;
          op[u] = static_cast<const S*>(pr.w[other]) + row_of(pr, other, n, g.ids64) * g.D
                  + col;
        }
      }
    }
    // ... then their rows of g and of the other table ...
    float gx[kUnroll][N], ox[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (gp[u] != nullptr) load_f32<S, N>(gp[u], gx[u]);
      if (op[u] != nullptr) load_f32<S, N>(op[u], ox[u]);
    }
    // ... then the sums, in sorted order
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (gp[u] == nullptr) continue;
      if (key[u] != cur) {
        flush(false);
        first = false;
        cur = key[u];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = __fadd_rn(acc[i],
                           op[u] != nullptr ? __fmul_rn(gx[u][i], ox[u][i]) : gx[u][i]);
      }
    }
  }
  flush(true);
}

// Pass 3: one warp per chunk; only a chunk whose last run began in it and
// goes on past it has work.
template <typename S, int VB>
__global__ void __launch_bounds__(kThreads) carry_kernel(const __grid_constant__ Group g) {
  constexpr int N = VB / sizeof(S);
  const long long c = (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) / 32;
  if (c >= g.chunks) return;                      // uniform across the warp, as are the
  const long long start = c * g.chunk;            // returns below
  const long long end = min(start + g.chunk, g.N);
  if (end >= g.N) return;
  const int key = g.keys[end - 1];
  if (g.keys[end] != key || (start > 0 && g.keys[start - 1] == key)) return;
  long long lo = end, hi = g.N;                   // the first entry past the run
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (g.keys[mid] <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long pieces = (lo - 1) / g.chunk - c;  // later chunks the run reaches
  const int lanes = g.lanes;
  const int lane = threadIdx.x % 32;
  const int sub = lane / lanes;
  const int col = (blockIdx.y * lanes + lane % lanes) * N;
  const bool active = col < g.D;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  if (active) {
#pragma unroll 4
    for (long long j = sub; j <= pieces; j += 32 / lanes) {
      float x[N];
      load_f32<float, N>((j == 0 ? g.owned + c * g.D : g.piece + (c + j) * g.D) + col, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], x[i]);
    }
  }
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], off));
    }
  }
  if (sub == 0 && active) {
    store<S, N>(static_cast<S*>(g.flat) + static_cast<long long>(key) * g.D + col, acc);
  }
}

using Kernel = void (*)(Group);

// The case compiled for S and VB: f32 rows in loads of 16, 8 or 4 bytes,
// bf16 rows in loads of 8, 4 or 2 (at most 4 f32 sums a lane); null for
// any other width.
template <typename S>
Kernel pick(int vec_bytes, bool carry) {
  if constexpr (sizeof(S) == 4) {
    if (vec_bytes == 16) return carry ? carry_kernel<S, 16> : chunk_kernel<S, 16>;
  } else {
    if (vec_bytes == 2) return carry ? carry_kernel<S, 2> : chunk_kernel<S, 2>;
  }
  if (vec_bytes == 8) return carry ? carry_kernel<S, 8> : chunk_kernel<S, 8>;
  if (vec_bytes == 4) return carry ? carry_kernel<S, 4> : chunk_kernel<S, 4>;
  return nullptr;
}

// The parameter from the host arrays: per pair, ptrs[5p..5p+4] are (ids of
// the remainder side, ids of the quotient side, remainder table, quotient
// table, g) and ints[6p..6p+5] are (g_stride, rows of each table, key
// offset of each table, op_mult).  False on a value outside the contract.
bool fill(Group& g, const void* const* ptrs, const long long* ints, int P, long long B,
          int ids64) {
  if (P < 1 || P > kMaxPairs || B < 1) return false;
  memset(&g, 0, sizeof(g));
  for (int p = 0; p < P; ++p) {
    Pair& pr = g.pairs[p];
    const void* const* q = ptrs + kPtrs * p;
    const long long* n = ints + kInts * p;
    pr.ids[0] = q[0];
    pr.ids[1] = q[1];
    pr.w[0] = q[2];
    pr.w[1] = q[3];
    pr.g = q[4];
    pr.g_stride = n[0];
    for (int s = 0; s < 2; ++s) {
      if (n[1 + s] < 1 || n[3 + s] < 0 || n[3 + s] + n[1 + s] > 0x7fffffffLL) return false;
      pr.rows[s] = static_cast<int>(n[1 + s]);
      pr.key_off[s] = static_cast<int>(n[3 + s]);
    }
    pr.op_mult = static_cast<int>(n[5]);
  }
  g.P = P;
  g.B = B;
  g.N = 2LL * P * B;
  g.ids64 = ids64;
  return true;
}

}  // namespace

extern "C" {

// Pass 1: keys[e] for the 2 P B entries (B >= 1).  Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments outside the contract it can see.
int qr_pairs_keys(const void* const* ptrs, const long long* ints, int P, long long B, int ids64,
                  int* keys, void* stream) {
  Group g;
  if (!fill(g, ptrs, ints, P, B, ids64) || keys == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = (g.N + kThreads - 1) / kThreads;
  const long long blocks = need < 132LL * 32 ? need : 132LL * 32;
  keys_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(g, keys);
  return static_cast<int>(cudaGetLastError());
}

// Passes 2 and 3 on the sorted keys and their entries, into flat (rows,
// D), zeroed: S is bf16 when bf16, else f32; each lane loads vec_bytes of a
// row, and `lanes` (a power of two up to 32) lanes take a chunk of `chunk`
// entries.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for arguments outside the contract it can see.
int qr_pairs_backward(const void* const* ptrs, const long long* ints, int P, long long B, int D,
                      int ids64, int bf16, int vec_bytes, int lanes, int chunk, const int* keys,
                      const long long* perm, void* flat, float* piece, float* owned,
                      void* stream) {
  Group g;
  const int elem = bf16 ? 2 : 4;
  if (!fill(g, ptrs, ints, P, B, ids64) || D < 1 || chunk < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || vec_bytes < elem || (D * elem) % vec_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel chunks_k = bf16 ? pick<unsigned short>(vec_bytes, false)
                               : pick<float>(vec_bytes, false);
  const Kernel carry_k = bf16 ? pick<unsigned short>(vec_bytes, true)
                              : pick<float>(vec_bytes, true);
  if (chunks_k == nullptr || carry_k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  g.keys = keys;
  g.perm = perm;
  g.flat = flat;
  g.piece = piece;
  g.owned = owned;
  g.D = D;
  g.lanes = lanes;
  g.chunk = chunk;
  g.chunks = (g.N + chunk - 1) / chunk;
  const int vecs = D * elem / vec_bytes;
  const unsigned tiles = static_cast<unsigned>((vecs + lanes - 1) / lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid2(static_cast<unsigned>((g.chunks * lanes + kThreads - 1) / kThreads), tiles);
  chunks_k<<<grid2, kThreads, 0, s>>>(g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid3(static_cast<unsigned>((g.chunks * 32 + kThreads - 1) / kThreads), tiles);
  carry_k<<<grid3, kThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

const char* qr_pairs_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
