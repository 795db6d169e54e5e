// Grouped embedding lookups over every table of a wave in one launch
// (Hopper, sm_90a).  Four kernels from one template:
//
//   K4 and K3, pooled (BAG = true), for each bag b and table t:
//     rows   = dequant(gather(table t, split(idx[b, t, l])))   int8 widens in registers
//     pooled = sum_l w[b, t, l] * combine(rows)                f32, in l order
//     out[b, t] = round(pooled) @ proj_t                       optional projection
//   with w = mask (K4), or the mask rounded to the table dtype first (K3,
//   dense QR pairs: a fractional weight on a bf16 table multiplies as its
//   bf16 rounding, as the reference's wrapper casts the mask);
//   K1 and K5, one-hot (BAG = false), for each id i = idx[b, t]:
//     out[b, t] = W_rem[i % m_t] op W_quo[i / m_t]             K1: dense f32 / bf16 pair,
//                                                              f32 combine, one rounding
//                                                              to the table dtype
//     out[b, t] = deq(q_rem[i % m_t]) op deq(q_quo[i / m_t])   K5: int8 pair, f32 out
//
// Replaces the Pallas TPU kernels repro/kernels/serve_path.py::fused_serve_pool
// (K4), repro/kernels/embedding_bag.py::qr_embedding_bag (K3),
// repro/kernels/qr_gather.py::qr_gather (K1) and
// repro/kernels/qr_gather.py::qr_gather_quant (K5).  The per-table entries of
// all four launch this kernel with one table and pre-split ids.
//
// Bound on the card: memory.  A full serving wave (B=256 bags of L=4 over
// 26 int8 QR pairs at D=16) moves ~1.6 MB: ids, mask, each live row once
// (16 bytes + 3 of scale and zero point) and the output, with ~2 flops per
// byte.  A full f32 scoring batch (K1, B=256 ids over 26 f32 QR pairs at
// D=16) moves ~1.3 MB: ids, two 64-byte rows per id and a 64-byte output
// row, with 1 flop per element.  At these sizes the floor is not bandwidth
// but one launch plus a few dependent memory round trips (id -> row ->
// store).  The TPU path, ported table by table, paid that floor 26 times per
// wave or batch, plus two device operations per table to split ids (and,
// pooled, one copy per table to slice the mask).  Here the floor is paid
// once per wave or batch:
//   - the grid is (bag blocks, tables), so a block serves one table and its
//     descriptor is uniform inside the block; all tables' descriptors ride
//     in one __grid_constant__ kernel parameter (no host-to-device copy);
//   - a launch whose tables share storage type and load width (every
//     launch of the model paths, and every one-table launch) runs a kernel
//     compiled for that one case, so its registers and code are that
//     case's alone; a mixed group runs the kernel that switches per table;
//   - the QR split i % m, i / m (or a hash table's fold i % m) runs in the
//     kernel on the raw ids, which are non-negative by contract, so C's
//     % and / equal PyTorch's % and //;
//   - ids (int32 or int64) and mask (f32 or bf16) are read in place, in
//     their own dtype, through their (B, T, L) strides;
//   - a thread issues the row, scale and zero-point loads of kSlots bag
//     slots before any of their arithmetic, so a bag's rows are in flight
//     together, and reads a row in loads of up to 16 bytes (one load for
//     an int8 row at D=16, four threads of one 16-byte load each for an
//     f32 row) where width and alignment allow.
// Wide rows (K3 at D=128 f32: 512 bytes, one warp of 16-byte loads per
// row) are where bandwidth, not the launch, sets the time: a bag of L=32
// over a table far above L2 reads its rows cold.  There the launcher
// gives a bag one thread per 16 bytes of row, up to a warp, the remainder
// table's rows bypass L1, and the kernel compiled for the one case keeps
// few enough registers for a full SM.
// Slots with weight 0 (padding, empty bags) load no row and add nothing;
// for finite tables that is the same sum as adding 0 * row.
//
// Numerics: products and sums use __fmul_rn / __fadd_rn / __fsub_rn and
// the bag sums in l order in an f32 register, so no FMA contraction changes
// the rounding, and a group of tables gives the same bits as one launch per
// table, whatever the threads per bag, the slots in flight or the kernel
// chosen.
// The pool dtype is f32 for int8 tables and the table dtype for dense ones
// (a bf16 bag, or a bf16 one-hot row, rounds once); the projection
// accumulates in f32.
//
// Contract (the Python wrapper checks it): 1 <= T <= kMaxTables; every
// pointer lies on one device; ids are int32 or int64, non-negative, in
// range and below 2^31 once split; pre-split quotient ids share the ids'
// dtype and strides; mask is f32, bf16 or null (weight 1); tables are
// contiguous (rows, d_t); an int8 table has a bf16 (rows, 1) scale and an
// int8 (rows, 1) zero point; proj is f32 (d_t, d_out); without proj
// d_t == d_out; out is contiguous (B, T, d_out) and 16-byte aligned;
// vec_bytes divides d_t * sizeof(element) and every row pointer of the
// table is aligned to it; one-hot tables are QR pairs without projection
// and no mask; tables rounding their weights (K3) are dense QR pairs
// without projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxTables = 40;   // keeps the parameter under the classic 4 KB
constexpr int kSlots = 4;        // bag slots whose loads are in flight together
constexpr int kThreads = 64;
constexpr int kPtrs = 7;         // per-table pointers in the host arrays
constexpr int kInts = 5;         // per-table ints in the host arrays

enum TableType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

struct Table {
  const void* w[2];              // remainder (or single) table, quotient table
  const __nv_bfloat16* scale[2];
  const int8_t* zp[2];
  const float* proj;
  int m;                         // 0: ids as given; > 0: split (pair) or fold
  int d;
  int type;
  int op_mult;
  int vec_bytes;
};

// The kernel's parameter: the tables' descriptors and the launch's operands.
struct Group {
  Table tables[kMaxTables];
  const void* idx[2];            // raw ids; idx[1]: pre-split quotient ids
  const void* mask;
  void* out;
  long long is_b, is_t, is_l;    // idx strides, elements
  long long ms_b, ms_t, ms_l;    // mask strides
  int B, T, L, d_out, out_bf16, threads_per_bag;
  int idx64;                     // ids are int64 (else int32)
  int mask_bf16;                 // mask is bf16 (else f32)
  int round_weight;              // K3: weights round to a bf16 table's dtype
};
static_assert(sizeof(Group) <= 4096, "kernel parameter over 4 KB");

// Storage types: a bf16 element is carried as its 16 bits.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
__device__ __forceinline__ float to_f32(signed char v) { return static_cast<float>(v); }

template <int VB> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<1> { using type = unsigned char; };

// VB bytes of one row as N elements, read with one load.
template <typename S, int VB>
struct Chunk {
  static constexpr int N = VB / sizeof(S);
  S v[N];
};

template <typename S, int VB>
__device__ __forceinline__ Chunk<S, VB> load_chunk(const S* p) {
  const auto word = __ldg(reinterpret_cast<const typename Word<VB>::type*>(p));
  Chunk<S, VB> c;
  memcpy(&c, &word, VB);
  return c;
}

// A chunk of a remainder (or single) table's row: the large table, each of
// whose rows a bag reads once, so a 16-byte load does not allocate in L1
// (ld.global.nc.L1::no_allocate) and leaves it to the ids, the mask and
// the quotient table's few rows, which every slot reads again.
template <typename S, int VB>
__device__ __forceinline__ Chunk<S, VB> load_chunk_streaming(const S* p) {
  if constexpr (VB == 16) {
    uint4 w;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "l"(p));
    Chunk<S, VB> c;
    memcpy(&c, &w, VB);
    return c;
  } else {
    return load_chunk<S, VB>(p);
  }
}

__device__ __forceinline__ float combine(float a, float b, int op_mult) {
  return op_mult ? __fmul_rn(a, b) : __fadd_rn(a, b);
}

// The rows of one slot: split (or fold) the raw id at element offset `off`,
// or take the pre-split pair.  I is the ids' element type.
template <typename I>
__device__ __forceinline__ void slot_rows(const void* ia, const void* ib, long long off, int m,
                                          long long& ra, long long& rb) {
  const I id = static_cast<const I*>(ia)[off];
  if (m > 0) {
    ra = id % m;
    rb = id / m;
  } else {
    ra = id;
    rb = ib ? static_cast<const I*>(ib)[off] : 0;
  }
}

// One table's bags (or ids) for this block.  S is the table's storage type,
// VB its load width.  The table is uniform across the block; one-hot
// lookups hold one slot.
template <bool BAG, typename S, int VB>
__device__ __forceinline__ void lookup(const Group& g, const Table& tab, float* smem) {
  constexpr int N = VB / sizeof(S);
  constexpr bool kQuant = sizeof(S) == 1;
  const int t = blockIdx.y;
  const int tpb = g.threads_per_bag;
  const int slot = threadIdx.x / tpb;
  const int tx = threadIdx.x % tpb;
  const int b = blockIdx.x * (kThreads / tpb) + slot;
  const int d = tab.d;
  const bool pair = tab.w[1] != nullptr;
  const bool project = BAG && tab.proj != nullptr;
  // K3 on a bf16 table: the weight multiplies as its bf16 rounding
  const bool round_weight = BAG && sizeof(S) == 2 && g.round_weight;
  const S* w0 = static_cast<const S*>(tab.w[0]);
  const S* w1 = static_cast<const S*>(tab.w[1]);
  float* proj_s = smem;                                  // d * d_out
  float* pooled_s = smem + (project ? d * g.d_out : 0);  // bags per block * d

  if (project) {
    for (int k = threadIdx.x; k < d * g.d_out; k += kThreads) proj_s[k] = tab.proj[k];
  }

  if (b < g.B) {
    const long long ib0 = b * g.is_b + t * g.is_t;
    const long long mb0 = b * g.ms_b + t * g.ms_t;
    const bool weighted = BAG && g.mask != nullptr;
    const int L = BAG ? g.L : 1;
    const long long out_row = (static_cast<long long>(b) * g.T + t) * g.d_out;
    for (int k = tx; k < d / N; k += tpb) {
      const int c0 = k * N;
      float acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.0f;
      for (int l0 = 0; l0 < L; l0 += kSlots) {
        // ids and weights of kSlots slots ...
        long long ra[kSlots], rb[kSlots];
        float wt[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const int l = l0 + u;
          wt[u] = 0.0f;
          ra[u] = rb[u] = 0;
          if (l < L) {
            wt[u] = 1.0f;
            if (weighted) {
              const long long off = mb0 + l * g.ms_l;
              wt[u] = g.mask_bf16 ? to_f32(static_cast<const unsigned short*>(g.mask)[off])
                                  : static_cast<const float*>(g.mask)[off];
              if (round_weight) wt[u] = __bfloat162float(__float2bfloat16_rn(wt[u]));
            }
            const long long off = ib0 + l * g.is_l;
            if (g.idx64) {
              slot_rows<long long>(g.idx[0], g.idx[1], off, tab.m, ra[u], rb[u]);
            } else {
              slot_rows<int32_t>(g.idx[0], g.idx[1], off, tab.m, ra[u], rb[u]);
            }
          }
        }
        // ... then every live slot's row, scale and zero point ...
        Chunk<S, VB> va[kSlots], vb[kSlots];
        float sa[kSlots], za[kSlots], sb[kSlots], zb[kSlots];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (wt[u] != 0.0f) {
            va[u] = load_chunk_streaming<S, VB>(w0 + ra[u] * d + c0);
            if (kQuant) {
              sa[u] = __bfloat162float(tab.scale[0][ra[u]]);
              za[u] = static_cast<float>(tab.zp[0][ra[u]]);
            }
            if (pair) {
              vb[u] = load_chunk<S, VB>(w1 + rb[u] * d + c0);
              if (kQuant) {
                sb[u] = __bfloat162float(tab.scale[1][rb[u]]);
                zb[u] = static_cast<float>(tab.zp[1][rb[u]]);
              }
            }
          }
        }
        // ... then their arithmetic, in l order: dequant (q - zp) * scale,
        // combine, weight, add
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          if (wt[u] == 0.0f) continue;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float x = to_f32(va[u].v[i]);
            if (kQuant) x = __fmul_rn(__fsub_rn(x, za[u]), sa[u]);
            if (pair) {
              float y = to_f32(vb[u].v[i]);
              if (kQuant) y = __fmul_rn(__fsub_rn(y, zb[u]), sb[u]);
              x = combine(x, y, tab.op_mult);
            }
            acc[i] = BAG ? __fadd_rn(acc[i], __fmul_rn(x, wt[u])) : x;
          }
        }
      }
      // one rounding to the pool dtype: a dense bf16 table's bag rounds here
      if (BAG && tab.type == kBF16) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = __bfloat162float(__float2bfloat16_rn(acc[i]));
      }
      if (project) {
#pragma unroll
        for (int i = 0; i < N; ++i) pooled_s[slot * d + c0 + i] = acc[i];
      } else if (g.out_bf16) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(g.out) + out_row + c0;
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = __float2bfloat16_rn(acc[i]);
      } else if (N % 4 == 0 && (g.d_out & 3) == 0) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(g.out) + out_row + c0);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          o[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
        }
      } else {
        float* o = static_cast<float*>(g.out) + out_row + c0;
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = acc[i];
      }
    }
  }
  if (!project) return;  // uniform across the block: no barrier is skipped
  __syncthreads();
  if (b >= g.B) return;
  const float* pooled = pooled_s + slot * d;
  float* o = static_cast<float*>(g.out) + (static_cast<long long>(b) * g.T + t) * g.d_out;
  for (int j = tx; j < g.d_out; j += tpb) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(pooled[k], proj_s[k * g.d_out + j], acc);
    o[j] = acc;
  }
}

// A launch whose tables share storage type S and load width VB: one case,
// compiled alone.
template <bool BAG, typename S, int VB>
__global__ void __launch_bounds__(kThreads) uniform_kernel(const __grid_constant__ Group g) {
  extern __shared__ float smem[];
  lookup<BAG, S, VB>(g, g.tables[blockIdx.y], smem);
}

template <bool BAG, typename S>
__device__ __forceinline__ void by_width(const Group& g, const Table& tab, float* smem) {
  switch (tab.vec_bytes) {
    case 16: lookup<BAG, S, 16>(g, tab, smem); break;
    case 8: lookup<BAG, S, 8>(g, tab, smem); break;
    case 4: lookup<BAG, S, 4>(g, tab, smem); break;
    case 2: if constexpr (sizeof(S) <= 2) lookup<BAG, S, 2>(g, tab, smem); break;
    case 1: if constexpr (sizeof(S) == 1) lookup<BAG, S, 1>(g, tab, smem); break;
    default: break;
  }
}

// A group that mixes storage types or load widths: each block switches on
// its table's.
template <bool BAG>
__global__ void __launch_bounds__(kThreads) mixed_kernel(const __grid_constant__ Group g) {
  extern __shared__ float smem[];
  const Table& tab = g.tables[blockIdx.y];
  switch (tab.type) {
    case kF32: by_width<BAG, float>(g, tab, smem); break;
    case kBF16: by_width<BAG, unsigned short>(g, tab, smem); break;
    case kInt8: by_width<BAG, signed char>(g, tab, smem); break;
    default: break;
  }
}

using Kernel = void (*)(Group);

template <bool BAG, typename S>
Kernel uniform_by_width(int vb) {
  switch (vb) {
    case 16: return uniform_kernel<BAG, S, 16>;
    case 8: return uniform_kernel<BAG, S, 8>;
    case 4: return uniform_kernel<BAG, S, 4>;
    case 2: if constexpr (sizeof(S) <= 2) return uniform_kernel<BAG, S, 2>; break;
    case 1: if constexpr (sizeof(S) == 1) return uniform_kernel<BAG, S, 1>; break;
    default: break;
  }
  return nullptr;
}

// The kernel for a launch: the uniform case's when every table shares
// storage type and load width, else the switching one.
template <bool BAG>
Kernel pick(const Group& g, int T) {
  const Table& t0 = g.tables[0];
  for (int t = 1; t < T; ++t) {
    if (g.tables[t].type != t0.type || g.tables[t].vec_bytes != t0.vec_bytes) {
      return mixed_kernel<BAG>;
    }
  }
  switch (t0.type) {
    case kF32: return uniform_by_width<BAG, float>(t0.vec_bytes);
    case kBF16: return uniform_by_width<BAG, unsigned short>(t0.vec_bytes);
    case kInt8: return uniform_by_width<BAG, signed char>(t0.vec_bytes);
    default: return nullptr;
  }
}

bool valid_width(int type, int vb) {
  const int elem = type == kF32 ? 4 : type == kBF16 ? 2 : 1;
  return (vb == 16 || vb == 8 || vb == 4 || vb == 2 || vb == 1) && vb >= elem;
}

// The launch's operands as the C entry receives them.
struct Args {
  const void* const* ptrs;
  const int* ints;
  int T;
  const void* idx_a;
  const void* idx_b;
  int idx64;
  long long is_b, is_t, is_l;
  const void* mask;
  int mask_bf16;
  long long ms_b, ms_t, ms_l;
  void* out;
  int B, L, d_out, out_bf16, bag, round_weight, threads_per_bag, smem;
  cudaStream_t stream;
};

int run(const Args& a) {
  Group g;
  memset(&g, 0, sizeof(g));
  for (int t = 0; t < a.T; ++t) {
    Table& tab = g.tables[t];
    const void* const* p = a.ptrs + kPtrs * t;
    const int* n = a.ints + kInts * t;
    tab.w[0] = p[0];
    tab.w[1] = p[1];
    tab.scale[0] = static_cast<const __nv_bfloat16*>(p[2]);
    tab.zp[0] = static_cast<const int8_t*>(p[3]);
    tab.scale[1] = static_cast<const __nv_bfloat16*>(p[4]);
    tab.zp[1] = static_cast<const int8_t*>(p[5]);
    tab.proj = static_cast<const float*>(p[6]);
    tab.m = n[0];
    tab.d = n[1];
    tab.type = n[2];
    tab.op_mult = n[3];
    tab.vec_bytes = n[4];
    const bool dense_pair = tab.w[1] && !tab.proj && tab.type != kInt8;
    if (!valid_width(tab.type, tab.vec_bytes) || (!a.bag && (!tab.w[1] || tab.proj)) ||
        (a.round_weight && !dense_pair)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.idx[0] = a.idx_a;
  g.idx[1] = a.idx_b;
  g.mask = a.mask;
  g.out = a.out;
  g.is_b = a.is_b;
  g.is_t = a.is_t;
  g.is_l = a.is_l;
  g.ms_b = a.ms_b;
  g.ms_t = a.ms_t;
  g.ms_l = a.ms_l;
  g.B = a.B;
  g.T = a.T;
  g.L = a.bag ? a.L : 1;
  g.d_out = a.d_out;
  g.out_bf16 = a.out_bf16;
  g.threads_per_bag = a.threads_per_bag;
  g.idx64 = a.idx64;
  g.mask_bf16 = a.mask_bf16;
  g.round_weight = a.round_weight;
  const dim3 grid((a.B * a.threads_per_bag + kThreads - 1) / kThreads, a.T);
  const Kernel kernel = a.bag ? pick<true>(g, a.T) : pick<false>(g, a.T);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a.smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  }
  kernel<<<grid, kThreads, a.smem, a.stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one grouped lookup over T tables.  Per table t, ptrs[7t..7t+6]
// are (w_a, w_b, scale_a, zp_a, scale_b, zp_b, proj) and ints[5t..5t+4]
// are (m, d, type, op_mult, vec_bytes); absent operands are null.  bag = 1
// is K4 / K3 (mask may be null: weight 1; round_weight = 1 is K3), bag = 0
// is K1 / K5 (L = 1, no mask; out_bf16 for bf16 pairs, else f32).  ids are
// int64 when idx64, else int32; the mask bf16 when mask_bf16, else f32.
// Returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue for arguments outside the
// contract it can see.
int grouped_lookup(const void* const* ptrs, const int* ints, int T, const void* idx_a,
                   const void* idx_b, int idx64, long long is_b, long long is_t, long long is_l,
                   const void* mask, int mask_bf16, long long ms_b, long long ms_t,
                   long long ms_l, void* out, int B, int L, int d_out, int out_bf16, int bag,
                   int round_weight, int threads_per_bag, int smem, void* stream) {
  if (T < 1 || T > kMaxTables || B < 1 || threads_per_bag < 1 ||
      kThreads % threads_per_bag != 0 || (!bag && (mask || round_weight))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{ptrs, ints, T, idx_a, idx_b, idx64, is_b, is_t, is_l, mask, mask_bf16,
               ms_b, ms_t, ms_l, out, B, L, d_out, out_bf16, bag, round_weight,
               threads_per_bag, smem, static_cast<cudaStream_t>(stream)};
  return run(a);
}

const char* grouped_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
