// Fused serving lookup for one categorical feature (Hopper, sm_90a):
//
//   rows   = dequant(gather(tables, idx))       int8 rows widen in registers
//   pooled = sum_l mask[b, l] * combine(rows)   multi-hot bag pooling, f32
//   out    = round(pooled) @ proj               optional mixed-width projection
//
// Replaces the Pallas TPU kernel repro/kernels/serve_path.py::fused_serve_pool.
// The TPU walks a sequential (B, L) grid and carries the bag sum in VMEM
// scratch; here a group of TX threads owns one bag, each thread owns the
// columns c = tx, tx + TX, ... of it and loops over L in l order, adding into
// an f32 register.  Rows of an int8 table are dequantized on load from the
// stored bf16 scale and int8 zero point, so no per-call metadata is built.
//
// Bound on the card: memory.  Per bag the kernel reads L ids per table, L
// mask weights, L rows per table (d bytes each for int8, plus 3 bytes of
// scale and zp), and writes one output row; it does ~2 flops per byte
// read, far below the ~20 flop/byte at which an H100's f32 rate would bind.
// The rows are scattered, so each row read is its own memory transaction;
// the design keeps every byte it reads in registers or shared memory and
// touches device memory once per row and once per output.
//
// Contract (the Python wrapper checks it): every pointer is on one device,
// contiguous; ids are int32 in range; mask is f32 (B, L) with L >= 1; the
// tables are (rows, d); scale is bf16 (rows, 1) and zp int8 (rows, 1) for
// int8 tables; proj is f32 (d, d_out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

enum TableType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) { return *p; }

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <>
__device__ __forceinline__ float load_f32<int8_t>(const int8_t* p) {
  return static_cast<float>(*p);
}

// One table element as f32: dense rows widen exactly; int8 rows dequantize
// as (q - zp) * scale, the reference's order of operations.
template <typename T, bool QUANT>
__device__ __forceinline__ float row_value(const T* w, const __nv_bfloat16* scale,
                                           const int8_t* zp, long long row, int d,
                                           int c) {
  float v = load_f32<T>(w + row * d + c);
  if (QUANT) {
    v = __fmul_rn(__fsub_rn(v, static_cast<float>(zp[row])),
                  __bfloat162float(scale[row]));
  }
  return v;
}

template <typename T, bool QUANT, bool HAS_B>
__global__ void fused_serve_pool_kernel(
    const int32_t* __restrict__ idx_a, const int32_t* __restrict__ idx_b,
    const float* __restrict__ mask, const T* __restrict__ w_a,
    const T* __restrict__ w_b, const __nv_bfloat16* __restrict__ scale_a,
    const int8_t* __restrict__ zp_a, const __nv_bfloat16* __restrict__ scale_b,
    const int8_t* __restrict__ zp_b, const float* __restrict__ proj,
    void* __restrict__ out, int B, int L, int d, int d_out, int op_mult,
    int project, int tx_per_bag) {
  extern __shared__ float smem[];
  const int bags_per_block = blockDim.x / tx_per_bag;
  const int slot = threadIdx.x / tx_per_bag;
  const int tx = threadIdx.x % tx_per_bag;
  const int b = blockIdx.x * bags_per_block + slot;
  float* proj_s = smem;                                    // d * d_out
  float* pooled_s = smem + (project ? d * d_out : 0);      // bags_per_block * d

  if (project) {
    for (int k = threadIdx.x; k < d * d_out; k += blockDim.x) proj_s[k] = proj[k];
  }

  if (b < B) {
    const int32_t* ia = idx_a + static_cast<long long>(b) * L;
    const int32_t* ib = HAS_B ? idx_b + static_cast<long long>(b) * L : nullptr;
    const float* mk = mask + static_cast<long long>(b) * L;
    for (int c = tx; c < d; c += tx_per_bag) {
      float acc = 0.0f;
      for (int l = 0; l < L; ++l) {
        float row = row_value<T, QUANT>(w_a, scale_a, zp_a, ia[l], d, c);
        if (HAS_B) {
          float rb = row_value<T, QUANT>(w_b, scale_b, zp_b, ib[l], d, c);
          row = op_mult ? __fmul_rn(row, rb) : __fadd_rn(row, rb);
        }
        acc = __fadd_rn(acc, __fmul_rn(row, mk[l]));
      }
      // one rounding to the pool dtype: f32 for dequantized rows, else the
      // table dtype (a bf16 table's bag rounds once, here)
      if (!QUANT && sizeof(T) == 2) acc = __bfloat162float(__float2bfloat16_rn(acc));
      if (project) {
        pooled_s[slot * d + c] = acc;
      } else if (QUANT || sizeof(T) == 4) {
        static_cast<float*>(out)[static_cast<long long>(b) * d + c] = acc;
      } else {
        static_cast<__nv_bfloat16*>(out)[static_cast<long long>(b) * d + c] =
            __float2bfloat16_rn(acc);
      }
    }
  }
  if (!project) return;  // uniform across the block: no barrier is skipped
  __syncthreads();
  if (b >= B) return;
  const float* pooled = pooled_s + slot * d;
  for (int j = tx; j < d_out; j += tx_per_bag) {
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(pooled[k], proj_s[k * d_out + j], acc);
    static_cast<float*>(out)[static_cast<long long>(b) * d_out + j] = acc;
  }
}

template <typename T, bool QUANT, bool HAS_B>
int launch(const int32_t* idx_a, const int32_t* idx_b, const float* mask,
           const void* w_a, const void* w_b, const void* scale_a,
           const void* zp_a, const void* scale_b, const void* zp_b,
           const float* proj, void* out, int B, int L, int d, int d_out,
           int op_mult, int project, cudaStream_t stream) {
  int tx = 1;
  while (tx < d && tx < 32) tx <<= 1;
  const int bags_per_block = kThreads / tx;
  const int grid = (B + bags_per_block - 1) / bags_per_block;
  const size_t smem =
      project ? sizeof(float) * (static_cast<size_t>(d) * d_out +
                                 static_cast<size_t>(bags_per_block) * d)
              : 0;
  auto kernel = fused_serve_pool_kernel<T, QUANT, HAS_B>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      idx_a, idx_b, mask, static_cast<const T*>(w_a), static_cast<const T*>(w_b),
      static_cast<const __nv_bfloat16*>(scale_a), static_cast<const int8_t*>(zp_a),
      static_cast<const __nv_bfloat16*>(scale_b), static_cast<const int8_t*>(zp_b),
      proj, out, B, L, d, d_out, op_mult, project, tx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool QUANT>
int launch_pair(int has_b, const int32_t* idx_a, const int32_t* idx_b,
                const float* mask, const void* w_a, const void* w_b,
                const void* scale_a, const void* zp_a, const void* scale_b,
                const void* zp_b, const float* proj, void* out, int B, int L,
                int d, int d_out, int op_mult, int project, cudaStream_t stream) {
  if (has_b) {
    return launch<T, QUANT, true>(idx_a, idx_b, mask, w_a, w_b, scale_a, zp_a,
                                  scale_b, zp_b, proj, out, B, L, d, d_out,
                                  op_mult, project, stream);
  }
  return launch<T, QUANT, false>(idx_a, idx_b, mask, w_a, w_b, scale_a, zp_a,
                                 scale_b, zp_b, proj, out, B, L, d, d_out,
                                 op_mult, project, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a table type it does not know.
int fused_serve_pool(const void* idx_a, const void* idx_b, const void* mask,
                     const void* w_a, const void* w_b, const void* scale_a,
                     const void* zp_a, const void* scale_b, const void* zp_b,
                     const void* proj, void* out, int B, int L, int d,
                     int d_out, int table_type, int has_b, int op_mult,
                     int project, void* stream) {
  const auto* ia = static_cast<const int32_t*>(idx_a);
  const auto* ib = static_cast<const int32_t*>(idx_b);
  const auto* mk = static_cast<const float*>(mask);
  const auto* pj = static_cast<const float*>(proj);
  auto st = static_cast<cudaStream_t>(stream);
  switch (table_type) {
    case kF32:
      return launch_pair<float, false>(has_b, ia, ib, mk, w_a, w_b, scale_a, zp_a,
                                       scale_b, zp_b, pj, out, B, L, d, d_out,
                                       op_mult, project, st);
    case kBF16:
      return launch_pair<__nv_bfloat16, false>(has_b, ia, ib, mk, w_a, w_b, scale_a,
                                               zp_a, scale_b, zp_b, pj, out, B, L, d,
                                               d_out, op_mult, project, st);
    case kInt8:
      return launch_pair<int8_t, true>(has_b, ia, ib, mk, w_a, w_b, scale_a, zp_a,
                                       scale_b, zp_b, pj, out, B, L, d, d_out,
                                       op_mult, project, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* serve_path_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
