// One-hot quotient-remainder lookup (paper Alg. 2) for Hopper, sm_90a:
//
//   out[n] = W_rem[rem[n]] op W_quo[quo[n]]          op in {mult, add}
//
// qr_gather (K1): dense f32 / bf16 tables; both rows widen to f32, combine
// in f32, one rounding to the table dtype.  (K5, the int8 pair, lives in
// grouped_lookup.cu.)
//
// Replaces the Pallas TPU kernel repro/kernels/qr_gather.py::qr_gather.  On
// the TPU the ids were scalar-prefetch operands that steered one (1, D) row
// DMA per table per sequential grid step.  Here a group of TX threads owns
// one output row: every thread of the group loads the row's two ids itself
// (one cached load, no prefetch stage), then owns the columns
// c = tx, tx + TX, ... of that row, so the group reads each gathered row as
// one contiguous run.
//
// Bound on the card: memory.  Per output row the kernel reads two ids, two
// table rows (4D bytes f32, 2D bf16) and writes one row; it does 1 f32
// operation per element, far below the ~20 operations per byte at which
// the H100's f32 rate would bind.  The rows are scattered, so the design's
// aim is to touch device memory once per gathered row and once per output
// element.  The combine uses __fmul_rn / __fadd_rn so that no FMA
// contraction changes the plain version's rounding.
//
// Contract (the Python wrapper checks it): every pointer is on one device
// and contiguous; ids are int32 (N,) and in range; tables are (rows, d) of
// one dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

enum TableType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float combine(float a, float b, int op_mult) {
  return op_mult ? __fmul_rn(a, b) : __fadd_rn(a, b);
}

// Threads per output row: the next power of two >= d, at most a warp.
int threads_per_row(int d) {
  int tx = 1;
  while (tx < d && tx < 32) tx <<= 1;
  return tx;
}

template <typename T>
__global__ void qr_gather_kernel(const int32_t* __restrict__ rem,
                                 const int32_t* __restrict__ quo,
                                 const T* __restrict__ w_rem,
                                 const T* __restrict__ w_quo, T* __restrict__ out,
                                 int n, int d, int op_mult, int tx_per_row) {
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / tx_per_row) +
                      threadIdx.x / tx_per_row;
  if (r >= n) return;
  const T* a = w_rem + static_cast<long long>(rem[r]) * d;
  const T* b = w_quo + static_cast<long long>(quo[r]) * d;
  T* o = out + r * d;
  for (int c = threadIdx.x % tx_per_row; c < d; c += tx_per_row) {
    store(o + c, combine(to_f32(a[c]), to_f32(b[c]), op_mult));
  }
}

int grid_for(int n, int tx) {
  const int rows_per_block = kThreads / tx;
  return (n + rows_per_block - 1) / rows_per_block;
}

template <typename T>
int launch_dense(const void* rem, const void* quo, const void* w_rem, const void* w_quo,
                 void* out, int n, int d, int op_mult, cudaStream_t stream) {
  const int tx = threads_per_row(d);
  qr_gather_kernel<T><<<grid_for(n, tx), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(rem), static_cast<const int32_t*>(quo),
      static_cast<const T*>(w_rem), static_cast<const T*>(w_quo), static_cast<T*>(out),
      n, d, op_mult, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a table type it does not know.
int qr_gather(const void* rem, const void* quo, const void* w_rem, const void* w_quo,
              void* out, int n, int d, int table_type, int op_mult, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (table_type) {
    case kF32:
      return launch_dense<float>(rem, quo, w_rem, w_quo, out, n, d, op_mult, st);
    case kBF16:
      return launch_dense<__nv_bfloat16>(rem, quo, w_rem, w_quo, out, n, d, op_mult, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* qr_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
