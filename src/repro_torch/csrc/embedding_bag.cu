// Multi-hot quotient-remainder embedding bag for Hopper, sm_90a:
//
//   out[b] = round( sum_l w[b, l] * (W_rem[rem[b, l]] op W_quo[quo[b, l]]) )
//
// with op in {mult, add}, f32 or bf16 tables, the mask w already in the
// table dtype (the wrapper casts it, as the reference does), each slot's
// contribution and the bag sum in f32, and one rounding to the table dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_bag.py::
// qr_embedding_bag.  The TPU walks a sequential (B, L) grid and carries the
// bag sum across the L steps in the revisited output block.  Here a group
// of TX threads owns one bag: each thread owns the columns c = tx, tx + TX,
// ... of it and loops over l in order, adding into an f32 register, so the
// sum never rounds to bf16 on the way (the f32-accumulation audit at L=16,
// D=128 holds it to that).  Every thread of the group loads the bag's ids
// and weights itself; nothing is prefetched.  A slot with weight 0 still
// multiplies (no branch), so an all-zero bag is exactly zero and L = 0
// writes zeros.
//
// Bound on the card: memory.  Per bag the kernel reads L ids per table, L
// weights, 2L scattered table rows and writes one row; it does 3 f32
// operations per element of a slot, far below the ~20 operations per byte
// at which the H100's f32 rate would bind.  The design touches device
// memory once per gathered row and once per output element, and keeps the
// running sum in a register.  Products and sums use __fmul_rn / __fadd_rn
// so that no FMA contraction changes the plain version's rounding.
//
// Contract (the Python wrapper checks it): every pointer is on one device
// and contiguous; ids are int32 (B, L) and in range; mask is (B, L) in the
// table dtype; tables are (rows, d) of one dtype.

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

template <typename T>
__global__ void qr_embedding_bag_kernel(const int32_t* __restrict__ rem,
                                        const int32_t* __restrict__ quo,
                                        const T* __restrict__ mask,
                                        const T* __restrict__ w_rem,
                                        const T* __restrict__ w_quo, T* __restrict__ out,
                                        int B, int L, int d, int op_mult, int tx_per_bag) {
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / tx_per_bag) +
                      threadIdx.x / tx_per_bag;
  if (b >= B) return;
  const int32_t* ir = rem + b * L;
  const int32_t* iq = quo + b * L;
  const T* mk = mask + b * L;
  for (int c = threadIdx.x % tx_per_bag; c < d; c += tx_per_bag) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const float a = to_f32(w_rem[static_cast<long long>(ir[l]) * d + c]);
      const float q = to_f32(w_quo[static_cast<long long>(iq[l]) * d + c]);
      const float row = op_mult ? __fmul_rn(a, q) : __fadd_rn(a, q);
      acc = __fadd_rn(acc, __fmul_rn(row, to_f32(mk[l])));
    }
    store(out + b * d + c, acc);
  }
}

template <typename T>
int launch(const void* rem, const void* quo, const void* mask, const void* w_rem,
           const void* w_quo, void* out, int B, int L, int d, int op_mult,
           cudaStream_t stream) {
  int tx = 1;
  while (tx < d && tx < 32) tx <<= 1;
  const int bags_per_block = kThreads / tx;
  const int grid = (B + bags_per_block - 1) / bags_per_block;
  qr_embedding_bag_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(rem), static_cast<const int32_t*>(quo),
      static_cast<const T*>(mask), static_cast<const T*>(w_rem),
      static_cast<const T*>(w_quo), static_cast<T*>(out), B, L, d, op_mult, tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for a table type it does not know.
int qr_embedding_bag(const void* rem, const void* quo, const void* mask, const void* w_rem,
                     const void* w_quo, void* out, int B, int L, int d, int table_type,
                     int op_mult, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (table_type) {
    case kF32:
      return launch<float>(rem, quo, mask, w_rem, w_quo, out, B, L, d, op_mult, st);
    case kBF16:
      return launch<__nv_bfloat16>(rem, quo, mask, w_rem, w_quo, out, B, L, d, op_mult, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
