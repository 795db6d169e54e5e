// DLRM pairwise dot interaction (Hopper, sm_90a): for each example b,
// out[b, p] = <x[b, i], x[b, j]> over the strict lower triangle (i > j) of
// X·Xᵀ, packed in np.tril_indices(F, k=-1) order, accumulated in f32 and
// written in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/dot_interaction.py::
// dot_interaction, which batched block_b = 8 examples into one MXU-shaped
// matmul and needed the batch padded to a multiple of 8.  Here one block
// owns one example: it stages x[b] (F x D) in shared memory as f32, and its
// threads loop over the F(F-1)/2 pairs.  The grid is exactly B blocks, so
// there is no padding and no ragged edge.
//
// Bound on the card: memory.  At DLRM-Criteo's F = 27, D = 16 an example
// reads F·D inputs and writes 351 outputs, with 2·D flops per output —
// under 4 flops per f32 byte moved, below an H100's f32 ratio of ~20.  Tensor
// cores buy nothing at D = 16, so the kernel uses plain f32 FMAs; what
// matters is reading x once (through shared memory) and writing each packed
// output once, with neighbouring threads on neighbouring outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row i of the packed pair p: the largest i with i(i-1)/2 <= p.
__device__ __forceinline__ int pair_row(int p) {
  int i = static_cast<int>((1.0f + sqrtf(1.0f + 8.0f * p)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  return i;
}

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out,
                                       int F, int D) {
  extern __shared__ float xs[];  // F * D
  const long long b = blockIdx.x;
  const T* xb = x + b * F * D;
  for (int k = threadIdx.x; k < F * D; k += blockDim.x) xs[k] = to_f32<T>(xb[k]);
  __syncthreads();
  const int P = F * (F - 1) / 2;
  T* ob = out + b * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int i = pair_row(p);
    const int j = p - i * (i - 1) / 2;
    const float* xi = xs + i * D;
    const float* xj = xs + j * D;
    float acc = 0.0f;
    for (int k = 0; k < D; ++k) acc = fmaf(xi[k], xj[k], acc);
    ob[p] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(F) * D;
  auto kernel = dot_interaction_kernel<T>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                        static_cast<T*>(out), F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, F, D) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out: (B, F(F-1)/2) of the same dtype.  Returns cudaGetLastError().
int dot_interaction(const void* x, void* out, int B, int F, int D, int is_bf16,
                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, out, B, F, D, st);
  return launch<float>(x, out, B, F, D, st);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
