// DLRM pairwise dot interaction (Hopper, sm_90a).  For each example b, with
// X = [z[b]; feats[b]] of F = T + 1 rows:
//
//   out[b, z_cols + p] = <X[i], X[j]>    over the strict lower triangle (i > j)
//                                         of X·Xᵀ, packed in np.tril_indices(F, k=-1)
//                                         order, accumulated in f32, in x's dtype
//   out[b, 0:D]        = z[b]            when z_cols = D: the top MLP's input
//
// Replaces the Pallas TPU kernel repro/kernels/dot_interaction.py::
// dot_interaction, which batched block_b = 8 examples into one MXU-shaped
// matmul and needed the batch padded to a multiple of 8; the model around
// it concatenated z with the features before it and z with its output after
// it.  Here the kernel reads z (B, D) and the features (B, T, D) in place
// through their strides and writes the top MLP's input (B, D + F(F-1)/2)
// directly, so neither concatenation reaches device memory, and it masks
// its own ragged edge: no padding.
//
// Bound on the card: latency and bytes, not arithmetic.  At DLRM-Criteo's
// F = 27, D = 16 an example reads 1.7 KB, writes 351 outputs and does 2·D
// flops per output (11 kFLOP an example): under 4 flops per byte moved,
// and at B = 256 the whole call is one launch plus a couple of dependent
// memory round trips.  Tensor cores are not used: TF32 keeps about three
// decimal digits, which would break the 1e-5 f32 tolerance and the
// reference's f32 accumulation, and at D = 16 there is no arithmetic to
// save.  The design:
//   - E examples share a block of 128 threads (the wrapper picks E), so a
//     batch of 256 is B / E blocks, and each thread computes several
//     outputs: the (example, pair) outputs of the block are walked flat,
//     128 apart, so neighbouring threads store neighbouring outputs;
//   - the block stages its examples once in shared memory as f32 rows of
//     stride D + 1 floats.  The 32 threads of a warp mostly share row i and
//     take consecutive j, so with an odd stride their x_j[k] reads fall on
//     32 distinct banks (a stride of D = 16 put them on 2: a 16-way
//     conflict); x_i[k] is one broadcast word.  Rows are read from device
//     memory in 16-byte loads where the strides and alignment allow;
//   - the pair -> (i, j) map is a table of P words each block builds in
//     shared memory once (row i writes its i entries), so no output pays a
//     square root or a search;
//   - each dot product is fmaf in k order from 0, in f32, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;

struct Args {
  const void* z;
  const void* feats;
  void* out;
  long long zs_b, zs_d;          // z strides, elements
  long long fs_b, fs_t, fs_d;    // feats strides
  long long os_b;                // out row stride
  int z_cols;                    // 0, or D: z goes into out's first D columns
  int B, F, D, E;                // E: examples per block
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row r of example b: z[b] for r = 0, else feats[b, r - 1].
template <typename T>
__device__ __forceinline__ const T* row_ptr(const Args& a, long long b, int r) {
  return r == 0 ? static_cast<const T*>(a.z) + b * a.zs_b
                : static_cast<const T*>(a.feats) + b * a.fs_b + (r - 1) * a.fs_t;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) dot_interaction_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];
  const int F = a.F, D = a.D, S = D + 1, P = F * (F - 1) / 2;
  int* pairs = reinterpret_cast<int*>(smem);   // P words: (i << 16) | j
  float* xs = smem + P;                        // E x F rows of stride S
  const long long b0 = static_cast<long long>(blockIdx.x) * a.E;
  const long long left = a.B - b0;          // >= 1: the grid is ceil(B / E)
  const int ne = left < a.E ? static_cast<int>(left) : a.E;

  if constexpr (VEC) {
    // 16 bytes a load: every row's elements are contiguous and aligned
    constexpr int V = 16 / sizeof(T);
    const int chunks = D / V;
    for (int q = threadIdx.x; q < ne * F * chunks; q += kThreads) {
      const int c = q % chunks, r = (q / chunks) % F, e = q / (chunks * F);
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row_ptr<T>(a, b0 + e, r) + c * V));
      T v[V];
      memcpy(v, &w, sizeof(w));
      float* dst = xs + (e * F + r) * S + c * V;
#pragma unroll
      for (int k = 0; k < V; ++k) dst[k] = to_f32(v[k]);
    }
  } else {
    for (int q = threadIdx.x; q < ne * F * D; q += kThreads) {
      const int k = q % D, r = (q / D) % F, e = q / (D * F);
      const long long ks = r == 0 ? a.zs_d : a.fs_d;
      xs[(e * F + r) * S + k] = to_f32(row_ptr<T>(a, b0 + e, r)[k * ks]);
    }
  }
  for (int i = threadIdx.x + 1; i < F; i += kThreads) {
    const int base = i * (i - 1) / 2;
    for (int j = 0; j < i; ++j) pairs[base + j] = (i << 16) | j;
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  if (a.z_cols) {   // z is copied exactly: f32 staging holds a bf16 value exactly
    for (int q = threadIdx.x; q < ne * D; q += kThreads) {
      const int e = q / D, k = q % D;
      out[(b0 + e) * a.os_b + k] = from_f32<T>(xs[e * F * S + k]);
    }
  }
  if (P == 0) return;
  int e = threadIdx.x / P, p = threadIdx.x % P;
  for (int q = threadIdx.x; q < ne * P; q += kThreads) {
    const int ij = pairs[p];
    const float* xi = xs + (e * F + (ij >> 16)) * S;
    const float* xj = xs + (e * F + (ij & 0xffff)) * S;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < D; ++k) acc = fmaf(xi[k], xj[k], acc);
    out[(b0 + e) * a.os_b + a.z_cols + p] = from_f32<T>(acc);
    for (p += kThreads; p >= P; p -= P) ++e;
  }
}

template <typename T>
int launch(const Args& a, int smem, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = a.D % V == 0 && a.zs_d == 1 && a.fs_d == 1 &&
                   reinterpret_cast<uintptr_t>(a.z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.feats) % 16 == 0 &&
                   a.zs_b % V == 0 && a.fs_b % V == 0 && a.fs_t % V == 0;
  auto kernel = vec ? dot_interaction_kernel<T, true> : dot_interaction_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const int grid = (a.B + a.E - 1) / a.E;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z: (B, D) with strides (zs_b, zs_d); feats: (B, T, D) with strides (fs_b,
// fs_t, fs_d), both f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); out: rows of
// stride os_b in the same dtype, z in its first z_cols (0 or D) columns and
// the F(F-1)/2 packed pairs after them.  examples_per_block >= 1; smem is
// 4 * (P + E * F * (D + 1)) bytes.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside the contract.
int dot_interaction(const void* z, long long zs_b, long long zs_d, const void* feats,
                    long long fs_b, long long fs_t, long long fs_d, void* out, long long os_b,
                    int z_cols, int B, int T, int D, int is_bf16, int examples_per_block,
                    int smem, void* stream) {
  if (B < 1 || T < 0 || D < 0 || examples_per_block < 1 || (z_cols != 0 && z_cols != D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.z = z;
  a.feats = feats;
  a.out = out;
  a.zs_b = zs_b;
  a.zs_d = zs_d;
  a.fs_b = fs_b;
  a.fs_t = fs_t;
  a.fs_d = fs_d;
  a.os_b = os_b;
  a.z_cols = z_cols;
  a.B = B;
  a.F = T + 1;
  a.D = D;
  a.E = examples_per_block;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(a, smem, st);
  return launch<float>(a, smem, st);
}

const char* dot_interaction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
