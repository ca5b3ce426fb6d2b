// K2: flat add_LN attention decode step for sm_90a, one query per row.
//
// Replaces the Pallas kernel comic_tpu/ops/fused_attention.py:
// fused_add_ln_attention (pallas_call at :90, body _kernel :43-65).
// Inputs: projected queries (R, U) f32, each row's own keys (R, L, U) bf16
// or f32, v / ln scale / ln bias (U,) f32 and the temperature (a device
// scalar). Outputs: context (R, U) f32 and alignments (R, H, L) f32. The
// LayerNorm statistics are taken in two passes over U inside the kernel, as
// the Pallas kernel takes them. The Pallas wrapper's padding of rows to a
// multiple of 8 is a TPU tiling choice and has no counterpart here.
//
// Bound on an H100: memory. On the greedy serving path (R=25, L=196,
// U=512, H=8, bf16 keys) a step must read 25*196*512*2 B = 5.0 MB of keys:
// about 1.5 us at 3.35 TB/s, above the ~1.1 us of its float32 work.
//
// Design against that bound: one block per row reads its keys from device
// memory once; the three statistics/tanh passes over a position re-read its
// 1 KB row from L1, and the context pass reads the row's keys from L2. The
// scores never leave the SM. With 25 blocks on 132 SMs this first version is
// latency-bound at the serving batch (see PERF.md).

#include "add_ln_common.cuh"

template <typename T, int VEC>
__global__ void __launch_bounds__(addln::kThreads) fused_kernel(
    const float* __restrict__ query, const T* __restrict__ keys,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ temperature,
    float* __restrict__ ctx, float* __restrict__ align, int L, int U, int H) {
  extern __shared__ float smem[];
  const size_t r = blockIdx.x;
  addln::attention_block<T, VEC, false>(
      query + r * U, keys + r * L * U, nullptr, nullptr, v, g, beta,
      1.f / temperature[0], ctx + r * U, align + r * H * L, L, U, H, smem);
}

template <typename T, int VEC>
static int launch(const void* query, const void* keys, const void* v,
                  const void* g, const void* beta, const void* temperature,
                  void* ctx, void* align, int R, int L, int U, int H,
                  cudaStream_t stream) {
  const size_t smem = addln::smem_bytes(L, U, H, VEC);
  cudaError_t err = addln::allow_smem(fused_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<T, VEC><<<R, addln::kThreads, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const T*>(keys),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<const float*>(temperature),
      static_cast<float*>(ctx), static_cast<float*>(align), L, U, H);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_add_ln_attention(
    const void* query, const void* keys, int keys_bf16, int vec,
    const void* v, const void* g, const void* beta, const void* temperature,
    void* ctx, void* align, int R, int L, int U, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_bf16 && vec == 8)
    return launch<__nv_bfloat16, 8>(query, keys, v, g, beta, temperature, ctx,
                                     align, R, L, U, H, s);
  if (keys_bf16 && vec == 1)
    return launch<__nv_bfloat16, 1>(query, keys, v, g, beta, temperature, ctx,
                                     align, R, L, U, H, s);
  if (!keys_bf16 && vec == 4)
    return launch<float, 4>(query, keys, v, g, beta, temperature, ctx, align,
                            R, L, U, H, s);
  if (!keys_bf16 && vec == 1)
    return launch<float, 1>(query, keys, v, g, beta, temperature, ctx, align,
                            R, L, U, H, s);
  return (int)cudaErrorInvalidValue;
}
