// K1: beam-grouped add_LN attention decode step for sm_90a.
//
// Replaces the Pallas kernel comic_tpu/ops/grouped_attention.py:
// grouped_add_ln_attention (pallas_call at :128, body _kernel :54-85).
// Inputs: projected queries (B, K, U) f32, the UNtiled keys of each image
// (B, L, U) bf16 or f32 with their f32 channel moments key_mean / key_m2
// (B, L), v / ln scale / ln bias (U,) f32 and the temperature (a device
// scalar, so the launch needs no host sync). Outputs: context (B, K, U) f32
// and alignments (B, K, H, L) f32. LayerNorm statistics come in closed form
// from the key moments and one cross term per position, inside the kernel.
//
// Bound on an H100: memory. At the main path's shapes (B=25, K=3, L=196,
// U=512, H=8, bf16 keys) the step must read 25*196*512*2 B = 5.0 MB of keys
// and write 0.6 MB of outputs: about 1.7 us at 3.35 TB/s, against about
// 1.4 us for its ~90 MFLOP of float32 work at 67 TFLOP/s.
//
// Design against that bound: one block per (image, beam), and the K blocks
// of one image are adjacent in the grid, so an image's keys come from
// device memory about once and from L2 for the other beams and for the
// context pass; the tanh chain and the scores never leave the SM. With 75
// blocks on 132 SMs the kernel is latency-bound, not bandwidth-bound, at
// this batch: a simple, right first version (see PERF.md).

#include "add_ln_common.cuh"

template <typename T, int VEC>
__global__ void __launch_bounds__(addln::kThreads) grouped_kernel(
    const float* __restrict__ query, const T* __restrict__ keys,
    const float* __restrict__ key_mean, const float* __restrict__ key_m2,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ temperature,
    float* __restrict__ ctx, float* __restrict__ align, int K, int L, int U,
    int H) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / K;
  const size_t row = blockIdx.x;  // = b * K + k
  addln::attention_block<T, VEC, true>(
      query + row * U, keys + (size_t)b * L * U, key_mean + (size_t)b * L,
      key_m2 + (size_t)b * L, v, g, beta, 1.f / temperature[0],
      ctx + row * U, align + row * H * L, L, U, H, smem);
}

template <typename T, int VEC>
static int launch(const void* query, const void* keys, const void* key_mean,
                  const void* key_m2, const void* v, const void* g,
                  const void* beta, const void* temperature, void* ctx,
                  void* align, int B, int K, int L, int U, int H,
                  cudaStream_t stream) {
  const size_t smem = addln::smem_bytes(L, U, H, VEC);
  cudaError_t err = addln::allow_smem(grouped_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  grouped_kernel<T, VEC><<<B * K, addln::kThreads, smem, stream>>>(
      static_cast<const float*>(query), static_cast<const T*>(keys),
      static_cast<const float*>(key_mean), static_cast<const float*>(key_m2),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<const float*>(temperature),
      static_cast<float*>(ctx), static_cast<float*>(align), K, L, U, H);
  return (int)cudaGetLastError();
}

// Returns the CUDA error code of the launch (0 on success).
extern "C" int grouped_add_ln_attention(
    const void* query, const void* keys, int keys_bf16, int vec,
    const void* key_mean, const void* key_m2, const void* v, const void* g,
    const void* beta, const void* temperature, void* ctx, void* align, int B,
    int K, int L, int U, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keys_bf16 && vec == 8)
    return launch<__nv_bfloat16, 8>(query, keys, key_mean, key_m2, v, g, beta,
                                     temperature, ctx, align, B, K, L, U, H, s);
  if (keys_bf16 && vec == 1)
    return launch<__nv_bfloat16, 1>(query, keys, key_mean, key_m2, v, g, beta,
                                     temperature, ctx, align, B, K, L, U, H, s);
  if (!keys_bf16 && vec == 4)
    return launch<float, 4>(query, keys, key_mean, key_m2, v, g, beta,
                            temperature, ctx, align, B, K, L, U, H, s);
  if (!keys_bf16 && vec == 1)
    return launch<float, 1>(query, keys, key_mean, key_m2, v, g, beta,
                            temperature, ctx, align, B, K, L, U, H, s);
  return (int)cudaErrorInvalidValue;
}
