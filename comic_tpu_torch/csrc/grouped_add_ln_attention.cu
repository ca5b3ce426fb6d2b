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
// Bound on an H100 80GB HBM3 at the main path's shapes (B=25, K=3, L=196,
// U=512, H=8, bf16 keys): the step reads 5.0 MB of keys and writes 0.6 MB
// of outputs, 1.7 us at 3.35 TB/s; its 7.5 M tanh are at least 7.5 M
// special-function operations, 1.8 us at 16 per SM per clock on 132 SMs at
// 1.98 GHz, and so bound it (chip_smoke.py computes both).
//
// Design against that bound (add_ln_common.cuh): a cluster of S blocks per
// image splits L so that 25 images fill the card; each block copies its
// chunk of the image's keys into shared memory once (TMA bulk copies) and
// every beam's query reads them there, so the keys leave device memory
// once per step; a thread per (beam, head, position) sums its head's tanh
// terms in registers; the softmax and the context are reduced across the
// cluster through distributed shared memory. The tanh takes two
// special-function operations (ex2, rcp) instead of tanhf's longer
// sequence, within the plain version's tolerances.

#include "add_ln_common.cuh"

template <typename T, int VEC>
__global__ void __launch_bounds__(addln::kThreads, 1) grouped_kernel(
    const float* __restrict__ query, const T* __restrict__ keys,
    const float* __restrict__ key_mean, const float* __restrict__ key_m2,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ temperature,
    float* __restrict__ ctx, float* __restrict__ align, int K, int L, int U,
    int H, addln::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x / plan.S;  // the cluster's image
  addln::attention_cluster<T, VEC, true>(
      query + b * K * U, keys + b * L * U, key_mean + b * L, key_m2 + b * L,
      v, g, beta, 1.f / temperature[0], ctx + b * K * U, align + b * K * H * L,
      K, L, U, H, plan, smem);
}

template <typename T, int VEC>
static int plan_for(int B, int K, int L, int U, int H, bool aligned,
                    addln::Plan* plan) {
  return (int)addln::get_plan(grouped_kernel<T, VEC>, B, K, L, U, H,
                              (int)sizeof(T), VEC, aligned, plan);
}

template <typename T, int VEC>
static int launch(const void* query, const void* keys, const void* key_mean,
                  const void* key_m2, const void* v, const void* g,
                  const void* beta, const void* temperature, void* ctx,
                  void* align, int B, int K, int L, int U, int H,
                  cudaStream_t stream) {
  addln::Plan plan;
  int err = plan_for<T, VEC>(B, K, L, U, H,
                             reinterpret_cast<uintptr_t>(keys) % 16 == 0,
                             &plan);
  if (err) return err;
  return addln::launch_plan(
      grouped_kernel<T, VEC>, plan, B, stream, static_cast<const float*>(query),
      static_cast<const T*>(keys), static_cast<const float*>(key_mean),
      static_cast<const float*>(key_m2), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const float*>(temperature), static_cast<float*>(ctx),
      static_cast<float*>(align), K, L, U, H, plan);
}

// Returns the CUDA error code of the launch (0 on success).
extern "C" int grouped_add_ln_attention(
    const void* query, const void* keys, int keys_bf16, int vec,
    const void* key_mean, const void* key_m2, const void* v, const void* g,
    const void* beta, const void* temperature, void* ctx, void* align, int B,
    int K, int L, int U, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADDLN_LAUNCH(T, VEC)                                                 \
  launch<T, VEC>(query, keys, key_mean, key_m2, v, g, beta, temperature, ctx, \
                 align, B, K, L, U, H, s)
  ADDLN_DISPATCH(ADDLN_LAUNCH)
#undef ADDLN_LAUNCH
}

// The launch plan for these shapes: out = {cluster size S, grid, dynamic
// shared memory bytes per block, keys staged in shared memory}.
extern "C" int grouped_add_ln_attention_plan(int keys_bf16, int vec,
                                             int aligned, int B, int K, int L,
                                             int U, int H, int* out) {
  addln::Plan plan;
#define ADDLN_PLAN(T, VEC) plan_for<T, VEC>(B, K, L, U, H, aligned, &plan)
  int err = [&]() -> int { ADDLN_DISPATCH(ADDLN_PLAN) }();
#undef ADDLN_PLAN
  if (err) return err;
  out[0] = plan.S;
  out[1] = B * plan.S;
  out[2] = plan.bytes;
  out[3] = plan.staged;
  return 0;
}
