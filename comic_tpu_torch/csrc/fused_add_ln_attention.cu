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
// Bound on an H100 80GB HBM3 on the greedy serving path (R=25, L=196,
// U=512, H=8, bf16 keys): a step reads 5.0 MB of keys, 1.5 us at
// 3.35 TB/s; its 2.5 M tanh take at least 0.6 us on the special-function
// units, so bytes bound it (chip_smoke.py computes both).
//
// Design against that bound (add_ln_common.cuh): a cluster of S blocks per
// row splits L, so that 25 rows fill the card; each block copies its chunk
// of the row's keys into shared memory once (TMA bulk copies), and the two
// statistics passes, the tanh pass and the context read them there; a
// thread per (head, position) sums its head's tanh terms in registers; the
// softmax and the context are reduced across the cluster through
// distributed shared memory.

#include "add_ln_common.cuh"

template <typename T, int VEC>
__global__ void __launch_bounds__(addln::kThreads, 1) fused_kernel(
    const float* __restrict__ query, const T* __restrict__ keys,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, const float* __restrict__ temperature,
    float* __restrict__ ctx, float* __restrict__ align, int L, int U, int H,
    addln::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t r = blockIdx.x / plan.S;  // the cluster's row
  addln::attention_cluster<T, VEC, false>(
      query + r * U, keys + r * L * U, nullptr, nullptr, v, g, beta,
      1.f / temperature[0], ctx + r * U, align + r * H * L, 1, L, U, H, plan,
      smem);
}

template <typename T, int VEC>
static int plan_for(int R, int L, int U, int H, bool aligned,
                    addln::Plan* plan) {
  return (int)addln::get_plan(fused_kernel<T, VEC>, R, 1, L, U, H,
                              (int)sizeof(T), VEC, aligned, plan);
}

template <typename T, int VEC>
static int launch(const void* query, const void* keys, const void* v,
                  const void* g, const void* beta, const void* temperature,
                  void* ctx, void* align, int R, int L, int U, int H,
                  cudaStream_t stream) {
  addln::Plan plan;
  int err = plan_for<T, VEC>(R, L, U, H,
                             reinterpret_cast<uintptr_t>(keys) % 16 == 0,
                             &plan);
  if (err) return err;
  return addln::launch_plan(
      fused_kernel<T, VEC>, plan, R, stream, static_cast<const float*>(query),
      static_cast<const T*>(keys), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<const float*>(temperature), static_cast<float*>(ctx),
      static_cast<float*>(align), L, U, H, plan);
}

// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_add_ln_attention(
    const void* query, const void* keys, int keys_bf16, int vec,
    const void* v, const void* g, const void* beta, const void* temperature,
    void* ctx, void* align, int R, int L, int U, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ADDLN_LAUNCH(T, VEC)                                          \
  launch<T, VEC>(query, keys, v, g, beta, temperature, ctx, align, R, L, U, \
                 H, s)
  ADDLN_DISPATCH(ADDLN_LAUNCH)
#undef ADDLN_LAUNCH
}

// The launch plan for these shapes: out = {cluster size S, grid, dynamic
// shared memory bytes per block, keys staged in shared memory}.
extern "C" int fused_add_ln_attention_plan(int keys_bf16, int vec,
                                           int aligned, int R, int L, int U,
                                           int H, int* out) {
  addln::Plan plan;
#define ADDLN_PLAN(T, VEC) plan_for<T, VEC>(R, L, U, H, aligned, &plan)
  int err = [&]() -> int { ADDLN_DISPATCH(ADDLN_PLAN) }();
#undef ADDLN_PLAN
  if (err) return err;
  out[0] = plan.S;
  out[1] = R * plan.S;
  out[2] = plan.bytes;
  out[3] = plan.staged;
  return 0;
}
