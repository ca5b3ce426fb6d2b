// Shared body of the two add_LN attention decode kernels (K1 grouped, K2
// fused). One thread block computes one query's attention over one L x U
// key matrix:
//
//   x_l   = keys_l + q                                  (U channels)
//   s_l   = tanh((x_l - mu_l) * inv_l * g + beta) * v    LayerNorm, eps 1e-12
//   e_hl  = sum_{u in head h} s_lu / temperature
//   a_h   = softmax_l(e_h)
//   ctx_u = sum_l a_{h(u), l} * keys_lu                 (tied values = keys)
//
// Phase 1: a warp per memory position l. Its lanes hold VEC-wide channel
// vectors (16-byte loads: 8 bf16 or 4 f32 channels), take the LayerNorm
// statistics with warp reductions, then the tanh chain; each lane's vector
// lies inside one head (the launcher picks VEC so that it divides U / H),
// so the per-head sums are short serial sums over the warp's per-vector
// partials in shared memory. Scores (H x L) stay in shared memory.
// Phase 2: a warp per head takes the softmax over L.
// Phase 3: a thread per channel takes the context, reading the keys once
// more (from L2: the image's keys were just read in phase 1).
//
// Everything is float32 arithmetic on the stored keys; the outputs are
// float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace addln {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr float kLnEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the keys' storage type: the reference casts the query to the
// keys' dtype for the closed-form cross term k . q.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Dynamic shared memory of one block, in bytes.
static inline size_t smem_bytes(int L, int U, int H, int vec) {
  return sizeof(float) *
         (size_t)(U + 2 + H * L + (kThreads / kWarp) * (U / vec));
}

// CLOSED_FORM: LayerNorm statistics from the precomputed key moments
// (mean_u k, mean_u k^2) and one cross term, as K1's reference does;
// otherwise two passes over U, as K2's does.
template <typename T, int VEC, bool CLOSED_FORM>
__device__ __forceinline__ void attention_block(
    const float* __restrict__ q_g, const T* __restrict__ keys,
    const float* __restrict__ key_mean, const float* __restrict__ key_m2,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, float inv_temp, float* __restrict__ ctx,
    float* __restrict__ align, int L, int U, int H, float* smem) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int nvec = U / VEC;
  const int seg = (U / H) / VEC;  // vectors per head
  float* q_s = smem;              // U: the query
  float* stats = q_s + U;         // 2: mean(q), mean(q^2)
  float* score = stats + 2;       // H * L: scores, then alignments
  float* part = score + H * L + warp * nvec;  // this warp's vector partials

  for (int u = threadIdx.x; u < U; u += blockDim.x) q_s[u] = q_g[u];
  __syncthreads();
  if (CLOSED_FORM && warp == 0) {
    float s = 0.f, s2 = 0.f;
    for (int u = lane; u < U; u += kWarp) {
      const float x = q_s[u];
      s += x;
      s2 += x * x;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      stats[0] = s / U;
      stats[1] = s2 / U;
    }
  }
  __syncthreads();

  // Phase 1: scores, a warp per position.
  for (int l = warp; l < L; l += nwarps) {
    const T* krow = keys + (size_t)l * U;
    float mu, inv;
    if (CLOSED_FORM) {
      float cross = 0.f;
      for (int vi = lane; vi < nvec; vi += kWarp) {
        float kv[VEC];
        load_vec<T, VEC>(krow + vi * VEC, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          cross += kv[i] * round_as(q_s[vi * VEC + i], keys);
      }
      cross = warp_sum(cross);
      mu = key_mean[l] + stats[0];
      const float ex2 = key_m2[l] + 2.f * cross / U + stats[1];
      inv = rsqrtf(fmaxf(ex2 - mu * mu, 0.f) + kLnEps);
    } else {
      float s = 0.f;
      for (int vi = lane; vi < nvec; vi += kWarp) {
        float kv[VEC];
        load_vec<T, VEC>(krow + vi * VEC, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += kv[i] + q_s[vi * VEC + i];
      }
      mu = warp_sum(s) / U;
      float s2 = 0.f;
      for (int vi = lane; vi < nvec; vi += kWarp) {
        float kv[VEC];
        load_vec<T, VEC>(krow + vi * VEC, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = kv[i] + q_s[vi * VEC + i] - mu;
          s2 += d * d;
        }
      }
      inv = rsqrtf(warp_sum(s2) / U + kLnEps);
    }
    for (int vi = lane; vi < nvec; vi += kWarp) {
      float kv[VEC];
      load_vec<T, VEC>(krow + vi * VEC, kv);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int u = vi * VEC + i;
        const float t = (kv[i] + q_s[u] - mu) * inv;
        acc += tanhf(t * __ldg(g + u) + __ldg(beta + u)) * __ldg(v + u);
      }
      part[vi] = acc;
    }
    __syncwarp();
    for (int h = lane; h < H; h += kWarp) {
      float s = 0.f;
      for (int j = 0; j < seg; ++j) s += part[h * seg + j];
      score[h * L + l] = s * inv_temp;
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase 2: softmax over L, a warp per head.
  for (int h = warp; h < H; h += nwarps) {
    float* row = score + h * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += kWarp) m = fmaxf(m, row[l]);
    m = warp_max(m);
    float s = 0.f;
    for (int l = lane; l < L; l += kWarp) {
      const float w = expf(row[l] - m);
      row[l] = w;
      s += w;
    }
    s = warp_sum(s);
    for (int l = lane; l < L; l += kWarp) {
      const float a = row[l] / s;
      row[l] = a;
      align[h * L + l] = a;
    }
  }
  __syncthreads();

  // Phase 3: context over the tied values, a thread per channel.
  const int d = U / H;
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const float* a = score + (u / d) * L;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc += a[l] * to_f32(keys[(size_t)l * U + u]);
    ctx[u] = acc;
  }
}

// Raises the block's dynamic shared memory limit where a launch needs more
// than the default 48 KB.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace addln
