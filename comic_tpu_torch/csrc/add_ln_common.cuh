// Shared body of the two add_LN attention decode kernels (K1 grouped, K2
// fused) for sm_90a. For one image (K1: its K beam queries) or one row (K2:
// one query) it computes, over an L x U key matrix:
//
//   q'    = q rounded to the keys' dtype                   (as comic_tpu's
//           decode step casts the projected query before scoring)
//   x_l   = keys_l + q'                                    (U channels)
//   s_l   = tanh((x_l - mu_l) * inv_l * g + beta) * v       LayerNorm, eps 1e-12
//   e_hl  = sum_{u in head h} s_lu / temperature
//   a_h   = softmax_l(e_h)                                 (returned, float32)
//   ctx_u = sum_l round(a_{h(u), l}) * keys_lu             (tied values = keys;
//           the alignments rounded to the keys' dtype, as the reference's
//           context product takes them)
//
// Design for Hopper. One image (or row) is one thread-block cluster of S
// blocks (S <= 8); block s takes the contiguous positions
// [s*L/S, (s+1)*L/S). The launcher picks S from the shapes and from how
// many clusters the card holds at once (cudaOccupancyMaxActiveClusters):
// it minimises the positions the busiest SM takes, and raises S where a
// block's keys would not fit shared memory.
//
//  1. Stage: lane 0 of each warp copies rows of the block's chunk of keys
//     into shared memory, one TMA bulk copy per row behind one mbarrier (a
//     plain copy where the rows are not 16-byte multiples), into rows
//     padded to an odd number of 16-byte units so that lanes reading the
//     same channel of neighbouring rows hit distinct banks. Meanwhile the
//     block stages g and beta (scaled by 2 log2(e) for the tanh below), v,
//     the rounded queries and the key moments. Every later read of a key
//     comes from shared memory. A chunk too large for shared memory at
//     every S is read from device memory in place.
//  2. Statistics: with the task layout of the scores, each thread sums one
//     head's share (K1: the cross term q'.k; K2: the sum, then the squared
//     deviations); the head shares are then added in head order into the
//     LayerNorm mean and inverse deviation of every (query, position), in
//     closed form from the key moments for K1, in two passes for K2.
//  3. Scores: a thread per (query, head, position) task walks the head's
//     channels in 16-byte vectors and sums its tanh terms in registers: no
//     shuffles, no shared-memory partials and no dependency between tasks,
//     so every thread has independent work and the special-function units
//     (two operations per tanh) set the pace. Neighbouring lanes take
//     neighbouring positions, so the parameters they read are broadcasts.
//  4. Softmax across the cluster: each block writes its per-(query, head)
//     score maximum and sum of exponentials into every block's shared
//     memory; after cluster.sync() every block combines all S of them in
//     rank order (deterministic, no atomics) and normalises its chunk,
//     keeping the alignments rounded to the keys' dtype for the context.
//  5. Context: a thread per (channel vector, group of positions) takes the
//     partial context of up to four queries from each staged key read;
//     after cluster.sync() block s sums the S partials of its share of the
//     K x U outputs in rank order.
//
// On an H100 80GB HBM3 (700 W) at the main path's shapes the launcher picks
// S = 4: 100 blocks of 49 positions, one per SM. A launch takes about 23 us
// (K1) and 15 us (K2); the scores run at about 1.6x their special-function
// bound on those 100 SMs, and the other phases are short steps separated
// by block and cluster barriers (PERF.md).
//
// tanh(x) = 1 - 2 / (2^(2 log2(e) x) + 1) on the special-function unit
// (ex2.approx and rcp.approx, 2 ulp each) instead of tanhf: its absolute
// error stays below 3e-7 for every x, which moves an alignment by ~1e-8,
// far inside the plain version's tolerances (tanh.approx.f32's 2^-11
// relative error would not hold them).
//
// One launch per decode step; the outputs are float32.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <vector>

namespace addln {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 8;     // the portable cluster size
// queries that share one pass over the keys (K1; K2 has one query)
constexpr int kQueryBlock = 4;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr float kLnEps = 1e-12f;
constexpr float kTwoLog2e = 2.885390081777926815f;  // tanh via 2^(2x log2 e)

// --- launch plan (host and device) ------------------------------------------

struct Plan {
  int S;        // blocks per cluster (= per image or row)
  int chunk;    // most positions a block takes: ceil(L / S)
  int staged;   // the chunk's keys are copied to shared memory
  int bulk;     // ... by TMA bulk copies
  int stride;   // elements from one key row to the next where they are read
  // byte offsets into the block's dynamic shared memory (the mbarrier of the
  // bulk copies comes first)
  int off_keys, off_par, off_q, off_kmom, off_stat, off_score, off_qstat,
      off_gstat, off_rstat, off_rctx, off_cpart;
  int bytes;  // dynamic shared memory of one block
};

static inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }
static inline int round16(size_t x) { return (int)round_up(x, 16); }

// The context takes a thread per (channel vector, position group), each for
// every query; G groups of positions fill the block's threads, as far as
// their G x K x U partials stay within 32 x U floats.
__host__ __device__ inline int ctx_groups(int K, int U, int vec) {
  int g = kThreads / (U / vec);
  if (g * K > 32) g = 32 / K;
  return g < 1 ? 1 : g;
}

// Staged key row stride in elements: 16-byte units, an odd number of them,
// for 16-byte loads and bulk copies (the 8 lanes of one load phase then read
// 8 distinct bank groups); an odd number of 4-byte words for scalar loads.
static inline int staged_stride(int U, int esize, int vec, bool bulk) {
  const size_t unit = (vec > 1 || bulk) ? 16 : 4;
  size_t bytes = round_up((size_t)U * esize, unit);
  if ((bytes / unit) % 2 == 0) bytes += unit;
  return (int)(bytes / esize);
}

static inline Plan layout(int S, bool staged, int K, int L, int U, int H,
                          int esize, int vec, bool aligned) {
  Plan p;
  p.S = S;
  p.chunk = (L + S - 1) / S;
  p.staged = staged;
  p.bulk = staged && aligned && (U * esize) % 16 == 0;
  p.stride = staged ? staged_stride(U, esize, vec, p.bulk) : U;
  const size_t f = sizeof(float);
  size_t off = 16;  // the mbarrier
  p.off_keys = (int)off;
  if (staged) off += round16((size_t)p.chunk * p.stride * esize);
  p.off_par = (int)off;  // g and beta scaled by 2 log2(e), v
  off += round16(f * 3 * U);
  p.off_q = (int)off;  // the K queries, rounded to the keys' dtype
  off += round16(f * K * U);
  p.off_kmom = (int)off;  // chunk x (key mean, key mean square) (K1)
  off += round16(f * 2 * p.chunk);
  p.off_stat = (int)off;  // K x chunk x (mean, inverse deviation)
  off += round16(f * 2 * K * p.chunk);
  p.off_score = (int)off;  // K x H x chunk scores, then alignments
  off += round16(f * K * H * p.chunk);
  p.off_qstat = (int)off;  // K x (mean, mean square) of the rounded query
  off += round16(f * 2 * K);
  p.off_gstat = (int)off;  // K*H x (max, 1 / sum of exp) over the cluster
  off += round16(f * 2 * K * H);
  p.off_rstat = (int)off;  // S x K*H x (max, sum of exp), pushed by each rank
  off += round16(f * S * 2 * K * H);
  p.off_rctx = (int)off;  // S x this block's share of the K x U context
  off += round16(f * S * ((K * U + S - 1) / S));
  p.off_cpart = (int)off;  // G x K x U partial context, G position groups
  off += round16(f * ctx_groups(K, U, vec) * K * U);
  p.bytes = off > (size_t)kMaxSmem ? -1 : (int)off;
  return p;
}

// The plan for a launch: cached per kernel and shapes, since the decode loop
// launches the same shapes every step.
struct PlanKey {
  const void* kern;
  int dev, rows, K, L, U, H, esize, vec, aligned;
};

template <typename Kernel>
static cudaError_t get_plan(Kernel kern, int rows, int K, int L, int U, int H,
                            int esize, int vec, bool aligned, Plan* out) {
  static std::mutex mu;
  static std::vector<std::pair<PlanKey, Plan>> cache;
  PlanKey key;
  memset(&key, 0, sizeof(key));
  key.kern = (const void*)kern;
  cudaError_t err = cudaGetDevice(&key.dev);
  if (err != cudaSuccess) return err;
  key.rows = rows; key.K = K; key.L = L; key.U = U; key.H = H;
  key.esize = esize; key.vec = vec; key.aligned = aligned;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& kv : cache)
    if (memcmp(&kv.first, &key, sizeof(key)) == 0) {
      *out = kv.second;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, key.dev);
  if (err != cudaSuccess) return err;
  const int smax = L < kMaxCluster ? L : kMaxCluster;
  long best_cost = -1;
  Plan best;
  for (int staged = 1; staged >= 0 && best_cost < 0; --staged) {
    for (int S = 1; S <= smax; ++S) {
      Plan p = layout(S, staged, K, L, U, H, esize, vec, aligned);
      if (p.bytes < 0) continue;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(rows * S);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = p.bytes;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = S;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(&active, kern, &cfg) != cudaSuccess
          || active <= 0) {
        cudaGetLastError();  // clear it: this S just does not fit
        continue;
      }
      // the positions the busiest SM takes: waves of clusters, each wave's
      // blocks spread over the SMs
      const long waves = (rows + active - 1) / active;
      const long per_wave = rows < active ? rows : active;
      const long cost = waves * ((per_wave * S + sms - 1) / sms) * p.chunk;
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
  }
  if (best_cost < 0) return cudaErrorInvalidConfiguration;
  cache.push_back({key, best});
  *out = best;
  return cudaSuccess;
}

template <typename... Params, typename... Args>
static int launch_plan(void (*kern)(Params...), const Plan& p, int rows,
                       cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * p.S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Returns CALL(T, VEC) for the keys' type and vector width the wrapper
// passes (keys_bf16, vec in scope).
#define ADDLN_DISPATCH(CALL)                                  \
  if (keys_bf16 && vec == 8) return CALL(__nv_bfloat16, 8);  \
  if (keys_bf16 && vec == 1) return CALL(__nv_bfloat16, 1);  \
  if (!keys_bf16 && vec == 4) return CALL(float, 4);         \
  if (!keys_bf16 && vec == 1) return CALL(float, 1);         \
  return (int)cudaErrorInvalidValue;

// --- phase timestamps ----------------------------------------------------------
//
// Built with -DADDLN_PHASES (comic_tpu_torch/tools/kernel_phases.py does),
// block b writes the global timer (ns) at each phase boundary into
// addln_phase_ns[b][i] after a block barrier, and the C entry
// addln_read_phases copies the table to the host. Without it the marks are
// empty and the kernels are as shipped.
constexpr int kPhaseMarks = 9;
constexpr int kPhaseBlocks = 2048;
#ifdef ADDLN_PHASES
__device__ unsigned long long addln_phase_ns[kPhaseBlocks][kPhaseMarks];
#define ADDLN_PHASE(i)                                                     \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) {                   \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      addln_phase_ns[blockIdx.x][i] = t_;                                  \
    }                                                                      \
  } while (0)
#else
#define ADDLN_PHASE(i) \
  do {                 \
  } while (0)
#endif

// --- device helpers -----------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the keys' storage type T
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// tanh(y / (2 log2 e)) = 1 - 2 / (2^y + 1): the caller passes y, the
// argument already scaled (see the note at the top).
__device__ __forceinline__ float tanh_scaled(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

// VEC keys from shared or device memory (a generic pointer)
template <typename T, int VEC>
__device__ __forceinline__ void load_keys(const T* p, float (&out)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(p[i]);
  }
}

// VEC float32 values from shared memory
template <int VEC>
__device__ __forceinline__ void load_chan(const float* p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      const float4 x = reinterpret_cast<const float4*>(p)[c];
      out[4 * c] = x.x;
      out[4 * c + 1] = x.y;
      out[4 * c + 2] = x.z;
      out[4 * c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  }
}

// VEC float32 values into shared memory
template <int VEC>
__device__ __forceinline__ void store_chan(float* p, const float (&x)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x[i];
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier's one arrival, expecting `bytes` of bulk copies to complete.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16) from device memory into
// this block's shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Cluster barrier halves: arrive (relaxed, or releasing this thread's
// writes) and wait (acquiring the other blocks').
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// --- the cluster's work ---------------------------------------------------------

// Phase 2, per-head sums: a thread per (query k, head h, position l) task,
// as in the scores, sums over the head's channels
//   kCross:  q'_k . keys_l                (K1's cross term)
//   kSum:    keys_l + q'_k                (K2's first pass)
//   kSquare: (keys_l + q'_k - mean)^2     (K2's second pass)
// into part[k][h][l]; the caller adds the H parts in head order.
enum HeadSum { kCross, kSum, kSquare };

template <typename T, int VEC, HeadSum MODE>
__device__ __forceinline__ void head_sums(const T* kb, int stride,
                                          const float* q_s,
                                          const float2* stat, float* part,
                                          int K, int n_l, int chunk, int U,
                                          int H) {
  const int D = U / H;
  const int ntask = K * H * n_l;
  for (int t = threadIdx.x; t < ntask; t += kThreads) {
    const int kh = t / n_l, l = t - kh * n_l;
    const int k = kh / H, h = kh - k * H;
    const T* krow = kb + (size_t)l * stride + h * D;
    const float* qrow = q_s + (size_t)k * U + h * D;
    const float mu = MODE == kSquare ? stat[k * chunk + l].x : 0.f;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += VEC) {
      float kv[VEC], qv[VEC];
      load_keys<T, VEC>(krow + c, kv);
      load_chan<VEC>(qrow + c, qv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (MODE == kCross) {
          acc[i] = fmaf(kv[i], qv[i], acc[i]);
        } else if constexpr (MODE == kSum) {
          acc[i] += kv[i] + qv[i];
        } else {
          const float d = kv[i] + qv[i] - mu;
          acc[i] = fmaf(d, d, acc[i]);
        }
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum += acc[i];
    part[kh * chunk + l] = sum;
  }
}

// The sum over heads, in head order, of part[k][.][l].
__device__ __forceinline__ float heads_total(const float* part, int k, int l,
                                             int H, int chunk) {
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += part[(k * H + h) * chunk + l];
  return s;
}

// Phase 3: a thread per (query k, head h, position l) task, l fastest, sums
// the head's tanh terms in registers into score[k][h][l] (scaled by
// inv_temp).
template <typename T, int VEC>
__device__ __forceinline__ void score_tasks(
    const T* kb, int stride, const float* q_s, const float* par_s,
    const float2* stat, float* score, float inv_temp, int K, int n_l,
    int chunk, int U, int H) {
  const int D = U / H;
  const int ntask = K * H * n_l;
  for (int t = threadIdx.x; t < ntask; t += kThreads) {
    const int kh = t / n_l, l = t - kh * n_l;
    const int k = kh / H, h = kh - k * H;
    const float2 st = stat[k * chunk + l];
    const T* krow = kb + (size_t)l * stride + h * D;
    const float* qrow = q_s + (size_t)k * U + h * D;
    const float* g_s = par_s + h * D;
    const float* b_s = par_s + U + h * D;
    const float* v_s = par_s + 2 * U + h * D;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += VEC) {
      float kv[VEC], qv[VEC], gv[VEC], bv[VEC], vv[VEC];
      load_keys<T, VEC>(krow + c, kv);
      load_chan<VEC>(qrow + c, qv);
      load_chan<VEC>(g_s + c, gv);
      load_chan<VEC>(b_s + c, bv);
      load_chan<VEC>(v_s + c, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float x = (kv[i] + qv[i] - st.x) * st.y;
        acc[i] = fmaf(tanh_scaled(fmaf(x, gv[i], bv[i])), vv[i], acc[i]);
      }
    }
    float e = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) e += acc[i];
    score[kh * chunk + l] = e * inv_temp;
  }
}

// One cluster: q (K, U) f32, keys (L, U) T of one image or row, key moments
// (L) (CLOSED_FORM only), outputs ctx (K, U) and align (K, H, L).
// CLOSED_FORM: LayerNorm statistics from the key moments and one cross term
// (K1's reference); otherwise two passes over U (K2's).
template <typename T, int VEC, bool CLOSED_FORM>
__device__ __forceinline__ void attention_cluster(
    const float* __restrict__ q_g, const T* __restrict__ keys,
    const float* __restrict__ key_mean, const float* __restrict__ key_m2,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ beta, float inv_temp, float* __restrict__ ctx,
    float* __restrict__ align, int K, int L, int U, int H, const Plan& pl,
    unsigned char* smem) {
  // barrier 0: every block of the cluster has started before any block
  // writes into another's shared memory (waited on after the scores)
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int S = pl.S, chunk = pl.chunk, stride = pl.stride;
  const int rank = (int)cluster.block_rank();
  const int l0 = rank * L / S;
  const int n_l = (rank + 1) * L / S - l0;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nvec = U / VEC;
  const int seg = U / H / VEC;  // vectors per head
  const int KH = K * H;
  const int N = K * U;                 // context outputs of the cluster
  const int slice = (N + S - 1) / S;   // most outputs a block sums

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* kst = reinterpret_cast<T*>(smem + pl.off_keys);
  float* par_s = reinterpret_cast<float*>(smem + pl.off_par);
  float* q_s = reinterpret_cast<float*>(smem + pl.off_q);
  float2* kmom = reinterpret_cast<float2*>(smem + pl.off_kmom);
  float2* stat = reinterpret_cast<float2*>(smem + pl.off_stat);
  float* score = reinterpret_cast<float*>(smem + pl.off_score);
  float* qstat = reinterpret_cast<float*>(smem + pl.off_qstat);
  float* gstat = reinterpret_cast<float*>(smem + pl.off_gstat);
  float* rstat = reinterpret_cast<float*>(smem + pl.off_rstat);
  float* rctx = reinterpret_cast<float*>(smem + pl.off_rctx);
  const T* kchunk = keys + (size_t)l0 * U;
  const T* kb = pl.staged ? kst : kchunk;

  ADDLN_PHASE(0);
  // 1. Stage the chunk's keys; meanwhile stage g, beta, v, the rounded
  // queries and the key moments, and take the query moments.
  if (pl.bulk) {
    const uint32_t row = (uint32_t)(U * sizeof(T));
    if (tid == 0) {
      mbar_init(bar);
      mbar_expect(bar, row * n_l);
    }
    __syncthreads();
    if (lane == 0)  // one copy per row, issued by every warp
      for (int l = warp; l < n_l; l += kWarps)
        bulk_load(kst + (size_t)l * stride, kchunk + (size_t)l * U, row, bar);
  } else if (pl.staged) {
    for (int i = tid; i < n_l * U; i += kThreads)
      kst[(size_t)(i / U) * stride + i % U] = kchunk[i];
  }
  for (int i = tid; i < U; i += kThreads) {
    par_s[i] = __ldg(g + i) * kTwoLog2e;
    par_s[U + i] = __ldg(beta + i) * kTwoLog2e;
    par_s[2 * U + i] = __ldg(v + i);
  }
  for (int i = tid; i < K * U; i += kThreads)
    q_s[i] = round_to<T>(__ldg(q_g + i));
  if (CLOSED_FORM)
    for (int l = tid; l < n_l; l += kThreads)
      kmom[l] = make_float2(__ldg(key_mean + l0 + l), __ldg(key_m2 + l0 + l));
  __syncthreads();
  if (CLOSED_FORM) {
    for (int k = warp; k < K; k += kWarps) {
      float s = 0.f, s2 = 0.f;
      for (int u = lane; u < U; u += kWarp) {
        const float x = q_s[k * U + u];
        s += x;
        s2 += x * x;
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      if (lane == 0) {
        qstat[2 * k] = s / U;
        qstat[2 * k + 1] = s2 / U;
      }
    }
    __syncthreads();
  }

  if (pl.bulk) mbar_wait(bar, 0);

  ADDLN_PHASE(1);
  // 2. LayerNorm statistics of every (query, position), from per-head sums
  // (held in `score` until the scores overwrite them) added in head order:
  // K1 in closed form from the key moments and the cross term, K2 in two
  // passes, the mean and then the squared deviations.
  head_sums<T, VEC, CLOSED_FORM ? kCross : kSum>(kb, stride, q_s, stat, score,
                                                 K, n_l, chunk, U, H);
  __syncthreads();
  for (int t = tid; t < K * n_l; t += kThreads) {
    const int k = t / n_l, l = t - k * n_l;
    const float sum = heads_total(score, k, l, H, chunk);
    if (CLOSED_FORM) {
      const float m = kmom[l].x + qstat[2 * k];
      const float ex2 = kmom[l].y + 2.f * sum / U + qstat[2 * k + 1];
      stat[k * chunk + l] =
          make_float2(m, rsqrtf(fmaxf(ex2 - m * m, 0.f) + kLnEps));
    } else {
      stat[k * chunk + l].x = sum / U;
    }
  }
  __syncthreads();
  if (!CLOSED_FORM) {
    head_sums<T, VEC, kSquare>(kb, stride, q_s, stat, score, K, n_l, chunk, U,
                               H);
    __syncthreads();
    for (int t = tid; t < K * n_l; t += kThreads) {
      const int k = t / n_l, l = t - k * n_l;
      stat[k * chunk + l].y =
          rsqrtf(heads_total(score, k, l, H, chunk) / U + kLnEps);
    }
    __syncthreads();
  }

  ADDLN_PHASE(2);
  // 3. Scores.
  score_tasks<T, VEC>(kb, stride, q_s, par_s, stat, score, inv_temp, K, n_l,
                      chunk, U, H);
  __syncthreads();

  ADDLN_PHASE(3);
  // 4. Softmax over L across the cluster: this block's max and sum of
  // exponentials per (query, head) row, pushed to every block ...
  cluster_wait();  // barrier 0
  for (int row = warp; row < KH; row += kWarps) {
    const float* r = score + (size_t)row * chunk;
    float m = -INFINITY;
    for (int l = lane; l < n_l; l += kWarp) m = fmaxf(m, r[l]);
    m = warp_max(m);
    float z = 0.f;
    for (int l = lane; l < n_l; l += kWarp) z += expf(r[l] - m);
    z = warp_sum(z);
    if (lane < S) {
      float* dst = cluster.map_shared_rank(rstat, lane) + 2 * (rank * KH + row);
      dst[0] = m;
      dst[1] = z;
    }
  }
  cluster_arrive();
  cluster_wait();  // barrier 1: every block's statistics are here
  ADDLN_PHASE(4);
  // ... combined over the S blocks in rank order ...
  for (int row = tid; row < KH; row += kThreads) {
    float m = -INFINITY;
    for (int r = 0; r < S; ++r) m = fmaxf(m, rstat[2 * (r * KH + row)]);
    float z = 0.f;
    for (int r = 0; r < S; ++r) {
      const float* st = rstat + 2 * (r * KH + row);
      if (st[1] > 0.f) z += st[1] * expf(st[0] - m);
    }
    gstat[2 * row] = m;
    gstat[2 * row + 1] = 1.f / z;
  }
  __syncthreads();
  // ... and this block's alignments normalised and written; the context
  // takes them rounded to the keys' dtype.
  for (int i = tid; i < KH * n_l; i += kThreads) {
    const int row = i / n_l, l = i % n_l;
    float* a = score + (size_t)row * chunk + l;
    const float w = expf(*a - gstat[2 * row]) * gstat[2 * row + 1];
    align[(size_t)row * L + l0 + l] = w;
    *a = round_to<T>(w);
  }
  __syncthreads();

  ADDLN_PHASE(5);
  // 5. Context: this block's partial over its chunk, from the staged keys,
  // a thread per (vector, group of positions) for up to kQueryBlock queries
  // at a time, so that each key read serves them all ...
  constexpr int KQ = CLOSED_FORM ? kQueryBlock : 1;
  const int G = ctx_groups(K, U, VEC);
  float* cpart = reinterpret_cast<float*>(smem + pl.off_cpart);
  for (int i = tid; i < G * nvec; i += kThreads) {
    const int grp = i / nvec, vi = i % nvec;
    const int la = grp * n_l / G, lb = (grp + 1) * n_l / G;
    for (int k0 = 0; k0 < K; k0 += KQ) {
      const float* a = score + (size_t)(k0 * H + vi / seg) * chunk;
      float acc[KQ][VEC];
#pragma unroll
      for (int j = 0; j < KQ; ++j)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[j][c] = 0.f;
#pragma unroll 2
      for (int l = la; l < lb; ++l) {
        float kv[VEC];
        load_keys<T, VEC>(kb + (size_t)l * stride + vi * VEC, kv);
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          if (k0 + j < K) {
            const float w = a[(size_t)j * H * chunk + l];
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[j][c] += w * kv[c];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KQ; ++j)
        if (k0 + j < K)
          store_chan<VEC>(cpart + (size_t)grp * N + (k0 + j) * U + vi * VEC,
                          acc[j]);
    }
  }
  __syncthreads();
  ADDLN_PHASE(6);
  // ... summed over the groups in order and pushed to the block that sums
  // each output over the cluster (block r: outputs [r*N/S, (r+1)*N/S)) ...
  for (int o = tid; o < N; o += kThreads) {
    float s = 0.f;
    for (int grp = 0; grp < G; ++grp) s += cpart[(size_t)grp * N + o];
    const int owner = ((o + 1) * S - 1) / N;
    cluster.map_shared_rank(rctx, owner)[rank * slice + o - owner * N / S] = s;
  }
  cluster_arrive();
  cluster_wait();  // barrier 2: every partial of this block's share is here
  ADDLN_PHASE(7);
  // ... and summed in rank order. No block reads another's shared memory
  // after barrier 2, so each may leave when done.
  const int o0 = rank * N / S, n_mine = (rank + 1) * N / S - o0;
  for (int i = tid; i < n_mine; i += kThreads) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += rctx[r * slice + i];
    ctx[o0 + i] = s;
  }
  ADDLN_PHASE(8);
}

}  // namespace addln

#ifdef ADDLN_PHASES
// Copies the first `blocks` rows of the phase table (`marks` u64 a row) to
// `out`; refuses a shape the table does not have.
extern "C" int addln_read_phases(void* out, int blocks, int marks) {
  if (marks != addln::kPhaseMarks || blocks < 0 ||
      blocks > addln::kPhaseBlocks)
    return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(
      out, addln::addln_phase_ns,
      sizeof(unsigned long long) * addln::kPhaseMarks * blocks);
}
#endif
