// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel dlti_tpu/ops/pallas/paged_attention.py:_decode_kernel
// (launched by paged_decode_attention, pl.pallas_call at :193), both of its
// programs: float pools, and int8 pools (quantized=True) whose every
// (token, kv head) row carries a float32 scale. One-token attention of every
// sequence's query over its K/V rows, read in place from the paged pool
// through the block table.
//
// What bounds it: HBM bytes. Each sequence reads the K and V rows of its live
// tokens once (plus their two float32 scales on an int8 pool), q and the
// output; per token and head that is 2*d loads against 4*d flops, far below
// the card's ~295 flop/byte bf16 ridge.
//
// Design (the simple, correct first version):
// * One thread block per (batch row, kv head). The TPU grid's carried
//   scratch (m, l, acc across the sequential block axis) becomes a loop
//   inside the block over the sequence's live tokens, TILE tokens at a time.
// * The block loads its head group's hpg query vectors once (pre-scaled,
//   fp32, shared memory), then for each tile reads every K and V row of
//   that kv head exactly once, with 16-byte loads, and shares it across the
//   whole GQA group: K/V bytes move once per kv head, never once per query
//   head.
// * int8 pools: each row is dequantized at load, into the same fp32 shared
//   tile, as int8 * its row scale. The TPU kernel folds the scales into the
//   math instead (s *= k_scale after q.k, p *= v_scale before p.v, l summing
//   the unscaled p); both compute softmax(q.(k*ks)) . (v*vs), and
//   dequantizing at load keeps one score/softmax/PV path for every pool
//   type. No dequantized row goes back to device memory.
// * The physical block of token t is block_tables[b, t / block_size],
//   clamped to the pool like the reference's index map. Only tokens in
//   [max(0, seq_len - window), seq_len) are visited, so blocks past seq_len,
//   blocks wholly outside the window, garbage table entries there, and the
//   scales of rows never written are never read; the ragged tail is cut by
//   position.
// * Online softmax with m, l and acc in fp32; output in q's dtype.
//   seq_len == 0 visits nothing and writes zeros.
//
// Later work (not here): TMA/cp.async double buffering, split-K over long
// sequences to fill 132 SMs at small batch, dp4a / int8 mma on int8 pools.
//
// Built by dlti_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens per tile: one lane per token in softmax

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q,             // (B, H, D)
                    const TKV* __restrict__ k_pool,       // (NB, BS, KVH, D)
                    const TKV* __restrict__ v_pool,       // (NB, BS, KVH, D)
                    const float* __restrict__ k_scale,    // (NB, BS, KVH), int8 pools
                    const float* __restrict__ v_scale,    // (NB, BS, KVH), int8 pools
                    const int32_t* __restrict__ block_tables,  // (B, MB)
                    const int32_t* __restrict__ seq_lens,      // (B,)
                    TQ* __restrict__ out,                 // (B, H, D)
                    int num_blocks, int block_size, int kv_heads, int hpg,
                    int max_blocks, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // hpg * D, pre-scaled
  float* acc_s = q_s + hpg * D;       // hpg * D
  float* k_s = acc_s + hpg * D;       // kTile * D
  float* v_s = k_s + kTile * D;       // kTile * D
  float* p_s = v_s + kTile * D;       // hpg * kTile: scores, then probs
  float* m_s = p_s + hpg * kTile;     // hpg running max
  float* l_s = m_s + hpg;             // hpg running sum
  float* alpha_s = l_s + hpg;         // hpg rescale of this tile

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_heads = kv_heads * hpg;
  const int seq_len = seq_lens[b];
  const int start = window > 0 ? max(0, seq_len - window) : 0;
  // The table holds max_blocks logical blocks; like the reference's grid,
  // nothing past them is visited.
  const int end = min(seq_len, max_blocks * block_size);

  const size_t head_off = ((size_t)b * num_heads + (size_t)g * hpg) * D;
  for (int e = tid; e < hpg * D; e += kThreads) {
    q_s[e] = to_float(q[head_off + e]) * scale;
    acc_s[e] = 0.f;
  }
  for (int h = tid; h < hpg; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  __syncthreads();

  const int32_t* bt = block_tables + (size_t)b * max_blocks;
  constexpr int kVec = 16 / sizeof(TKV);            // elements per 16-byte load
  constexpr int kChunks = D / kVec;                 // 16-byte loads per token
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);

    // K/V rows of tokens t0 .. t0+n-1 for kv head g, into shared memory.
    for (int c = tid; c < n * kChunks; c += kThreads) {
      const int t = c / kChunks;
      const int off = (c - t * kChunks) * kVec;
      const int tok = t0 + t;
      int phys = bt[tok / block_size];
      phys = min(max(phys, 0), num_blocks - 1);
      const size_t row = ((size_t)phys * block_size + tok % block_size) * kv_heads + g;
      const size_t base = row * D + off;
      const uint4 kraw = *reinterpret_cast<const uint4*>(k_pool + base);
      const uint4 vraw = *reinterpret_cast<const uint4*>(v_pool + base);
      const TKV* kv = reinterpret_cast<const TKV*>(&kraw);
      const TKV* vv = reinterpret_cast<const TKV*>(&vraw);
      float ks = 1.f, vs = 1.f;
      if constexpr (kQuant) {  // this live row's scales, read with its payload
        ks = k_scale[row];
        vs = v_scale[row];
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[t * D + off + i] = kQuant ? to_float(kv[i]) * ks : to_float(kv[i]);
        v_s[t * D + off + i] = kQuant ? to_float(vv[i]) * vs : to_float(vv[i]);
      }
    }
    __syncthreads();

    // Scores: one warp per (head, token) pair, lanes split the head dim.
    for (int pair = warp; pair < hpg * kTile; pair += kWarps) {
      const int h = pair / kTile;
      const int t = pair - h * kTile;
      float s = -INFINITY;
      if (t < n) {  // warp-uniform
        float part = 0.f;
#pragma unroll
        for (int i = lane; i < D; i += 32) part += q_s[h * D + i] * k_s[t * D + i];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        s = part;
      }
      if (lane == 0) p_s[h * kTile + t] = s;
    }
    __syncthreads();

    // Online softmax: one warp per head, one lane per token of the tile.
    for (int h = warp; h < hpg; h += kWarps) {
      const float s = p_s[h * kTile + lane];
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mt);  // finite: the tile has n >= 1 tokens
      const float p = lane < n ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      p_s[h * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        alpha_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + ps;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ V, each thread owning hpg*D/kThreads outputs.
    for (int e = tid; e < hpg * D; e += kThreads) {
      const int h = e / D;
      const int c = e - h * D;
      const float* ph = p_s + h * kTile;
      float a = acc_s[e] * alpha_s[h];
      for (int t = 0; t < n; ++t) a += ph[t] * v_s[t * D + c];
      acc_s[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < hpg * D; e += kThreads) {
    const float l = l_s[e / D];
    store(out + head_off + e, l > 0.f ? acc_s[e] / l : 0.f);
  }
}

size_t smem_bytes(int hpg, int d) {
  return sizeof(float) * (2 * (size_t)hpg * d + 2 * (size_t)kTile * d
                          + (size_t)hpg * kTile + 3 * (size_t)hpg);
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* seq_lens, void* out,
                   int batch, int kv_heads, int hpg, int num_blocks,
                   int block_size, int max_blocks, int window, float scale,
                   cudaStream_t stream) {
  auto kernel = paged_decode_kernel<TQ, TKV, D>;
  const size_t smem = smem_bytes(hpg, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(seq_lens), static_cast<TQ*>(out), num_blocks,
      block_size, kv_heads, hpg, max_blocks, window, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int head_dim, const void* q, const void* k_pool,
                       const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* block_tables,
                       const void* seq_lens, void* out, int batch, int kv_heads,
                       int hpg, int num_blocks, int block_size, int max_blocks,
                       int window, float scale, cudaStream_t stream) {
#define DLTI_LAUNCH(D)                                                        \
  return launch<TQ, TKV, D>(q, k_pool, v_pool, k_scale, v_scale,             \
                            block_tables, seq_lens, out,                      \
                            batch, kv_heads, hpg, num_blocks, block_size,     \
                            max_blocks, window, scale, stream)
  switch (head_dim) {
    case 16: DLTI_LAUNCH(16);
    case 32: DLTI_LAUNCH(32);
    case 64: DLTI_LAUNCH(64);
    case 128: DLTI_LAUNCH(128);
    case 256: DLTI_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef DLTI_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; k_scale and
// v_scale must then point at the (NB, BS, KVH) float32 scales, and are
// ignored, null, for float pools).
extern "C" int dlti_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* out, int batch,
    int num_heads, int kv_heads, int head_dim, int num_blocks, int block_size,
    int max_blocks, int window, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (batch <= 0 || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      num_blocks <= 0 || block_size <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int hpg = num_heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DLTI_ARGS                                                              \
  head_dim, q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens, out,  \
      batch, kv_heads, hpg, num_blocks, block_size, max_blocks, window, scale, s
  if (q_dtype == 0 && kv_dtype == 0) return (int)dispatch_d<float, float>(DLTI_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return (int)dispatch_d<float, __nv_bfloat16>(DLTI_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return (int)dispatch_d<__nv_bfloat16, float>(DLTI_ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16>(DLTI_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return (int)dispatch_d<float, int8_t>(DLTI_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return (int)dispatch_d<__nv_bfloat16, int8_t>(DLTI_ARGS);
#undef DLTI_ARGS
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the kernel asks for; the wrapper checks it
// against the card's limit before launching.
extern "C" long long dlti_paged_decode_smem_bytes(int hpg, int head_dim) {
  return (long long)smem_bytes(hpg, head_dim);
}

extern "C" const char* dlti_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
