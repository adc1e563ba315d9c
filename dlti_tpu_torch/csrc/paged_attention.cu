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
// the tensor cores' ~295 flop/byte bf16 ridge. Under GQA each K/V element
// feeds every query head of its group, so the float32 multiply-adds on the
// CUDA cores come near their own rate (4 heads: ~100 of the SM's 128 FMA a
// clock at the HBM rate); they stay there, in float32, in this version.
//
// Design: split-K over the live tokens, fed by asynchronous copies.
// * Grid (kv head x head group, batch row, split). A split owns the token
//   range [split * chunk, (split + 1) * chunk) cut to the live window
//   [max(0, seq_len - window), min(seq_len, max_blocks * block_size)). The
//   host picks `splits` and `chunk` from static shapes only (the table's
//   length, batch x kv heads, the SM count), never from seq_lens, so a
//   launch needs no device read and the shape of the grid is fixed per
//   engine. A split with no live token writes an empty record.
// * A head group is up to kMaxHeads query heads of one kv head; they share
//   every K/V row the block reads (GQA), so K/V bytes move once per kv head.
// * Tiles of kTile tokens go through a ring of 2 or 3 stages in shared
//   memory by cp.async: 16-byte copies in the pool's own type (bf16, f16,
//   float32 or int8 bytes; an int8 pool's row scales by 4-byte copies), tile i + S - 1
//   in flight while tile i computes, one __syncthreads a tile. Rows past the
//   split's last live token are zero-filled without reading device memory,
//   so no stale row, garbage table entry or NaN scale of a dead row is read.
// * Each warp owns kTile / 4 tokens of every tile and keeps its own online
//   softmax (m, l and acc for the group's heads, in log2 units), so the
//   score, softmax and p.v steps need no barrier between warps. q.k: lanes
//   take consecutive 16-byte chunks of a row and reduce by shuffles; p.v:
//   lanes own channels. Values are converted, and on an int8 pool scaled
//   (k scale on the score, v scale on p; l sums the unscaled p, as the TPU
//   kernel folds them), in registers at use. The four warps merge once per
//   split through shared memory.
// * Each block writes (m, l, acc) in float32 to the workspace, one split
//   or many, and a second kernel, paged_decode_combine_kernel, merges each
//   (row, head)'s splits: o = sum e^(m_s - m*) acc_s / sum e^(m_s - m*) l_s,
//   zeros where every split is empty (seq_len 0). One output path for every
//   plan, at the cost of one short launch.
//
// Later work (not here): tensor-core mma over GQA groups, int8 mma on K4q's
// payloads, TMA for whole blocks of the table.
//
// Built by dlti_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // tokens per ring stage
constexpr int kWarpTokens = kTile / kWarps;  // tokens of a tile each warp owns
constexpr int kMaxHeads = 8;                 // query heads a block serves
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
// int8 -> float by the float's bits, not by I2F (16 a clock per SM on
// Hopper): 0x4B400000 + x is the float 1.5 * 2^23 + x for |x| < 2^22.
__device__ __forceinline__ float to_float(int8_t x) {
  return __int_as_float(0x4B400000 + (int)x) - 12582912.f;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only), 3 = float16.
constexpr int kF32 = 0, kBF16 = 1, kInt8 = 2, kF16 = 3;

// q is read once a block and the output written once by the combine, so
// their dtype (kF32, kBF16 or kF16, whatever the pool's) is a runtime code,
// not a template parameter: a third of the programs to build.
__device__ __forceinline__ float load_q(const void* q, size_t i, int dtype) {
  if (dtype == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  if (dtype == kF16) return __half2float(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}
__device__ __forceinline__ void store_q(void* out, size_t i, float x, int dtype) {
  if (dtype == kBF16) store(static_cast<__nv_bfloat16*>(out) + i, x);
  else if (dtype == kF16) store(static_cast<__half*>(out) + i, x);
  else store(static_cast<float*>(out) + i, x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronously; with !valid nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shapes of the work for a pool type and head_dim.
template <typename TKV, int D>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(TKV);            // elements per 16-byte chunk
  static constexpr int kF4 = kVec / 4;                      // q's float4s per chunk
  static constexpr int kChunks = D / kVec;                 // chunks per row
  static constexpr int kLpt = kChunks < 32 ? kChunks : 32; // lanes per token in q.k
  static constexpr int kCpl = kChunks / kLpt;              // chunks per lane in q.k
  static constexpr int kTpp = 32 / kLpt;                   // tokens per warp pass in q.k
  static constexpr int kPasses = kTpp >= kWarpTokens ? 1 : kWarpTokens / kTpp;
  static constexpr int kDl = D < 32 ? D : 32;              // lanes per channel set in p.v
  static constexpr int kCh = D / kDl;                      // channels per lane in p.v
  static constexpr int kTsub = 32 / kDl;                   // token slots in p.v
  static constexpr int kRowBytes = D * (int)sizeof(TKV);
  // K tile, V tile, then the two scale rows (used by int8 pools only).
  static constexpr int kStageBytes = 2 * kTile * kRowBytes + 2 * kTile * 4;
  static constexpr int kStages = kStageBytes <= 32 * 1024 + 256 ? 3 : 2;
  // Slot of q's float4 e4 of chunk c in shared memory, rotated per chunk so
  // that eight lanes on eight chunks read eight different bank groups.
  __device__ static __forceinline__ int q_slot(int c, int e4) {
    return (e4 + c * kF4 / 8) % kF4;
  }
};

// The ring, which the four warps' merge reuses after the last tile.
template <typename TKV, int D, int HMAX>
__host__ __device__ constexpr size_t ring_bytes() {
  using G = Geometry<TKV, D>;
  const size_t ring = (size_t)G::kStages * G::kStageBytes;
  const size_t merge = sizeof(float) * kWarps * HMAX * D;
  return ring > merge ? ring : merge;
}

template <typename TKV, int D, int HMAX>
constexpr size_t smem_bytes_for() {
  return ring_bytes<TKV, D, HMAX>()
         + sizeof(float) * ((size_t)HMAX * D                  // q, pre-scaled
                            + (size_t)kWarps * HMAX * kWarpTokens  // scores, then p
                            + 3 * (size_t)kWarps * HMAX);         // m, l, alpha
}

template <typename TKV, int D, int HMAX>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const void* __restrict__ q,           // (B, H, D)
                    const TKV* __restrict__ k_pool,       // (NB, BS, KVH, D)
                    const TKV* __restrict__ v_pool,       // (NB, BS, KVH, D)
                    const float* __restrict__ k_scale,    // (NB, BS, KVH), int8 pools
                    const float* __restrict__ v_scale,    // (NB, BS, KVH), int8 pools
                    const int32_t* __restrict__ block_tables,  // (B, MB)
                    const int32_t* __restrict__ seq_lens,      // (B,)
                    float* __restrict__ ws_ml,            // (B, H, splits, 2)
                    float* __restrict__ ws_acc,           // (B, H, splits, D)
                    int num_blocks, int block_size, int kv_heads, int hpg,
                    int head_groups, int max_blocks, int window, int chunk,
                    float scale, int q_dtype) {
  using G = Geometry<TKV, D>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes<TKV, D, HMAX>());
  float* ps = q_s + HMAX * D;                  // [warp][head][token]
  float* m_w = ps + kWarps * HMAX * kWarpTokens;  // [warp][head]
  float* l_w = m_w + kWarps * HMAX;
  float* alpha_w = l_w + kWarps * HMAX;

  const int g = blockIdx.x / head_groups;
  const int h0 = (blockIdx.x - g * head_groups) * kMaxHeads;
  const int nh = min(HMAX, hpg - h0);
  const int b = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int num_heads = kv_heads * hpg;

  const int seq_len = seq_lens[b];
  const int start = window > 0 ? max(0, seq_len - window) : 0;
  // The table holds max_blocks logical blocks; like the reference's grid,
  // nothing past them is visited.
  const int end = min(seq_len, max_blocks * block_size);
  const int lo = max(start, split * chunk);
  const int hi = min(end, split * chunk + chunk);
  const int ntiles = lo < hi ? (hi - lo + kTile - 1) / kTile : 0;

  const size_t head_off = ((size_t)b * num_heads + (size_t)g * hpg + h0) * D;
  if (ntiles > 0)
    for (int e = tid; e < HMAX * D; e += kThreads) {
      const int c = (e % D) / G::kVec, e4 = (e % G::kVec) / 4;
      q_s[e - e % G::kVec + G::q_slot(c, e4) * 4 + e % 4] =
          e < nh * D ? load_q(q, head_off + e, q_dtype) * (scale * kLog2e) : 0.f;
    }
  for (int e = tid; e < kWarps * HMAX; e += kThreads) {
    m_w[e] = -INFINITY;
    l_w[e] = 0.f;
    alpha_w[e] = 1.f;
  }

  const int32_t* bt = block_tables + (size_t)b * max_blocks;
  auto stage_k = [&](int st) { return reinterpret_cast<TKV*>(ring + st * G::kStageBytes); };
  auto stage_v = [&](int st) { return stage_k(st) + kTile * D; };
  auto stage_ks = [&](int st) { return reinterpret_cast<float*>(stage_v(st) + kTile * D); };
  auto stage_vs = [&](int st) { return stage_ks(st) + kTile; };

  // Tokens t0 .. t0 + kTile - 1 into stage st; rows at or past hi zero-filled.
  auto prefetch = [&](int t0, int st) {
    TKV* ks = stage_k(st);
    TKV* vs = stage_v(st);
    for (int e = tid; e < kTile * G::kChunks; e += kThreads) {
      const int r = e / G::kChunks, c = e - r * G::kChunks;
      const int tok = t0 + r;
      const bool ok = tok < hi;
      size_t off = 0;
      if (ok) {
        const int phys = min(max(bt[tok / block_size], 0), num_blocks - 1);
        off = (((size_t)phys * block_size + tok % block_size) * kv_heads + g) * D
              + c * G::kVec;
      }
      cp_async16(ks + r * D + c * G::kVec, k_pool + off, ok);
      cp_async16(vs + r * D + c * G::kVec, v_pool + off, ok);
    }
    if constexpr (kQuant) {
      if (tid < kTile) {
        const int tok = t0 + tid;
        const bool ok = tok < hi;
        size_t row = 0;
        if (ok) {
          const int phys = min(max(bt[tok / block_size], 0), num_blocks - 1);
          row = ((size_t)phys * block_size + tok % block_size) * kv_heads + g;
        }
        cp_async4(stage_ks(st) + tid, k_scale + row, ok);
        cp_async4(stage_vs(st) + tid, v_scale + row, ok);
      }
    }
  };

  float acc[HMAX][G::kCh];
#pragma unroll
  for (int h = 0; h < HMAX; ++h)
#pragma unroll
    for (int j = 0; j < G::kCh; ++j) acc[h][j] = 0.f;

  float* ps_w = ps + warp * HMAX * kWarpTokens;
  float* mw = m_w + warp * HMAX;
  float* lw = l_w + warp * HMAX;
  float* aw = alpha_w + warp * HMAX;

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < ntiles) prefetch(lo + s * kTile, s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<G::kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and every warp is done with tile i - 1
    {
      const int nx = i + G::kStages - 1;
      if (nx < ntiles) prefetch(lo + nx * kTile, nx % G::kStages);
      cp_async_commit();
    }
    const int st = i % G::kStages;
    const int n = min(kTile, hi - (lo + i * kTile));
    const int nw = min(max(n - warp * kWarpTokens, 0), kWarpTokens);  // warp-uniform
    if (nw == 0) continue;
    const TKV* ks = stage_k(st) + warp * kWarpTokens * D;
    const TKV* vs = stage_v(st) + warp * kWarpTokens * D;
    const float* kss = stage_ks(st) + warp * kWarpTokens;
    const float* vss = stage_vs(st) + warp * kWarpTokens;

    // Scores of this warp's tokens: lanes on consecutive chunks of a row.
#pragma unroll
    for (int pass = 0; pass < G::kPasses; ++pass) {
      const int tl = pass * G::kTpp + lane / G::kLpt;
      const int tr = min(tl, kWarpTokens - 1);
      const int c0 = lane % G::kLpt;
      float dot[HMAX];
#pragma unroll
      for (int h = 0; h < HMAX; ++h) dot[h] = 0.f;
#pragma unroll
      for (int j = 0; j < G::kCpl; ++j) {
        const int c = c0 + j * G::kLpt;
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + tr * D + c * G::kVec);
        const TKV* kv = reinterpret_cast<const TKV*>(&raw);
        float kf[G::kVec];
#pragma unroll
        for (int e = 0; e < G::kVec; ++e) kf[e] = to_float(kv[e]);
#pragma unroll
        for (int h = 0; h < HMAX; ++h) {
          const float4* qv = reinterpret_cast<const float4*>(q_s + h * D + c * G::kVec);
#pragma unroll
          for (int e4 = 0; e4 < G::kF4; ++e4) {
            const float4 x = qv[G::q_slot(c, e4)];
            dot[h] = fmaf(x.x, kf[4 * e4], dot[h]);
            dot[h] = fmaf(x.y, kf[4 * e4 + 1], dot[h]);
            dot[h] = fmaf(x.z, kf[4 * e4 + 2], dot[h]);
            dot[h] = fmaf(x.w, kf[4 * e4 + 3], dot[h]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HMAX; ++h)
#pragma unroll
        for (int o = G::kLpt / 2; o > 0; o >>= 1)
          dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], o);
      if (c0 == 0 && tl < kWarpTokens) {
        const float ksc = kQuant ? kss[tl] : 1.f;
#pragma unroll
        for (int h = 0; h < HMAX; ++h) ps_w[h * kWarpTokens + tl] = dot[h] * ksc;
      }
    }
    __syncwarp();

    // Online softmax of the warp's tokens: lane (head, token), 8 lanes a head.
#pragma unroll
    for (int base = 0; base < HMAX * kWarpTokens; base += 32) {
      const int idx = base + lane, h = idx / kWarpTokens, t = idx % kWarpTokens;
      const bool on = h < HMAX;
      const float s = on && t < nw ? ps_w[idx] : -INFINITY;
      float mt = s;
#pragma unroll
      for (int o = kWarpTokens / 2; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = on ? mw[h] : -INFINITY;
      const float m_new = fmaxf(m_old, mt);  // finite where on: t = 0 is live
      const float p = s == -INFINITY ? 0.f : exp2f(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = kWarpTokens / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (on) {
        ps_w[idx] = kQuant && t < nw ? p * vss[t] : p;
        if (t == 0) {
          const float alpha = exp2f(m_old - m_new);  // 0 on the warp's first tile
          aw[h] = alpha;
          lw[h] = lw[h] * alpha + sum;
          mw[h] = m_new;
        }
      }
    }
    __syncwarp();

    // acc = alpha * acc + p @ V: lanes own channels, token slots split tokens.
    const int cl = lane % G::kDl, u = lane / G::kDl;
#pragma unroll
    for (int h = 0; h < HMAX; ++h) {
      const float a = aw[h];
#pragma unroll
      for (int j = 0; j < G::kCh; ++j) acc[h][j] *= a;
    }
    for (int t = u; t < nw; t += G::kTsub) {
      float vf[G::kCh];
#pragma unroll
      for (int j = 0; j < G::kCh; ++j) vf[j] = to_float(vs[t * D + cl + G::kDl * j]);
#pragma unroll
      for (int h = 0; h < HMAX; ++h) {
        const float p = ps_w[h * kWarpTokens + t];
#pragma unroll
        for (int j = 0; j < G::kCh; ++j) acc[h][j] = fmaf(p, vf[j], acc[h][j]);
      }
    }
  }
  cp_async_wait<0>();

  // Merge the token slots of each warp, then the four warps.
#pragma unroll
  for (int o = G::kDl; o < 32; o <<= 1)
#pragma unroll
    for (int h = 0; h < HMAX; ++h)
#pragma unroll
      for (int j = 0; j < G::kCh; ++j) acc[h][j] += __shfl_xor_sync(0xffffffffu, acc[h][j], o);
  __syncthreads();  // the ring is free; m, l of every warp are visible
  float* mg = reinterpret_cast<float*>(ring);  // [warp][head][D]
  if (lane < G::kDl)
#pragma unroll
    for (int h = 0; h < HMAX; ++h)
#pragma unroll
      for (int j = 0; j < G::kCh; ++j)
        mg[(warp * HMAX + h) * D + lane + G::kDl * j] = acc[h][j];
  __syncthreads();
  for (int e = tid; e < nh * D; e += kThreads) {
    const int h = e / D, c = e - h * D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_w[w * HMAX + h]);
    float l = 0.f, o = 0.f;
    if (m != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(m_w[w * HMAX + h] - m);  // 0 for a warp with no token
        l = fmaf(f, l_w[w * HMAX + h], l);
        o = fmaf(f, mg[(w * HMAX + h) * D + c], o);
      }
    }
    const size_t rec = ((size_t)b * num_heads + (size_t)g * hpg + h0 + h) * splits + split;
    ws_acc[rec * D + c] = o;
    if (c == 0) {
      ws_ml[2 * rec] = m;
      ws_ml[2 * rec + 1] = l;
    }
  }
}

// One block per (head, batch row): o = sum_s e^(m_s - m*) acc_s / sum_s
// e^(m_s - m*) l_s over the splits with l_s > 0; zeros if there is none.
__global__ void paged_decode_combine_kernel(const float* __restrict__ ws_ml,
                                            const float* __restrict__ ws_acc,
                                            void* __restrict__ out, int splits, int d,
                                            int q_dtype) {
  const int h = blockIdx.x, b = blockIdx.y, heads = gridDim.x;
  const size_t rec0 = ((size_t)b * heads + h) * splits;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s)
    if (ws_ml[2 * (rec0 + s) + 1] > 0.f) m = fmaxf(m, ws_ml[2 * (rec0 + s)]);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float l = 0.f, o = 0.f;
    if (m != -INFINITY)
      for (int s = 0; s < splits; ++s) {
        const float ls = ws_ml[2 * (rec0 + s) + 1];
        if (ls > 0.f) {
          const float f = exp2f(ws_ml[2 * (rec0 + s)] - m);
          l = fmaf(f, ls, l);
          o = fmaf(f, ws_acc[(rec0 + s) * d + c], o);
        }
      }
    store_q(out, ((size_t)b * heads + h) * d + c, l > 0.f ? o / l : 0.f, q_dtype);
  }
}

// Query heads per block: the next power of two of the group, at most 8.
int heads_per_block(int hpg) {
  return hpg <= 1 ? 1 : hpg <= 2 ? 2 : hpg <= 4 ? 4 : kMaxHeads;
}

template <typename TKV>
size_t smem_bytes_d(int hmax, int d) {
#define DLTI_SMEM(D)                                            \
  switch (hmax) {                                               \
    case 1: return smem_bytes_for<TKV, D, 1>();                 \
    case 2: return smem_bytes_for<TKV, D, 2>();                 \
    case 4: return smem_bytes_for<TKV, D, 4>();                 \
    default: return smem_bytes_for<TKV, D, kMaxHeads>();        \
  }
  switch (d) {
    case 16: DLTI_SMEM(16);
    case 32: DLTI_SMEM(32);
    case 64: DLTI_SMEM(64);
    case 128: DLTI_SMEM(128);
    case 256: DLTI_SMEM(256);
    default: return 0;
  }
#undef DLTI_SMEM
}

size_t smem_bytes(int hpg, int d, int kv_dtype) {
  const int hmax = heads_per_block(hpg);
  if (kv_dtype == kF32) return smem_bytes_d<float>(hmax, d);
  if (kv_dtype == kBF16) return smem_bytes_d<__nv_bfloat16>(hmax, d);
  if (kv_dtype == kInt8) return smem_bytes_d<int8_t>(hmax, d);
  if (kv_dtype == kF16) return smem_bytes_d<__half>(hmax, d);
  return 0;
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *block_tables, *seq_lens;
  void *out, *ws_ml, *ws_acc;
  int batch, kv_heads, hpg, num_blocks, block_size, max_blocks, window, splits, chunk;
  float scale;
  int q_dtype;
  cudaStream_t stream;
};

template <typename TKV, int D, int HMAX>
cudaError_t launch(const Args& a) {
  auto kernel = paged_decode_kernel<TKV, D, HMAX>;
  constexpr size_t smem = smem_bytes_for<TKV, D, HMAX>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int head_groups = (a.hpg + kMaxHeads - 1) / kMaxHeads;
  dim3 grid(a.kv_heads * head_groups, a.batch, a.splits);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int32_t*>(a.block_tables),
      static_cast<const int32_t*>(a.seq_lens), static_cast<float*>(a.ws_ml), static_cast<float*>(a.ws_acc), a.num_blocks,
      a.block_size, a.kv_heads, a.hpg, head_groups, a.max_blocks, a.window, a.chunk,
      a.scale, a.q_dtype);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 cgrid(a.kv_heads * a.hpg, a.batch);
  paged_decode_combine_kernel<<<cgrid, D, 0, a.stream>>>(
      static_cast<const float*>(a.ws_ml), static_cast<const float*>(a.ws_acc), a.out,
      a.splits, D, a.q_dtype);
  return cudaGetLastError();
}

template <typename TKV, int D>
cudaError_t dispatch_h(const Args& a) {
  switch (heads_per_block(a.hpg)) {
    case 1: return launch<TKV, D, 1>(a);
    case 2: return launch<TKV, D, 2>(a);
    case 4: return launch<TKV, D, 4>(a);
    default: return launch<TKV, D, kMaxHeads>(a);
  }
}

template <typename TKV>
cudaError_t dispatch_d(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: return dispatch_h<TKV, 16>(a);
    case 32: return dispatch_h<TKV, 32>(a);
    case 64: return dispatch_h<TKV, 64>(a);
    case 128: return dispatch_h<TKV, 128>(a);
    case 256: return dispatch_h<TKV, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pools only; k_scale and
// v_scale must then point at the (NB, BS, KVH) float32 scales, and are
// ignored, null, for float pools), 3 = float16. q takes 0, 1 or 3, and any
// of them with any pool. splits x chunk must cover the table's
// max_blocks x block_size tokens; ws_ml and ws_acc point at float32
// workspaces of batch x heads x splits x 2 and x head_dim.
extern "C" int dlti_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* seq_lens,
    void* out, void* ws_ml, void* ws_acc, int batch,
    int num_heads, int kv_heads, int head_dim, int num_blocks, int block_size,
    int max_blocks, int window, int splits, int chunk, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || num_heads % kv_heads != 0 ||
      num_blocks <= 0 || block_size <= 0 || max_blocks <= 0 || splits <= 0 ||
      splits > 65535 || chunk <= 0 ||
      (long long)splits * chunk < (long long)max_blocks * block_size)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == kInt8 && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (ws_ml == nullptr || ws_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  if (q_dtype != kF32 && q_dtype != kBF16 && q_dtype != kF16) return (int)cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens, out, ws_ml,
         ws_acc, batch, kv_heads, num_heads / kv_heads, num_blocks, block_size,
         max_blocks, window, splits, chunk, scale, q_dtype,
         static_cast<cudaStream_t>(stream)};
  if (kv_dtype == kF32) return (int)dispatch_d<float>(head_dim, a);
  if (kv_dtype == kBF16) return (int)dispatch_d<__nv_bfloat16>(head_dim, a);
  if (kv_dtype == kInt8) return (int)dispatch_d<int8_t>(head_dim, a);
  if (kv_dtype == kF16) return (int)dispatch_d<__half>(head_dim, a);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory the kernel asks for; the wrapper checks it
// against the card's limit before launching.
extern "C" long long dlti_paged_decode_smem_bytes(int hpg, int head_dim, int kv_dtype) {
  return (long long)smem_bytes(hpg, head_dim, kv_dtype);
}

// The split plan's constants, which the wrapper's split_plan mirrors: tokens
// per tile (a split's chunk is a multiple of it) and query heads per block.
extern "C" int dlti_paged_decode_tile_tokens() { return kTile; }
extern "C" int dlti_paged_decode_heads_per_block() { return kMaxHeads; }

// Stages of the cp.async ring for a pool type and head_dim (0 if not built).
extern "C" int dlti_paged_decode_stages(int head_dim, int kv_dtype) {
#define DLTI_STAGES(T)                                                   \
  switch (head_dim) {                                                    \
    case 16: return Geometry<T, 16>::kStages;                            \
    case 32: return Geometry<T, 32>::kStages;                            \
    case 64: return Geometry<T, 64>::kStages;                            \
    case 128: return Geometry<T, 128>::kStages;                          \
    case 256: return Geometry<T, 256>::kStages;                          \
    default: return 0;                                                   \
  }
  if (kv_dtype == kF32) DLTI_STAGES(float);
  if (kv_dtype == kBF16) DLTI_STAGES(__nv_bfloat16);
  if (kv_dtype == kInt8) DLTI_STAGES(int8_t);
  if (kv_dtype == kF16) DLTI_STAGES(__half);
#undef DLTI_STAGES
  return 0;
}

extern "C" const char* dlti_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
