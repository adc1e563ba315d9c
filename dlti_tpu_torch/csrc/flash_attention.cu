// Flash attention forward and backward for Hopper (sm_90a), hand-written
// CUDA C++. Three kernels:
//
//   flash_fwd_kernel      (K1) replaces dlti_tpu/ops/pallas/flash_attention.py
//                         _fwd_kernel (:132), launched by _flash_fwd (:270,
//                         pl.pallas_call :304): o = softmax(q k^T d^-1/2) v
//                         and the per-row logsumexp.
//   flash_bwd_dq_kernel   (K2) replaces _dq_kernel (:366), launched by
//                         _flash_bwd (:490, pl.pallas_call :527):
//                         dq = sum_j ds k with ds = p (dO v^T - D) d^-1/2.
//   flash_bwd_dkv_kernel  (K3) replaces _dkv_kernel (:424), launched by
//                         _flash_bwd (pl.pallas_call :560): dv = sum p^T dO,
//                         dk = sum ds^T q over every query head of the group.
//
// D = rowsum(dO * O) is computed by the caller in PyTorch, as the JAX
// package leaves it to XLA (:505).
//
// Layouts are the public function's own, read through strides, so nothing
// is transposed or repeated in device memory: q, o, dO, dq (b, sq, h, d);
// k, v, dk, dv (b, skv, h_kv, d); lse and D (b, h, sq) float32; segment ids
// (b, s) int32 (0 = padding). Query head kvh * group + g reads kv head kvh.
//
// Masking is the Pallas kernels': causal keeps kv <= q (top-left aligned),
// a window keeps kv > q - window (causal only), segments keep equal non-zero
// ids, and bounds keep q < sq, kv < skv. A row with nothing allowed gets
// o = 0 and lse = +1e30, so the backward's exp(s - lse) is 0 there.
//
// What bounds these kernels on this card: at training shapes (s = 512,
// d = 128) attention does 4 s d operations per (row, head) against 4 d bytes
// moved per row, so the work is operation-bound on paper (tensor cores, 989
// TFLOP/s bf16). This first version computes in float32 on the CUDA cores:
// every tile is converted to float32 in shared memory, as the Pallas kernels
// upcast tiles before each product (:171-173, :347-350), so no product is
// rounded to bf16 and p is never rounded before p v. Its ceiling is the
// float32 rate (67 TFLOP/s) and, below that, shared-memory bandwidth: each
// thread owns a 4 x (BK/16) block of scores and a 4 x (d/16) block of the
// output and reads its operands from shared memory for every product.
//
// Design:
// * One thread block of 256 threads per (batch * kv head, q tile) for K1 and
//   K2, per (batch * kv head, kv tile) for K3. A q tile holds kRows = 64 rows:
//   bq = 64 / group query positions for each of the group's query heads, so
//   the block reads each K/V tile once for the whole GQA group.
// * The TPU grid's sequential kv axis (m/l/acc carried in VMEM scratch)
//   becomes a loop inside the block; m, l and the accumulators are float32
//   registers. K3 owns its kv tile and loops over the q tiles and the group's
//   heads, so no two blocks write the same dk/dv row and no atomics are used.
// * The loops visit only the causal/window band: K1/K2 sweep kv in
//   [max(0, q0 - window + 1), min(skv, q_end)), K3 sweeps q in
//   [k0, min(sq, k_last + window)). With segment ids a tile whose id interval
//   is disjoint from the other side's is skipped before its K/V (or Q/dO)
//   are loaded, like _seg_run (:121).
// * Edges: rows past sq or skv are never read from device memory; their
//   shared-memory slots are filled with zeros and their scores masked, so a
//   ragged tail needs no padding of the inputs.
//
// Left on the table (later work): bf16 operands in the tensor cores (wgmma
// or mma.sync, with p rounded to bf16 before p v), TMA/cp.async double
// buffering of the K/V tiles, larger per-thread tiles with vector shared-
// memory loads, more than one block per SM, and a causal schedule that
// balances the triangle.
//
// Built by dlti_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kRows = 64;      // query rows (group x bq) per tile
constexpr float kMaskedLse = 1e30f;

struct FlashParams {
  int batch, sq, skv, heads, kv_heads, group, bq, rows;
  int causal, window, has_seg;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool allowed(const FlashParams& p, int qi, int kj,
                                        int qseg, int kseg) {
  if (qi >= p.sq || kj >= p.skv) return false;
  if (p.causal) {
    if (kj > qi) return false;
    if (p.window > 0 && kj <= qi - p.window) return false;
  }
  if (p.has_seg && (qseg != kseg || kseg == 0)) return false;
  return true;
}

// Rows [r0, r0 + n) of a (rows, D) tile whose row r starts at row_ptr(r)
// into shared memory with row stride D + 1, as float32; slots [n, slots) and
// rows whose pointer is null are zero. 16-byte loads from device memory.
template <typename T, int D, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int slots, RowPtr row_ptr) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < slots * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * kVec;
    float* out = dst + r * (D + 1) + c;
    const T* src = row_ptr(r);
    if (src == nullptr) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = 0.f;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) out[i] = to_float(v[i]);
    }
  }
}

// Query position of row slot r of the q tile starting at q0 (p.sq if the
// slot holds no valid row). Slot r belongs to head r / bq of the group.
__device__ __forceinline__ int slot_q(const FlashParams& p, int q0, int r) {
  if (r >= p.rows) return p.sq;
  const int qi = q0 + r % p.bq;
  return qi < p.sq ? qi : p.sq;
}

// Min and max segment id over seg[base + lo .. base + hi), reduced by the
// calling warp; every lane gets the result.
__device__ __forceinline__ void seg_range(const int32_t* seg, size_t base, int lo,
                                          int hi, int* mn_out, int* mx_out) {
  int mn = INT_MAX, mx = INT_MIN;
  const int lane = threadIdx.x & 31;
  for (int i = lo + lane; i < hi; i += 32) {
    const int s = seg[base + i];
    mn = min(mn, s);
    mx = max(mx, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  *mn_out = mn;
  *mx_out = mx;
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (D + 1) + 2 * (size_t)BK * (D + 1)
                          + (size_t)kRows * (BK + 1))
         + sizeof(int) * (2 * kRows + BK + 4);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ lse, FlashParams p) {
  constexpr int DS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int JT = BK / 16;  // score columns per thread
  constexpr int CT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * DS;
  float* vs = ks + BK * DS;
  float* ps = vs + BK * DS;
  int* row_q = reinterpret_cast<int*>(ps + kRows * PS);
  int* row_seg = row_q + kRows;
  int* kseg = row_seg + kRows;
  int* flag = kseg + BK;  // q-tile seg min, max; run flag

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  const int q0 = blockIdx.x * p.bq;
  const int q_end = min(q0 + p.bq, p.sq);

  if (tid < kRows) {
    const int qi = slot_q(p, q0, tid);
    row_q[tid] = qi;
    row_seg[tid] = (p.has_seg && qi < p.sq) ? seg[(size_t)b * p.sq + qi] : 0;
  }
  load_tile<T, D>(qs, kRows, [&](int r) -> const T* {
    const int qi = slot_q(p, q0, r);
    if (qi >= p.sq) return nullptr;
    return q + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
  });
  if (p.has_seg && tid < 32) {
    int mn, mx;
    seg_range(seg, (size_t)b * p.sq, q0, q_end, &mn, &mx);
    if (tid == 0) { flag[0] = mn; flag[1] = mx; }
  }
  __syncthreads();

  float m_i[4], l_i[4], acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
  }

  int k_lo = 0, k_hi = p.skv;
  if (p.causal) {
    k_hi = min(p.skv, q_end);
    if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int n = min(BK, p.skv - k0);
    if (p.has_seg) {
      if (tid < BK) kseg[tid] = tid < n ? seg[(size_t)b * p.skv + k0 + tid] : 0;
      __syncthreads();
      if (tid < 32) {
        int mn, mx;
        seg_range(seg, (size_t)b * p.skv, k0, k0 + n, &mn, &mx);
        if (tid == 0) flag[2] = flag[0] <= mx && flag[1] >= mn;
      }
      __syncthreads();
      if (!flag[2]) continue;  // uniform: every thread reads the same flag
    }
    auto kv_row = [&](const T* base) {
      return [&, base](int r) -> const T* {
        if (r >= n) return nullptr;
        return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
      };
    };
    load_tile<T, D>(ks, BK, kv_row(k));
    load_tile<T, D>(vs, BK, kv_row(v));
    __syncthreads();

    float s[4][JT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[JT];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < JT; ++j) kv[j] = ks[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = row_q[r];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const int jj = tx + 16 * j;
        const bool ok = jj < n && allowed(p, qi, k0 + jj, row_seg[r],
                                          p.has_seg ? kseg[jj] : 0);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], max16(mt));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[r * PS + tx + 16 * j] = pj;
        rs += pj;
      }
      alpha[i] = m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha[i] + sum16(rs);
      m_i[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[i][c] *= alpha[i];
    for (int j = 0; j < n; ++j) {
      float vv[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) vv[c] = vs[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pr = ps[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = row_q[r];
    if (qi >= p.sq) continue;
    const int head = kvh * p.group + r / p.bq;
    const float l = l_i[i];
    T* orow = o + (((size_t)b * p.sq + qi) * p.heads + head) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) store(orow + tx + 16 * c, l > 0.f ? acc[i][c] / l : 0.f);
    if (tx == 0)
      lse[((size_t)b * p.heads + head) * p.sq + qi] =
          l > 0.f ? m_i[i] + logf(l) : kMaskedLse;
  }
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kRows * (D + 1) + 2 * (size_t)BK * (D + 1)
                          + (size_t)kRows * (BK + 1) + 2 * kRows)
         + sizeof(int) * (2 * kRows + BK + 4);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int32_t* __restrict__ seg, T* __restrict__ dq,
                    FlashParams p) {
  constexpr int DS = D + 1;
  constexpr int PS = BK + 1;
  constexpr int JT = BK / 16;
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kRows * DS;
  float* ks = dos + kRows * DS;
  float* vs = ks + BK * DS;
  float* dss = vs + BK * DS;
  float* lse_s = dss + kRows * PS;
  float* delta_s = lse_s + kRows;
  int* row_q = reinterpret_cast<int*>(delta_s + kRows);
  int* row_seg = row_q + kRows;
  int* kseg = row_seg + kRows;
  int* flag = kseg + BK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  const int q0 = blockIdx.x * p.bq;
  const int q_end = min(q0 + p.bq, p.sq);

  if (tid < kRows) {
    const int qi = slot_q(p, q0, tid);
    row_q[tid] = qi;
    row_seg[tid] = (p.has_seg && qi < p.sq) ? seg[(size_t)b * p.sq + qi] : 0;
    float ls = kMaskedLse, dl = 0.f;
    if (qi < p.sq) {
      const size_t at = ((size_t)b * p.heads + kvh * p.group + tid / p.bq) * p.sq + qi;
      ls = lse[at];
      dl = delta[at];
    }
    lse_s[tid] = ls;
    delta_s[tid] = dl;
  }
  auto q_row = [&](const T* base) {
    return [&, base](int r) -> const T* {
      const int qi = slot_q(p, q0, r);
      if (qi >= p.sq) return nullptr;
      return base + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
    };
  };
  load_tile<T, D>(qs, kRows, q_row(q));
  load_tile<T, D>(dos, kRows, q_row(dout));
  if (p.has_seg && tid < 32) {
    int mn, mx;
    seg_range(seg, (size_t)b * p.sq, q0, q_end, &mn, &mx);
    if (tid == 0) { flag[0] = mn; flag[1] = mx; }
  }
  __syncthreads();

  float acc[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;

  int k_lo = 0, k_hi = p.skv;
  if (p.causal) {
    k_hi = min(p.skv, q_end);
    if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  }
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    const int n = min(BK, p.skv - k0);
    if (p.has_seg) {
      if (tid < BK) kseg[tid] = tid < n ? seg[(size_t)b * p.skv + k0 + tid] : 0;
      __syncthreads();
      if (tid < 32) {
        int mn, mx;
        seg_range(seg, (size_t)b * p.skv, k0, k0 + n, &mn, &mx);
        if (tid == 0) flag[2] = flag[0] <= mx && flag[1] >= mn;
      }
      __syncthreads();
      if (!flag[2]) continue;
    }
    auto kv_row = [&](const T* base) {
      return [&, base](int r) -> const T* {
        if (r >= n) return nullptr;
        return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
      };
    };
    load_tile<T, D>(ks, BK, kv_row(k));
    load_tile<T, D>(vs, BK, kv_row(v));
    __syncthreads();

    float s[4][JT], dp[4][JT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JT; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float qv[4], dv[4], kv[JT], vv[JT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * DS + c];
        dv[i] = dos[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        kv[j] = ks[(tx + 16 * j) * DS + c];
        vv[j] = vs[(tx + 16 * j) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const int jj = tx + 16 * j;
        float ds = 0.f;
        if (jj < n && allowed(p, row_q[r], k0 + jj, row_seg[r],
                              p.has_seg ? kseg[jj] : 0)) {
          const float pj = expf(s[i][j] * p.scale - lse_s[r]);
          ds = pj * (dp[i][j] - delta_s[r]) * p.scale;
        }
        dss[r * PS + jj] = ds;
      }
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float kk[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) kk[c] = ks[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dss[(ty + 16 * i) * PS + j];
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[i][c] = fmaf(d, kk[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = row_q[r];
    if (qi >= p.sq) continue;
    T* row = dq + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) store(row + tx + 16 * c, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv
// ---------------------------------------------------------------------------

template <int D, int BKV>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * (size_t)BKV * (D + 1) + 2 * (size_t)kRows * (D + 1)
                          + 2 * (size_t)BKV * (kRows + 1) + 2 * kRows)
         + sizeof(int) * (2 * kRows + BKV + 4);
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int32_t* __restrict__ seg, T* __restrict__ dk,
                     T* __restrict__ dv, FlashParams p) {
  constexpr int DS = D + 1;
  constexpr int RS = kRows + 1;
  constexpr int JI = BKV / 16;  // kv rows per thread
  constexpr int CT = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BKV * DS;
  float* qs = vs + BKV * DS;
  float* dos = qs + kRows * DS;
  float* pt = dos + kRows * DS;
  float* dst = pt + BKV * RS;
  float* lse_s = dst + BKV * RS;
  float* delta_s = lse_s + kRows;
  int* row_q = reinterpret_cast<int*>(delta_s + kRows);
  int* row_seg = row_q + kRows;
  int* kseg = row_seg + kRows;
  int* flag = kseg + BKV;  // kv-tile seg min, max; run flags (two slots)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  const int k0 = blockIdx.x * BKV;
  const int n = min(BKV, p.skv - k0);

  auto kv_row = [&](const T* base) {
    return [&, base](int r) -> const T* {
      if (r >= n) return nullptr;
      return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
    };
  };
  load_tile<T, D>(ks, BKV, kv_row(k));
  load_tile<T, D>(vs, BKV, kv_row(v));
  if (tid < BKV) kseg[tid] = (p.has_seg && tid < n) ? seg[(size_t)b * p.skv + k0 + tid] : 0;
  if (p.has_seg && tid < 32) {
    int mn, mx;
    seg_range(seg, (size_t)b * p.skv, k0, k0 + n, &mn, &mx);
    if (tid == 0) { flag[0] = mn; flag[1] = mx; }
  }
  __syncthreads();

  float dk_acc[JI][CT], dv_acc[JI][CT];
#pragma unroll
  for (int i = 0; i < JI; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) { dk_acc[i][c] = 0.f; dv_acc[i][c] = 0.f; }

  int q_lo = 0, q_hi = p.sq;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.sq, k0 + n - 1 + p.window);
  }
  int iter = 0;
  for (int q0 = q_lo; q0 < q_hi; q0 += p.bq, ++iter) {
    if (p.has_seg) {
      // Alternate flag slots: a fast warp 0 may write the next tile's flag
      // while slower threads still read this one.
      const int slot = 2 + (iter & 1);
      if (tid < 32) {
        int mn, mx;
        seg_range(seg, (size_t)b * p.sq, q0, min(q0 + p.bq, p.sq), &mn, &mx);
        if (tid == 0) flag[slot] = mn <= flag[1] && mx >= flag[0];
      }
      __syncthreads();
      if (!flag[slot]) continue;
    }
    if (tid < kRows) {
      const int qi = slot_q(p, q0, tid);
      row_q[tid] = qi;
      row_seg[tid] = (p.has_seg && qi < p.sq) ? seg[(size_t)b * p.sq + qi] : 0;
      float ls = kMaskedLse, dl = 0.f;
      if (qi < p.sq) {
        const size_t at = ((size_t)b * p.heads + kvh * p.group + tid / p.bq) * p.sq + qi;
        ls = lse[at];
        dl = delta[at];
      }
      lse_s[tid] = ls;
      delta_s[tid] = dl;
    }
    auto q_row = [&](const T* base) {
      return [&, base](int r) -> const T* {
        const int qi = slot_q(p, q0, r);
        if (qi >= p.sq) return nullptr;
        return base + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
      };
    };
    load_tile<T, D>(qs, kRows, q_row(q));
    load_tile<T, D>(dos, kRows, q_row(dout));
    __syncthreads();

    float s[JI][4], dp[JI][4];
#pragma unroll
    for (int i = 0; i < JI; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) { s[i][r] = 0.f; dp[i][r] = 0.f; }
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float kv[JI], vv[JI], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < JI; ++i) {
        kv[i] = ks[(ty + 16 * i) * DS + c];
        vv[i] = vs[(ty + 16 * i) * DS + c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = qs[(tx + 16 * r) * DS + c];
        dov[r] = dos[(tx + 16 * r) * DS + c];
      }
#pragma unroll
      for (int i = 0; i < JI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[i][r] = fmaf(kv[i], qv[r], s[i][r]);
          dp[i][r] = fmaf(vv[i], dov[r], dp[i][r]);
        }
    }
#pragma unroll
    for (int i = 0; i < JI; ++i) {
      const int j = ty + 16 * i;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = tx + 16 * rr;
        float pj = 0.f, ds = 0.f;
        if (j < n && allowed(p, row_q[r], k0 + j, row_seg[r], kseg[j])) {
          pj = expf(s[i][rr] * p.scale - lse_s[r]);
          ds = pj * (dp[i][rr] - delta_s[r]) * p.scale;
        }
        pt[j * RS + r] = pj;
        dst[j * RS + r] = ds;
      }
    }
    __syncthreads();

    const int rows = p.rows;
    for (int r = 0; r < rows; ++r) {
      float qq[CT], dd[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        qq[c] = qs[r * DS + tx + 16 * c];
        dd[c] = dos[r * DS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < JI; ++i) {
        const int j = ty + 16 * i;
        const float pp = pt[j * RS + r];
        const float dsv = dst[j * RS + r];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          dv_acc[i][c] = fmaf(pp, dd[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv, qq[c], dk_acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < JI; ++i) {
    const int j = ty + 16 * i;
    if (j >= n) continue;
    const size_t at = (((size_t)b * p.skv + k0 + j) * p.kv_heads + kvh) * D;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      store(dk + at + tx + 16 * c, dk_acc[i][c]);
      store(dv + at + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// kv tile of K1/K2 and K3 at each head_dim: 64 rows, 32 at d = 256 so that
// the float32 tiles fit the 227 KB a block may use.
template <int D> constexpr int kv_tile() { return D == 256 ? 32 : 64; }

template <int D> size_t smem_for(int which) {
  constexpr int BK = kv_tile<D>();
  if (which == 0) return fwd_smem_bytes<D, BK>();
  if (which == 1) return dq_smem_bytes<D, BK>();
  return dkv_smem_bytes<D, BK>();
}

size_t smem_bytes(int which, int d) {
  switch (d) {
    case 64: return smem_for<64>(which);
    case 128: return smem_for<128>(which);
    case 256: return smem_for<256>(which);
    default: return 0;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch(int which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg, void* out0, void* out1, void* out_lse,
                   const FlashParams& p, cudaStream_t stream) {
  constexpr int BK = kv_tile<D>();
  const size_t smem = smem_bytes(which, D);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  cudaError_t err;
  if (which == 0) {
    auto kernel = flash_fwd_kernel<T, D, BK>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
    kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, sg, static_cast<T*>(out0),
                                             static_cast<float*>(out_lse), p);
  } else if (which == 1) {
    auto kernel = flash_bwd_dq_kernel<T, D, BK>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), sg, static_cast<T*>(out0), p);
  } else {
    auto kernel = flash_bwd_dkv_kernel<T, D, BK>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.skv + BK - 1) / BK, p.batch * p.kv_heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), sg, static_cast<T*>(out0),
        static_cast<T*>(out1), p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, int which, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, const void* seg, void* out0, void* out1,
                       void* out_lse, const FlashParams& p, cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
    case 128: return launch<T, 128>(which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
    case 256: return launch<T, 256>(which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// which: 0 = forward (K1), 1 = dq (K2), 2 = dk/dv (K3). dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, dO and the outputs share it).
int run(int which, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* seg, void* out0,
        void* out1, void* out_lse, int batch, int sq, int skv, int heads,
        int kv_heads, int head_dim, int causal, int window, float scale,
        int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  if (group > kRows) return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.batch = batch;
  p.sq = sq;
  p.skv = skv;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = group;
  p.bq = kRows / group;
  p.rows = group * p.bq;
  p.causal = causal;
  p.window = window;
  p.has_seg = seg != nullptr;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(head_dim, which, q, k, v, dout, lse, delta, seg,
                                  out0, out1, out_lse, p, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(head_dim, which, q, k, v, dout, lse,
                                          delta, seg, out0, out1, out_lse, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dlti_flash_fwd(const void* q, const void* k, const void* v,
                              const void* seg, void* o, void* lse, int batch,
                              int sq, int skv, int heads, int kv_heads,
                              int head_dim, int causal, int window, float scale,
                              int dtype, void* stream) {
  return run(0, q, k, v, nullptr, nullptr, nullptr, seg, o, nullptr, lse, batch,
             sq, skv, heads, kv_heads, head_dim, causal, window, scale, dtype,
             stream);
}

extern "C" int dlti_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* seg, void* dq,
                                 int batch, int sq, int skv, int heads,
                                 int kv_heads, int head_dim, int causal,
                                 int window, float scale, int dtype, void* stream) {
  return run(1, q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, batch, sq,
             skv, heads, kv_heads, head_dim, causal, window, scale, dtype, stream);
}

extern "C" int dlti_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* seg, void* dk,
                                  void* dv, int batch, int sq, int skv, int heads,
                                  int kv_heads, int head_dim, int causal,
                                  int window, float scale, int dtype,
                                  void* stream) {
  return run(2, q, k, v, dout, lse, delta, seg, dk, dv, nullptr, batch, sq, skv,
             heads, kv_heads, head_dim, causal, window, scale, dtype, stream);
}

// Bytes of dynamic shared memory kernel `which` asks for at head_dim d (0 if
// d is not built); the wrapper checks it against the card's limit.
extern "C" long long dlti_flash_smem_bytes(int which, int head_dim) {
  return (long long)smem_bytes(which, head_dim);
}

extern "C" const char* dlti_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
