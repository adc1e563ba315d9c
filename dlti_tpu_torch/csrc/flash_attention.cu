// Flash attention forward and backward for Hopper (sm_90a), hand-written
// CUDA C++. Three kernels, five programs:
//
//   K1 forward            replaces dlti_tpu/ops/pallas/flash_attention.py
//                         _fwd_kernel (:132), launched by _flash_fwd (:270,
//                         pl.pallas_call :304): o = softmax(q k^T d^-1/2) v
//                         and the per-row logsumexp.
//                         bf16 and f16: flash_fwd_wgmma_kernel; float32:
//                         flash_fwd_kernel.
//   K2 dq                 replaces _dq_kernel (:366), launched by _flash_bwd
//                         (:490, pl.pallas_call :527): dq = sum_j ds k with
//                         ds = p (dO v^T - D) d^-1/2.
//                         bf16 and f16: flash_bwd_dq_wgmma_kernel; float32:
//                         flash_bwd_dq_kernel.
//   K3 dk/dv              replaces _dkv_kernel (:424), launched by _flash_bwd
//                         (pl.pallas_call :560): dv = sum p^T dO,
//                         dk = sum ds^T q over every query head of the group.
//                         bf16 and f16 at d 64 and 128:
//                         flash_bwd_dkv_wgmma_kernel; float32, and bf16 and
//                         f16 at d 256: flash_bwd_dkv_kernel.
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
// Work per block, every program: one block per (batch * kv head, q tile)
// for K1 and K2, per (batch * kv head, kv tile of 64 rows) for K3. A q tile
// holds kRows = 64 rows: bq = 64 / group query positions for each of the
// group's query heads, so a K/V tile is read once for the whole GQA group.
// The TPU grid's sequential axis (m/l/acc carried in VMEM scratch) becomes a
// loop inside the block. K3 owns its kv tile and loops over the q tiles, so
// no two blocks write the same dk/dv row and no atomics are used. The loops
// visit only the causal/window band (K1/K2 sweep kv in
// [max(0, q0 - window + 1), min(skv, q_end)), K3 sweeps q in
// [k0, min(sq, k_last + window))), and with segment ids a tile whose id
// interval is disjoint from the other side's is skipped before it is
// requested, like _seg_run (:121). Rows past sq or skv are never read from
// device memory: their shared-memory slots are zero-filled.
//
// What bounds K1 and K3 on this card: at the training shape (s 512, d 128)
// attention does 4 s d operations per (row, head) against 4 d bytes moved
// per row, so the work is operation-bound on paper, on the tensor cores (989
// TFLOP/s bf16); the smoke test's bound for the whole call is the bytes
// (q, k, v, o once: 0.020 ms for K1) because the causal half of the products
// takes 0.009 ms at the peak rate. The float32 programs run on the CUDA cores
// (67 TFLOP/s) and, below that, on shared-memory bandwidth: every tile is
// widened to float32 in shared memory and every product re-reads both
// operands from it. They took 37-39x their bound in bf16.
//
// The 2-byte programs (K1, K2; K3 at d 64 and 128), each built for bf16 and
// for f16, put every product on the tensor cores with wgmma, one warpgroup
// (128 threads) per block:
// * Tiles stay 2-byte in shared memory in the layout wgmma's descriptors name:
//   column blocks of 64 channels (128 bytes a row), 16-byte chunk c of row r
//   at c ^ (r % 8) (the 128-byte swizzle), each block 1024-byte aligned. The
//   same tile is a K-major operand (q k^T, k q^T, v dO^T: the channels are
//   the reduction) and an MN-major one (p v, p^T dO, ds^T q: the rows are).
// * Asynchronous copies feed a ring of two stages: cp.async 16-byte copies
//   (src-size 0 zero-fills a row past the end without reading it), so tile
//   j + 1 is in flight while tile j computes. Band and segment skips decide
//   the next tile before it is requested.
// * K1: S = Q K^T by wgmma m64n{BK}k16 from shared memory; the online
//   softmax runs on the accumulator registers (each thread holds two rows;
//   row max and sum by shuffles inside each quad, l summed from the float32
//   p); O += P V by wgmma with P from registers (the accumulator's layout is
//   the A-fragment layout) and V as a transposed B from shared memory.
// * K2: Q and dO stay in shared memory, K and V stream through the ring;
//   S = Q K^T and dP = dO V^T by wgmma; P = exp(S scale - lse) and
//   dS = P (dP - D) scale in registers; dQ += dS K by wgmma with dS from
//   registers and K as an MN-major B (the kv rows are the reduction). Each
//   thread's two rows keep their lse and D in registers. 32-row kv tiles at
//   d 256, as K1, for the 128-register dq accumulator.
// * K3: S^T = K Q^T and dP^T = V dO^T by wgmma; P^T = exp(S^T scale - lse)
//   and dS^T = P^T (dP^T - D) scale in registers; dV += P^T dO and
//   dK += dS^T Q by wgmma with the A operand from registers.
// * Numerics, the hi/lo split. The Pallas kernels upcast the bf16 tiles and
//   multiply in float32 (:171-173, :347-350). A product of two bf16 values
//   is exact in a float32 accumulator, so q k^T and dO v^T on bf16 tensor
//   cores equal float32 FMAs up to the order of the sum. p, p^T, ds and ds^T
//   are float32, though: rounding one to bf16 (as FlashAttention-2 does)
//   moves o by up to 2^-9 |v|, past the 1e-3 limit where o is near 0. So
//   each is split into hi = bf16(x) and lo = bf16(x - hi), and two wgmmas
//   add hi * B and lo * B into the same float32 accumulator: about 16
//   significant bits of x, an error near 2^-17 relative. It costs 1.5x the
//   tensor-core work of the unsplit kernels.
// * f16 (the fp16 training path, under the dynamic loss scaler): the same
//   programs with wgmma .f16 (the same shapes, descriptors and swizzle).
//   A product of two f16 values is exact in float32 too. f16 keeps 11
//   significant bits against bf16's 8 but has a narrow range (subnormal
//   below 2^-14, inf above 65504), so the split operands are brought into
//   range by powers of two before the split and the float32 accumulators
//   are scaled back exactly: p and p^T (at most 1) by 2^14; ds and ds^T,
//   whose size follows dO (2^16 times a gradient under the default loss
//   scale), per accumulator row by 2^e with e chosen so the row's largest
//   |ds| seen so far lies in [2^14, 2^15): e only falls, and when it falls
//   the row's accumulator is scaled by the same power of two. So |ds| above
//   65504 does not overflow where the float32 kernels would not, and small
//   ds do not fall into subnormals. hi + lo then carries ~22 bits of p and
//   ds. Rounding p once to f16 (keeping only hi) would take up to the whole
//   f16 limit of chip_smoke.py where the split takes under 0.3% of it
//   (tests/test_torch_flash_attention.py emulates both), so f16 splits as
//   bf16 does.
// * The float32 programs stay on the CUDA cores: TF32 would break their
//   1e-4 limit, and float32 is not on the training path. K3 at d 256 in
//   bf16 and f16 stays there too: the dk and dv accumulators of a 64-row
//   tile are 2 x 64 x 256 float32, 256 registers a thread for one
//   warpgroup.
//
// Left on the table (later work): warp specialisation (a producer warp with
// TMA and mbarriers, consumer warpgroups with setmaxnreg), overlapping one
// tile's softmax with the next tile's q k^T, persistent blocks with a causal
// schedule that balances the triangle, clusters sharing K/V tiles by
// multicast, and K3 at d 256 split across two warpgroups.
//
// Built by dlti_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The build may compile this file in parts at once and link them
// (ops/_build.py, -DDLTI_PART=0..2): part p holds the programs of one
// head_dim (64, 128, 256), part 0 the entry points too. Without DLTI_PART
// the file is one unit.
#ifdef DLTI_PART
#define DLTI_IN_PART(p) (DLTI_PART == (p))
#else
#define DLTI_IN_PART(p) 1
#endif

struct FlashParams {
  int batch, sq, skv, heads, kv_heads, group, bq, rows;
  int causal, window, has_seg;
  float scale;
};

namespace dlti_flash {
// The kernel each entry point (0 = K1, 1 = K2, 2 = K3) launched last, by its
// function name: what dlti_flash_last_kernel reports to the wrapper.
extern const char* last_kernel[3];
#if DLTI_IN_PART(0)
const char* last_kernel[3] = {"", "", ""};
#endif
}  // namespace dlti_flash

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kRows = 64;      // query rows (group x bq) per tile
constexpr float kMaskedLse = 1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

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
// K1 in float32: CUDA cores
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
// K2 in float32: CUDA cores
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
// K3 in float32, and in bf16 and f16 at d 256: CUDA cores
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
// bf16 and f16 on the tensor cores: wgmma, descriptors, asynchronous copies
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// f16: p and p^T enter the split times 2^14 (p <= 1, so at most 16384).
constexpr float kPScale = 16384.f;
constexpr float kPUnscale = 1.f / 16384.f;
// f16: the ds row exponent before the row has seen a non-zero ds, and its
// least value: float16 inputs bound |dO v^T| and D by 65504^2 * 256 < 2^41,
// so |ds| < 2^42 and 2^-30 brings any finite row below 2^15 (an inf row
// stays inf, as it would in float32).
constexpr int kDsExpStart = 64;
constexpr int kDsExpMin = -30;

// The 2-byte element types of the tensor-core programs: a pair of them in
// one 32-bit register (the A fragments and the output stores), and the
// PTX type name wgmma takes.
template <typename E> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static constexpr bool kF16 = false;
  static constexpr int kCode = 1;
  __device__ static __forceinline__ Pair pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static __forceinline__ float2 unpack(Pair x) { return __bfloat1622float2(x); }
};
template <> struct Elem<__half> {
  using Pair = __half2;
  static constexpr bool kF16 = true;
  static constexpr int kCode = 2;
  __device__ static __forceinline__ Pair pack(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  __device__ static __forceinline__ float2 unpack(Pair x) { return __half22float2(x); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to 1024 bytes, as the 128-byte
// swizzle needs (the launch asks for 1024 bytes of slack).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
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
// Shared-memory writes of this thread (cp.async lands through the generic
// proxy) made visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// The same for A fragments in registers: keeps them live, unmoved, until
// the wgmma_wait that follows the wgmmas reading them.
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// A tile of ROWS rows x D 2-byte channels in shared memory is stored as D /
// 64 column blocks of ROWS x 128 bytes; the 16-byte chunk c of row r sits at
// chunk position c ^ (r % 8) of its 128-byte row (the 128-byte swizzle). A
// wgmma descriptor: start address, leading and stride byte offsets (16-byte
// units), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// The tile as a K-major operand (the channels are the reduction), k-step
// kk: channels 16 kk .. 16 kk + 15, 32 bytes into column block kk / 4; 8-row
// groups 1024 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}
// The tile as an MN-major operand (the rows are the reduction), k-step kk:
// rows 16 kk .. 16 kk + 15; 8-row groups 1024 bytes apart, column blocks of
// 64 channels ROWS * 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, ROWS * 128, 1024);
}

// Rows [0, ROWS) of a tile whose row r starts at row_ptr(r) (nullptr: zero
// row) into the swizzled layout, one 16-byte cp.async per chunk; neighbouring
// threads take neighbouring chunks of a row. A zero row's copies name
// `valid_src`, a mapped address, and read nothing from it.
template <int ROWS, int D, typename E, typename RowPtr>
__device__ __forceinline__ void load_tile_async(E* dst, const E* valid_src,
                                                RowPtr row_ptr) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kWgThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const E* src = row_ptr(r);
    E* out = dst + (c >> 3) * ROWS * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
    cp_async16(out, src != nullptr ? src + c * 8 : valid_src, src != nullptr);
  }
}

template <typename Pair>
__device__ __forceinline__ uint32_t pair_bits(Pair x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Accumulator values x[2 r], x[2 r + 1] (r = 0..3) of k-step kk, each
// times mul[h] of its row h, split into the A fragments hi = E(x) and lo =
// E(x - hi). The accumulator of a 64 x N wgmma holds, in thread t of the
// warpgroup, element 4 j + e at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2)
// and column 8 j + 2 (t % 4) + e % 2 (so element i is in row half (i / 2)
// % 2); the A fragment of k-step kk is elements 8 kk .. 8 kk + 7 in that
// order. Without mul (p, and bf16 ds) nothing is multiplied.
template <typename E, int N>
__device__ __forceinline__ void split_hi_lo(const float (&x)[N], int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4], const float* mul = nullptr) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
    if (mul != nullptr) {
      a *= mul[r & 1];
      b *= mul[r & 1];
    }
    const typename Elem<E>::Pair h = Elem<E>::pack(a, b);
    const float2 hf = Elem<E>::unpack(h);
    hi[r] = pair_bits(h);
    lo[r] = pair_bits(Elem<E>::pack(a - hf.x, b - hf.y));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^n exactly, for n in [-126, 127].
__device__ __forceinline__ float exp2i(int n) { return __int_as_float((n + 127) << 23); }

// f16: brings each of this thread's two accumulator rows' ds into range
// before the split. x holds the rows' float32 ds of this tile (element i in
// row half (i / 2) % 2), ex the rows' exponents so far, acc their
// accumulators. A row whose largest |ds| (over the quad that holds it) needs
// a smaller exponent takes it, and its accumulator is scaled by the same
// power of two, exactly; mul gets 2^exp of each row. The exponent comes from
// the float's bits (0 and subnormals give kDsExpStart, inf gives kDsExpMin);
// a warp multiplies its accumulators only when one of its rows' exponents
// fell, which after a row's first tiles is rare.
template <int N, int M>
__device__ __forceinline__ void ds_row_scale(const float (&x)[N], int (&ex)[2], float (&acc)[M],
                                             float (&mul)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], fabsf(x[i]));
  float f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bits = ((__float_as_int(quad_max(mx[h])) >> 23) & 0xff) - 127;
    const int e = min(min(max(14 - bits, kDsExpMin), kDsExpStart), ex[h]);
    f[h] = exp2i(e - ex[h]);  // 1 unless the row's exponent fell
    ex[h] = e;
    mul[h] = exp2i(e);
  }
  if (__any_sync(0xffffffffu, f[0] != 1.f || f[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] *= f[(i >> 1) & 1];
  }
}

// The wgmma instructions, for bf16 ("bf16") or f16 ("f16") operands.
#define DLTI_WGMMA_SS_N32(TY)                                                              \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "           \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define DLTI_WGMMA_SS_N64(TY)                                                              \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                                          \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define DLTI_WGMMA_RS_N64(TY)                                                              \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

#define DLTI_WGMMA_RS_N128(TY)                                                             \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),     \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),     \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),     \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

#define DLTI_WGMMA_RS_N256(TY)                                                                  \
  asm volatile(                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"        \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"        \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"        \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "   \
      "%125, %126, %127}, "                                                                     \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),                \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),              \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),          \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),          \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),          \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),          \
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),          \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),          \
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),          \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),          \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),          \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),        \
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),    \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),    \
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),    \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),    \
        "+f"(d[126]), "+f"(d[127])                                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

// d (64 x N, fp32) = A (64 x 16) * B (N x 16)^T (+ d when scale_d != 0); A
// and B in shared memory, both K-major. N = 32 or 64.
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 32) {
    if constexpr (Elem<E>::kF16) DLTI_WGMMA_SS_N32("f16");
    else DLTI_WGMMA_SS_N32("bf16");
  } else {
    if constexpr (Elem<E>::kF16) DLTI_WGMMA_SS_N64("f16");
    else DLTI_WGMMA_SS_N64("bf16");
  }
}

// d (64 x N, fp32) = A (64 x 16) * B (16 x N) (+ d when scale_d != 0); A in
// four registers of element pairs, B in shared memory, MN-major. N = 64,
// 128 or 256.
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    if constexpr (Elem<E>::kF16) DLTI_WGMMA_RS_N64("f16");
    else DLTI_WGMMA_RS_N64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (Elem<E>::kF16) DLTI_WGMMA_RS_N128("f16");
    else DLTI_WGMMA_RS_N128("bf16");
  } else {
    if constexpr (Elem<E>::kF16) DLTI_WGMMA_RS_N256("f16");
    else DLTI_WGMMA_RS_N256("bf16");
  }
}

#undef DLTI_WGMMA_SS_N32
#undef DLTI_WGMMA_SS_N64
#undef DLTI_WGMMA_RS_N64
#undef DLTI_WGMMA_RS_N128
#undef DLTI_WGMMA_RS_N256

// ---------------------------------------------------------------------------
// K1, bf16 and f16: wgmma
// ---------------------------------------------------------------------------

// kv tile of the 2-byte forward: 64 rows; 32 at d = 256, where the output
// accumulator alone takes 128 registers a thread.
template <int D> constexpr int fwd_wgmma_tile() { return D == 256 ? 32 : 64; }

template <int D, int BK>
constexpr size_t fwd_wgmma_smem_bytes() {
  // alignment slack, q tile, two stages of K and V, two stages of kv ids
  return 1024 + sizeof(bf16) * ((size_t)kRows * D + 4 * (size_t)BK * D) + sizeof(int) * 2 * BK;
}

template <typename E, int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const int32_t* __restrict__ seg,
                       E* __restrict__ o, float* __restrict__ lse, FlashParams p) {
  constexpr int KT = BK * D;  // elements of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  E* qs = reinterpret_cast<E*>(align_1024(smem_raw));
  E* ks = qs + kRows * D;  // two stages
  E* vs = ks + 2 * KT;     // two stages
  int* kseg = reinterpret_cast<int*>(vs + 2 * KT);  // two stages of BK ids

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  // Last q tile first: under a causal mask it has the most kv tiles, so the
  // longest blocks start first and the short ones fill the tail.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.bq;
  const int q_end = min(q0 + p.bq, p.sq);

  // This thread's two rows of the tile: 16 warp + lane / 4, and 8 below.
  int row_q[2], row_seg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_q[h] = slot_q(p, q0, 16 * warp + (lane >> 2) + 8 * h);
    row_seg[h] = (p.has_seg && row_q[h] < p.sq) ? seg[(size_t)b * p.sq + row_q[h]] : 0;
  }
  // Every warp computes the same segment intervals, so every thread takes
  // the same tiles without a barrier.
  int q_mn = 0, q_mx = 0;
  if (p.has_seg) seg_range(seg, (size_t)b * p.sq, q0, q_end, &q_mn, &q_mx);

  int k_lo = 0, k_hi = p.skv;
  if (p.causal) {
    k_hi = min(p.skv, q_end);
    if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  }
  auto next_tile = [&](int k0) {
    for (; k0 < k_hi && p.has_seg; k0 += BK) {
      int mn, mx;
      seg_range(seg, (size_t)b * p.skv, k0, min(k0 + BK, p.skv), &mn, &mx);
      if (q_mn <= mx && q_mx >= mn) break;
    }
    return k0;
  };
  auto load_kv = [&](int k0, int stage) {
    auto kv_row = [&](const E* base) {
      return [&, base](int r) -> const E* {
        if (k0 + r >= p.skv) return nullptr;
        return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
      };
    };
    load_tile_async<BK, D>(ks + stage * KT, k, kv_row(k));
    load_tile_async<BK, D>(vs + stage * KT, v, kv_row(v));
    if (p.has_seg && tid < BK)
      cp_async4(kseg + stage * BK + tid, seg + (size_t)b * p.skv + k0 + tid, k0 + tid < p.skv);
  };

  load_tile_async<kRows, D>(qs, q, [&](int r) -> const E* {
    const int qi = slot_q(p, q0, r);
    if (qi >= p.sq) return nullptr;
    return q + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
  });
  int cur = next_tile(k_lo);
  if (cur < k_hi) load_kv(cur, 0);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};  // m in log2 units
  const float sl2 = p.scale * kLog2e;
  const uint32_t qs_addr = smem_addr(qs);

  for (int stage = 0; cur < k_hi; stage ^= 1) {
    const int nxt = next_tile(cur + BK);
    if (nxt < k_hi) load_kv(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `cur` (and q) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks_addr = smem_addr(ks + stage * KT);
    const uint32_t vs_addr = smem_addr(vs + stage * KT);

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E, BK>(s, desc_k_major<kRows>(qs_addr, kk), desc_k_major<BK>(ks_addr, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Mask only a tile that crosses the band, the end or a segment edge.
    const bool full = !p.has_seg && cur + BK <= p.skv
                      && (!p.causal || (cur + BK - 1 <= q0
                                        && (p.window == 0 || cur > q_end - 1 - p.window)));
    const int* ts = kseg + stage * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float x = s[i] * sl2;
      if (!full && !allowed(p, row_q[h], cur + col, row_seg[h], p.has_seg ? ts[col] : 0))
        x = -INFINITY;
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_i[h], quad_max(mx[h]));
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing yet
      alpha[h] = exp2f(m_i[h] - m_use[h]);
      m_i[h] = m_new;
    }
    // f16: p times 2^14 (exact), so l and acc are too; o = acc / l is not.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m_use[h]);
      if constexpr (Elem<E>::kF16) s[i] *= kPScale;
      rs[h] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * alpha[h] + rs[h];  // quad-partial
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) split_hi_lo<E>(s, kk, p_hi[kk], p_lo[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<E, D>(acc, p_hi[kk], desc_mn_major<BK>(vs_addr, kk), 1);
      wgmma_rs<E, D>(acc, p_lo[kk], desc_mn_major<BK>(vs_addr, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    __syncthreads();  // every warp is done with this stage before it is refilled
    cur = nxt;
  }
  cp_async_wait<0>();

  float l_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_row[h] = quad_sum(l_i[h]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const int qi = row_q[h];
    if (qi >= p.sq) continue;
    const int head = kvh * p.group + r / p.bq;
    const float l = l_row[h], inv = l > 0.f ? 1.f / l : 0.f;
    E* orow = o + (((size_t)b * p.sq + qi) * p.heads + head) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<typename Elem<E>::Pair*>(orow + 8 * j) =
          Elem<E>::pack(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    const float l_true = Elem<E>::kF16 ? l * kPUnscale : l;
    if ((lane & 3) == 0)
      lse[((size_t)b * p.heads + head) * p.sq + qi] =
          l > 0.f ? (m_i[h] + log2f(l_true)) * kLn2 : kMaskedLse;
  }
}

// ---------------------------------------------------------------------------
// K3, bf16 and f16 at d 64 and 128: wgmma
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_wgmma_smem_bytes() {
  // alignment slack; K and V; two stages of Q and dO; two stages of the
  // rows' lse, D and segment id; each slot's offset in its head
  return 1024 + sizeof(bf16) * 6 * (size_t)kRows * D + sizeof(float) * 6 * kRows
         + sizeof(int) * kRows;
}

template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v, const E* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int32_t* __restrict__ seg, E* __restrict__ dk,
                           E* __restrict__ dv, FlashParams p) {
  constexpr int T = kRows * D;  // elements of one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  E* ks = reinterpret_cast<E*>(align_1024(smem_raw));
  E* vs = ks + T;
  E* qs = vs + T;        // two stages
  E* dos = qs + 2 * T;   // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * T);  // two stages of kRows
  float* dl_s = lse_s + 2 * kRows;
  int* qseg_s = reinterpret_cast<int*>(dl_s + 2 * kRows);
  int* slot_off = qseg_s + 2 * kRows;  // q tile slot -> position offset, -1 if unused

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  const int k0 = blockIdx.x * kRows;
  const int n = min(kRows, p.skv - k0);

  if (tid < kRows) slot_off[tid] = tid < p.rows ? tid % p.bq : -1;
  // This thread's two kv rows: 16 warp + lane / 4, and 8 below.
  int krow[2], kseg_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    krow[h] = k0 + 16 * warp + (lane >> 2) + 8 * h;
    kseg_r[h] = (p.has_seg && krow[h] < p.skv) ? seg[(size_t)b * p.skv + krow[h]] : 0;
  }
  int k_mn = 0, k_mx = 0;
  if (p.has_seg) seg_range(seg, (size_t)b * p.skv, k0, k0 + n, &k_mn, &k_mx);

  int q_lo = 0, q_hi = p.sq;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.sq, k0 + n - 1 + p.window);
  }
  auto next_tile = [&](int q0) {
    for (; q0 < q_hi && p.has_seg; q0 += p.bq) {
      int mn, mx;
      seg_range(seg, (size_t)b * p.sq, q0, min(q0 + p.bq, p.sq), &mn, &mx);
      if (mn <= k_mx && mx >= k_mn) break;
    }
    return q0;
  };
  auto load_q = [&](int q0, int stage) {
    auto q_row = [&](const E* base) {
      return [&, base](int r) -> const E* {
        const int qi = slot_q(p, q0, r);
        if (qi >= p.sq) return nullptr;
        return base + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
      };
    };
    load_tile_async<kRows, D>(qs + stage * T, q, q_row(q));
    load_tile_async<kRows, D>(dos + stage * T, dout, q_row(dout));
    if (tid < kRows) {
      const int qi = slot_q(p, q0, tid);
      const bool ok = qi < p.sq;
      const size_t at =
          ok ? ((size_t)b * p.heads + kvh * p.group + tid / p.bq) * p.sq + qi : 0;
      cp_async4(lse_s + stage * kRows + tid, lse + at, ok);
      cp_async4(dl_s + stage * kRows + tid, delta + at, ok);
      if (p.has_seg)
        cp_async4(qseg_s + stage * kRows + tid, seg + (size_t)b * p.sq + (ok ? qi : 0), ok);
    }
  };

  auto kv_row = [&](const E* base) {
    return [&, base](int r) -> const E* {
      if (r >= n) return nullptr;
      return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
    };
  };
  load_tile_async<kRows, D>(ks, k, kv_row(k));
  load_tile_async<kRows, D>(vs, v, kv_row(v));
  int cur = next_tile(q_lo);
  if (cur < q_hi) load_q(cur, 0);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // f16: dk_acc holds dK * 2^ds_exp[h] per kv row, dv_acc dV * 2^14.
  int ds_exp[2] = {kDsExpStart, kDsExpStart};
  const float sl2 = p.scale * kLog2e;
  const uint32_t ks_addr = smem_addr(ks), vs_addr = smem_addr(vs);

  for (int stage = 0; cur < q_hi; stage ^= 1) {
    const int nxt = next_tile(cur + p.bq);
    if (nxt < q_hi) load_q(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `cur` (and K, V) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t qs_addr = smem_addr(qs + stage * T);
    const uint32_t dos_addr = smem_addr(dos + stage * T);

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q slots each.
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E, 64>(st, desc_k_major<kRows>(ks_addr, kk), desc_k_major<kRows>(qs_addr, kk),
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E, 64>(dpt, desc_k_major<kRows>(vs_addr, kk), desc_k_major<kRows>(dos_addr, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Slots past sq or past the group's rows hold zero Q and dO rows and
    // lse = D = 0: they add exactly 0, so only the band and segments mask.
    const int q_last = min(cur + p.bq, p.sq) - 1;
    const bool full = !p.has_seg
                      && (!p.causal || (k0 + n - 1 <= cur
                                        && (p.window == 0 || k0 > q_last - p.window)));
    const float* ls = lse_s + stage * kRows;
    const float* dls = dl_s + stage * kRows;
    const int* qsg = qseg_s + stage * kRows;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float pr = exp2f(fmaf(st[i], sl2, -ls[c] * kLog2e));
      if (!full) {
        const int off = slot_off[c];
        if (off < 0 || !allowed(p, cur + off, krow[h], p.has_seg ? qsg[c] : 0, kseg_r[h]))
          pr = 0.f;
      }
      st[i] = Elem<E>::kF16 ? pr * kPScale : pr;
      dpt[i] = pr * (dpt[i] - dls[c]) * p.scale;
    }

    // dV += P^T dO, dK += dS^T Q: A = P^T, dS^T (hi and lo) from registers,
    // B = dO, Q as MN-major operands (the 64 q slots are the reduction).
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_hi_lo<E>(st, kk, hi[kk], lo[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<E, D>(dv_acc, hi[kk], desc_mn_major<kRows>(dos_addr, kk), 1);
      wgmma_rs<E, D>(dv_acc, lo[kk], desc_mn_major<kRows>(dos_addr, kk), 1);
    }
    wgmma_commit();
    // f16: dk_acc is not read by a wgmma in flight here (only dv_acc is).
    float ds_mul[2];
    if constexpr (Elem<E>::kF16) ds_row_scale(dpt, ds_exp, dk_acc, ds_mul);
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      split_hi_lo<E>(dpt, kk, ds_hi[kk], ds_lo[kk], Elem<E>::kF16 ? ds_mul : nullptr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<E, D>(dk_acc, ds_hi[kk], desc_mn_major<kRows>(qs_addr, kk), 1);
      wgmma_rs<E, D>(dk_acc, ds_lo[kk], desc_mn_major<kRows>(qs_addr, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncthreads();  // every warp is done with this stage before it is refilled
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= p.skv) continue;
    // f16: undo the exact powers of two (1 and 1 for bf16).
    const float dk_unscale = Elem<E>::kF16 ? exp2i(-ds_exp[h]) : 1.f;
    const float dv_unscale = Elem<E>::kF16 ? kPUnscale : 1.f;
    const size_t at = (((size_t)b * p.skv + krow[h]) * p.kv_heads + kvh) * D + 2 * (lane & 3);
    using Pair = typename Elem<E>::Pair;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<Pair*>(dk + at + 8 * j) = Elem<E>::pack(
          dk_acc[4 * j + 2 * h] * dk_unscale, dk_acc[4 * j + 2 * h + 1] * dk_unscale);
      *reinterpret_cast<Pair*>(dv + at + 8 * j) = Elem<E>::pack(
          dv_acc[4 * j + 2 * h] * dv_unscale, dv_acc[4 * j + 2 * h + 1] * dv_unscale);
    }
  }
}

// ---------------------------------------------------------------------------
// K2, bf16 and f16: wgmma
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t dq_wgmma_smem_bytes() {
  // alignment slack; Q and dO; two stages of K and V; two stages of kv ids
  return 1024 + sizeof(bf16) * (2 * (size_t)kRows * D + 4 * (size_t)BK * D)
         + sizeof(int) * 2 * BK;
}

template <typename E, int D, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int32_t* __restrict__ seg, E* __restrict__ dq,
                          FlashParams p) {
  constexpr int KT = BK * D;  // elements of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  E* qs = reinterpret_cast<E*>(align_1024(smem_raw));
  E* dos = qs + kRows * D;
  E* ks = dos + kRows * D;  // two stages
  E* vs = ks + 2 * KT;      // two stages
  int* kseg = reinterpret_cast<int*>(vs + 2 * KT);  // two stages of BK ids

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / p.kv_heads, kvh = blockIdx.y % p.kv_heads;
  // Last q tile first, as in K1: the longest blocks start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.bq;
  const int q_end = min(q0 + p.bq, p.sq);

  // This thread's two rows of the tile (16 warp + lane / 4, and 8 below):
  // position, segment id, and their lse and D in log2 units. A slot with no
  // row gets lse = +1e30, so its p is 0.
  int row_q[2], row_seg[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    row_q[h] = slot_q(p, q0, r);
    const bool ok = row_q[h] < p.sq;
    row_seg[h] = (p.has_seg && ok) ? seg[(size_t)b * p.sq + row_q[h]] : 0;
    const size_t at = ((size_t)b * p.heads + kvh * p.group + r / p.bq) * p.sq + row_q[h];
    lse2[h] = (ok ? lse[at] : kMaskedLse) * kLog2e;
    dl[h] = ok ? delta[at] : 0.f;
  }
  int q_mn = 0, q_mx = 0;
  if (p.has_seg) seg_range(seg, (size_t)b * p.sq, q0, q_end, &q_mn, &q_mx);

  int k_lo = 0, k_hi = p.skv;
  if (p.causal) {
    k_hi = min(p.skv, q_end);
    if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  }
  auto next_tile = [&](int k0) {
    for (; k0 < k_hi && p.has_seg; k0 += BK) {
      int mn, mx;
      seg_range(seg, (size_t)b * p.skv, k0, min(k0 + BK, p.skv), &mn, &mx);
      if (q_mn <= mx && q_mx >= mn) break;
    }
    return k0;
  };
  auto load_kv = [&](int k0, int stage) {
    auto kv_row = [&](const E* base) {
      return [&, base](int r) -> const E* {
        if (k0 + r >= p.skv) return nullptr;
        return base + (((size_t)b * p.skv + k0 + r) * p.kv_heads + kvh) * D;
      };
    };
    load_tile_async<BK, D>(ks + stage * KT, k, kv_row(k));
    load_tile_async<BK, D>(vs + stage * KT, v, kv_row(v));
    if (p.has_seg && tid < BK)
      cp_async4(kseg + stage * BK + tid, seg + (size_t)b * p.skv + k0 + tid, k0 + tid < p.skv);
  };

  auto q_row = [&](const E* base) {
    return [&, base](int r) -> const E* {
      const int qi = slot_q(p, q0, r);
      if (qi >= p.sq) return nullptr;
      return base + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D;
    };
  };
  load_tile_async<kRows, D>(qs, q, q_row(q));
  load_tile_async<kRows, D>(dos, dout, q_row(dout));
  int cur = next_tile(k_lo);
  if (cur < k_hi) load_kv(cur, 0);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int ds_exp[2] = {kDsExpStart, kDsExpStart};  // f16: acc holds dQ * 2^ds_exp[h]
  const float sl2 = p.scale * kLog2e;
  const uint32_t qs_addr = smem_addr(qs), dos_addr = smem_addr(dos);

  for (int stage = 0; cur < k_hi; stage ^= 1) {
    const int nxt = next_tile(cur + BK);
    if (nxt < k_hi) load_kv(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `cur` (and Q, dO) landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks_addr = smem_addr(ks + stage * KT);
    const uint32_t vs_addr = smem_addr(vs + stage * KT);

    // S = Q K^T and dP = dO V^T: 64 rows x BK kv columns each.
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E, BK>(s, desc_k_major<kRows>(qs_addr, kk), desc_k_major<BK>(ks_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E, BK>(dp, desc_k_major<kRows>(dos_addr, kk), desc_k_major<BK>(vs_addr, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S scale - lse), dS = P (dP - D) scale; masked only on a tile
    // that crosses the band, the kv end or a segment edge (K rows past the
    // end are zero, but a p there could overflow and make 0 * inf).
    const bool full = !p.has_seg && cur + BK <= p.skv
                      && (!p.causal || (cur + BK - 1 <= q0
                                        && (p.window == 0 || cur > q_end - 1 - p.window)));
    const int* ts = kseg + stage * BK;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      float pr = exp2f(fmaf(s[i], sl2, -lse2[h]));
      if (!full && !allowed(p, row_q[h], cur + col, row_seg[h], p.has_seg ? ts[col] : 0))
        pr = 0.f;
      s[i] = pr * (dp[i] - dl[h]) * p.scale;
    }

    // dQ += dS K: A = dS (hi and lo) from registers, B = K as an MN-major
    // operand (the BK kv rows are the reduction).
    float ds_mul[2];
    if constexpr (Elem<E>::kF16) ds_row_scale(s, ds_exp, acc, ds_mul);
    uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      split_hi_lo<E>(s, kk, ds_hi[kk], ds_lo[kk], Elem<E>::kF16 ? ds_mul : nullptr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<E, D>(acc, ds_hi[kk], desc_mn_major<BK>(ks_addr, kk), 1);
      wgmma_rs<E, D>(acc, ds_lo[kk], desc_mn_major<BK>(ks_addr, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncthreads();  // every warp is done with this stage before it is refilled
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const int qi = row_q[h];
    if (qi >= p.sq) continue;
    E* row = dq + (((size_t)b * p.sq + qi) * p.heads + kvh * p.group + r / p.bq) * D
             + 2 * (lane & 3);
    const float unscale = Elem<E>::kF16 ? exp2i(-ds_exp[h]) : 1.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<typename Elem<E>::Pair*>(row + 8 * j) =
          Elem<E>::pack(acc[4 * j + 2 * h] * unscale, acc[4 * j + 2 * h + 1] * unscale);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// kv tile of the CUDA-core programs at each head_dim: 64 rows, 32 at
// d = 256 so that the float32 tiles fit the 227 KB a block may use.
template <int D> constexpr int kv_tile() { return D == 256 ? 32 : 64; }

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
constexpr bool known_dtype(int dtype) { return dtype >= 0 && dtype <= 2; }

// Whether kernel `which` (0 = K1, 1 = K2, 2 = K3) at head_dim d and dtype
// code `dtype` runs its wgmma program or its CUDA-core one.
constexpr bool uses_wgmma(int which, int d, int dtype) {
  return (dtype == 1 || dtype == 2) && (which <= 1 || (which == 2 && d <= 128));
}

template <int D> size_t smem_for(int which, int dtype) {
  constexpr int BK = kv_tile<D>();
  if (uses_wgmma(which, D, dtype)) {
    if (which == 0) return fwd_wgmma_smem_bytes<D, fwd_wgmma_tile<D>()>();
    if (which == 1) return dq_wgmma_smem_bytes<D, fwd_wgmma_tile<D>()>();
    if constexpr (D <= 128) return dkv_wgmma_smem_bytes<D>();
  }
  if (which == 0) return fwd_smem_bytes<D, BK>();
  if (which == 1) return dq_smem_bytes<D, BK>();
  return dkv_smem_bytes<D, BK>();
}

size_t smem_bytes(int which, int d, int dtype) {
  if (!known_dtype(dtype)) return 0;
  switch (d) {
    case 64: return smem_for<64>(which, dtype);
    case 128: return smem_for<128>(which, dtype);
    case 256: return smem_for<256>(which, dtype);
    default: return 0;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The wgmma programs (bf16 and f16): K1 and K2 at every head_dim, K3 at d
// 64 and 128.
template <typename E, int D>
cudaError_t launch_wgmma(int which, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* seg, void* out0, void* out1, void* out_lse,
                         const FlashParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(which, D, Elem<E>::kCode);
  const E* tq = static_cast<const E*>(q);
  const E* tk = static_cast<const E*>(k);
  const E* tv = static_cast<const E*>(v);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  cudaError_t err;
  if (which == 0) {
    auto kernel = flash_fwd_wgmma_kernel<E, D, fwd_wgmma_tile<D>()>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
    kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, sg, static_cast<E*>(out0),
                                               static_cast<float*>(out_lse), p);
    dlti_flash::last_kernel[0] = "flash_fwd_wgmma_kernel";
  } else if (which == 1) {
    auto kernel = flash_bwd_dq_wgmma_kernel<E, D, fwd_wgmma_tile<D>()>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
    kernel<<<grid, kWgThreads, smem, stream>>>(
        tq, tk, tv, static_cast<const E*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), sg, static_cast<E*>(out0), p);
    dlti_flash::last_kernel[1] = "flash_bwd_dq_wgmma_kernel";
  } else if constexpr (D <= 128) {
    auto kernel = flash_bwd_dkv_wgmma_kernel<E, D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.skv + kRows - 1) / kRows, p.batch * p.kv_heads);
    kernel<<<grid, kWgThreads, smem, stream>>>(
        tq, tk, tv, static_cast<const E*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), sg, static_cast<E*>(out0),
        static_cast<E*>(out1), p);
    dlti_flash::last_kernel[2] = "flash_bwd_dkv_wgmma_kernel";
  }
  return cudaGetLastError();
}

template <typename T> constexpr int dtype_code() {
  if constexpr (std::is_same<T, float>::value) return 0;
  else return Elem<T>::kCode;
}

// The CUDA-core programs: every kernel in float32; K3 at d 256 in bf16 and
// f16.
template <typename T, int D>
cudaError_t launch(int which, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* seg, void* out0, void* out1, void* out_lse,
                   const FlashParams& p, cudaStream_t stream) {
  constexpr int dtype = dtype_code<T>();
  if constexpr (dtype != 0) {
    if (uses_wgmma(which, D, dtype))
      return launch_wgmma<T, D>(which, q, k, v, dout, lse, delta, seg, out0, out1,
                                out_lse, p, stream);
  }
  constexpr int BK = kv_tile<D>();
  const size_t smem = smem_bytes(which, D, dtype);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  cudaError_t err;
  if (which == 0) {
    if constexpr (dtype == 0) {
      auto kernel = flash_fwd_kernel<T, D, BK>;
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
      kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, sg, static_cast<T*>(out0),
                                               static_cast<float*>(out_lse), p);
      dlti_flash::last_kernel[0] = "flash_fwd_kernel";
    }
  } else if (which == 1) {
    if constexpr (dtype == 0) {
      auto kernel = flash_bwd_dq_kernel<T, D, BK>;
      if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
      dim3 grid((p.sq + p.bq - 1) / p.bq, p.batch * p.kv_heads);
      kernel<<<grid, kThreads, smem, stream>>>(
          tq, tk, tv, static_cast<const T*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), sg, static_cast<T*>(out0), p);
      dlti_flash::last_kernel[1] = "flash_bwd_dq_kernel";
    }
  } else if constexpr (dtype == 0 || D > 128) {
    auto kernel = flash_bwd_dkv_kernel<T, D, BK>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    dim3 grid((p.skv + BK - 1) / BK, p.batch * p.kv_heads);
    kernel<<<grid, kThreads, smem, stream>>>(
        tq, tk, tv, static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), sg, static_cast<T*>(out0),
        static_cast<T*>(out1), p);
    dlti_flash::last_kernel[2] = "flash_bwd_dkv_kernel";
  }
  return cudaGetLastError();
}

// One head_dim's programs, every dtype (0 = float32, 1 = bfloat16, 2 =
// float16).
template <int D>
cudaError_t dispatch_t(int dtype, int which, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, const void* seg, void* out0, void* out1,
                       void* out_lse, const FlashParams& p, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(which, q, k, v, dout, lse, delta, seg, out0, out1,
                                    out_lse, p, s);
  if (dtype == 2)
    return launch<__half, D>(which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace dlti_flash {
#define DLTI_DISPATCH(D)                                                                  \
  cudaError_t dispatch_##D(int dtype, int which, const void* q, const void* k,            \
                           const void* v, const void* dout, const void* lse,              \
                           const void* delta, const void* seg, void* out0, void* out1,    \
                           void* out_lse, const FlashParams& p, cudaStream_t s)
DLTI_DISPATCH(64);
DLTI_DISPATCH(128);
DLTI_DISPATCH(256);
#if DLTI_IN_PART(0)
DLTI_DISPATCH(64) {
  return dispatch_t<64>(dtype, which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
}
#endif
#if DLTI_IN_PART(1)
DLTI_DISPATCH(128) {
  return dispatch_t<128>(dtype, which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
}
#endif
#if DLTI_IN_PART(2)
DLTI_DISPATCH(256) {
  return dispatch_t<256>(dtype, which, q, k, v, dout, lse, delta, seg, out0, out1, out_lse, p, s);
}
#endif
#undef DLTI_DISPATCH
}  // namespace dlti_flash

#if DLTI_IN_PART(0)
namespace {

const char* impl_name(int which, int d, int dtype) {
  if ((d != 64 && d != 128 && d != 256) || !known_dtype(dtype) || which < 0 || which > 2)
    return "";
  if (!uses_wgmma(which, d, dtype)) return "cuda-core fp32";
  return dtype == 1 ? "wgmma bf16 hi/lo, cp.async 2-stage"
                    : "wgmma f16 hi/lo, power-of-2 scaled, cp.async 2-stage";
}

// which: 0 = forward (K1), 1 = dq (K2), 2 = dk/dv (K3). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (q, k, v, dO and the outputs share it).
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
  switch (head_dim) {
    case 64:
      return (int)dlti_flash::dispatch_64(dtype, which, q, k, v, dout, lse, delta, seg,
                                          out0, out1, out_lse, p, s);
    case 128:
      return (int)dlti_flash::dispatch_128(dtype, which, q, k, v, dout, lse, delta, seg,
                                           out0, out1, out_lse, p, s);
    case 256:
      return (int)dlti_flash::dispatch_256(dtype, which, q, k, v, dout, lse, delta, seg,
                                           out0, out1, out_lse, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// Bytes of dynamic shared memory kernel `which` asks for at head_dim d and
// dtype code `dtype` (0 if not built); the wrapper checks it against the
// card's limit.
extern "C" long long dlti_flash_smem_bytes(int which, int head_dim, int dtype) {
  return (long long)smem_bytes(which, head_dim, dtype);
}

// Which program runs kernel `which` at head_dim d and dtype code `dtype`:
// "wgmma bf16 hi/lo, cp.async 2-stage", "wgmma f16 hi/lo, power-of-2 scaled,
// cp.async 2-stage" or "cuda-core fp32" ("" if not built).
extern "C" const char* dlti_flash_impl(int which, int head_dim, int dtype) {
  return impl_name(which, head_dim, dtype);
}

// The function name of the kernel entry point `which` launched last ("" before
// its first launch).
extern "C" const char* dlti_flash_last_kernel(int which) {
  return (which >= 0 && which < 3) ? dlti_flash::last_kernel[which] : "";
}

extern "C" const char* dlti_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // DLTI_IN_PART(0)
