// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the gradients of two TPU kernels of
// mxnet_tpu/ops/pallas/attention.py:
//   _blockwise_bwd   the custom VJP of _flash_attention_dense (B2), and
//   the VJP of _masked_reference, through which _masked_attention (B3) is
//   differentiated.
// Given q, k, v, the forward's output o and its cotangent dO, all
// (B, H, S, D), it computes dq, dk and dv with the recurrence of
// _blockwise_bwd: lse = m + log(max(l, 1e-30)) over the scores of
// q * scale, delta = rowsum(dO * O), P = exp(S - lse) where the mask
// attends and 0 elsewhere, dP = dO V^T, dS = P * (dP - delta) * scale,
// dV = P^T dO, dK = dS^T q (the unscaled q), dQ = dS K; sums in fp32, each
// gradient written once in its input's dtype. The masks are the forward's
// (csrc/flash_attention.cu): the causal diagonal at kpos <= qpos + (Sk -
// Sq), per-batch key lengths (kpos < len), packed segment ids (seg_q ==
// seg_k and seg_q > 0). A query row that sees no key gets P = 0 on every
// key, so its dq is exact 0 and it adds nothing to dk or dv; for the
// masked core delta = rowsum(dO * O) equals the VJP's rowsum(P * dP).
//
// Three launches on one stream, no atomics (so the result does not depend
// on the order blocks run in):
// - K0 (prep): a block per (batch*head, 64 query rows) recomputes the
//   row's lse over the K tiles it can see, as _blockwise_bwd's first pass
//   does (so the forward kernels stay as they are), and delta; both fp32,
//   (B, H, Sq);
// - K1 (dK, dV): a block per (batch*head, 64 keys) walks the query tiles
//   that can see its keys, recomputes S and P, and sums dV and dK;
// - K2 (dQ): a block per (batch*head, 64 query rows) walks the K tiles
//   its rows can see and sums dQ.
// K tiles wholly past a batch element's length, or wholly above the
// causal diagonal, are skipped (K1 writes zeros for keys past the
// length).
//
// Bound. One backward must read q, k, v, o and dO once and write dq, dk
// and dv once, and do 4 products of 2*D operations for every (query, key)
// pair the mask keeps alive (S, dP, dV, dK and dQ are five; _blockwise_bwd
// recomputes S in its first pass as well, which the bound does not
// credit). At the transformer's shapes (B=4, H=8, S=2048, D=64, causal,
// bf16, 67.1 M live pairs) that is 10*D*pairs = 43.0 GFLOP, 43.4 us at
// the 989 TFLOP/s bf16 tensor-core peak, against 67 MB (20 us at 3.35
// TB/s): operations bound it.
//
// Two variants, both with strides as arguments (the transformer's v and
// dO are (B, H, S, D) views of (B, S, H, D) memory):
// - the tensor-core variant (bf16, D = 64 or 128, 16-byte aligned rows):
//   4 warps of 16 rows (K0, K2: query rows; K1: keys), each product an
//   mma.sync m16n8k16 (bf16 inputs, fp32 sums) from fragments read by
//   ldmatrix, P and dS rounded to bf16 as the A operand of the dV, dK and
//   dQ products; the walked tiles double buffered by cp.async. The
//   tensor cores wait while the softmax runs, as in the forward's mma.sync
//   variant: wgmma, TMA and warp specialisation are later work;
// - the CUDA-core variant (fp32, other D up to 128, unaligned views):
//   8 warps of 8 rows, the tiles staged as fp32 in shared memory, a lane
//   scoring 2 keys (or 2 queries) with fp32 FMAs, P and dS through shared
//   memory, a lane summing D/32 columns of the gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // rows (or keys) a block owns
constexpr int kThreads = 256;    // CUDA-core variant: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kTile / kWarps;  // rows of a warp
constexpr int kMmaThreads = 128;       // tensor-core variant: 4 warps of 16
constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;           // (B, H, Sq) contiguous, natural log
  float* delta;         // (B, H, Sq) contiguous
  const int* lengths;   // (B,) key lengths, or null
  const int* seg;       // (B, S) segment ids, contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, H, Sq, Sk, D;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The keys batch element b can see at all: min(max(length, 0), Sk).
__device__ __forceinline__ int key_limit(const Params& p, int b) {
  if (p.lengths == nullptr) return p.Sk;
  return min(max(p.lengths[b], 0), p.Sk);
}

// Whether query row `row` attends to key `key` (`len` from key_limit,
// `seg` the batch element's ids or null): in bounds, on or below the
// causal diagonal, before the key length, in the same nonzero segment.
__device__ __forceinline__ bool attends(const Params& p, int row, int key,
                                        int len, const int* seg) {
  if (row >= p.Sq || key >= len) return false;
  if (p.causal && key > row + (p.Sk - p.Sq)) return false;
  if (seg != nullptr) {
    const int s = __ldg(seg + row);
    return s > 0 && __ldg(seg + key) == s;
  }
  return true;
}

// The keys query rows [r0, r1) can see: none past the length, none above
// the diagonal of the last row.
__device__ __forceinline__ int keys_seen(const Params& p, int len, int r1) {
  int n = len;
  if (p.causal) n = min(n, min(r1, p.Sq) - 1 + (p.Sk - p.Sq) + 1);
  return max(n, 0);
}

// The first query row that can see key `k0` (causal), else 0.
__device__ __forceinline__ int first_row(const Params& p, int k0) {
  return p.causal ? max(0, k0 - (p.Sk - p.Sq)) : 0;
}

// delta = rowsum(dO * O) in fp32 for rows [r0, r0 + n) of (b, h), a warp
// a row.
template <typename T>
__device__ void write_delta(const Params& p, int b, int h, int r0, int n,
                            int warp, int nwarps, int lane) {
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  for (int r = warp; r < n; r += nwarps) {
    const int row = r0 + r;
    if (row >= p.Sq) break;
    float acc = 0.f;
    for (int d = lane; d < p.D; d += 32) {
      acc += to_float(o[row * p.o_ss + d]) * to_float(dout[row * p.do_ss + d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) delta[row] = acc;
  }
}

// Zeros into rows [r0, r1) of a (B, H, S, D) gradient of batch*head bh.
template <typename T>
__device__ void zero_rows(T* base, long long ss, int r0, int r1, int D,
                          int tid, int nthreads) {
  for (int i = tid; i < (r1 - r0) * D; i += nthreads) {
    base[(r0 + i / D) * ss + i % D] = from_float<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// The CUDA-core variant. Tiles in shared memory as fp32 with a row stride
// of D rounded up to 4 (zero padded), so rows are read as float4; the
// tiles a lane reads by its own row get 4 more floats, so that the 8
// lanes of a quarter warp reading one float4 column hit distinct banks.

__host__ __device__ inline int row_stride(int d) { return (d + 3) & ~3; }

// fp32 copy of rows [r0, r0 + kTile) of a (S, D) slice with row stride ss
// into a [kTile][ld] tile, times `mul`; zeros past `limit` rows and D.
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long ss, int r0,
                      int limit, int D, float mul, int tid) {
  for (int i = tid; i < kTile * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    dst[i] = (r0 + r < limit && c < D) ? to_float(src[(r0 + r) * ss + c]) * mul
                                       : 0.f;
  }
}

size_t prep_shared_bytes(int d) {
  const int ld = row_stride(d);
  return sizeof(float) * kTile * (2 * ld + 4);
}

size_t dq_shared_bytes(int d) {
  const int ld = row_stride(d);
  return sizeof(float) * kTile * (2 * ld + 2 * (ld + 4) + kTile);
}

size_t dkdv_shared_bytes(int d) {
  const int ld = row_stride(d);
  return sizeof(float) * kTile * (2 * ld + 2 * (ld + 4) + 2 * kTile + 2);
}

// K0: lse and delta of 64 query rows; a lane scores keys lane, lane + 32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prep_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = row_stride(D);
  const int ldk = ldq + 4;
  float* q_s = smem;                 // [kTile][ldq], times scale
  float* k_s = q_s + kTile * ldq;    // [kTile][ldk]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRows;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + kTile) + kTile - 1) / kTile;

  stage(q_s, ldq, q, p.q_ss, q0, p.Sq, D, p.scale, tid);
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage(k_s, ldk, k, p.k_ss, k0, p.Sk, D, 1.f, tid);
    __syncthreads();
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = k_s + lane * ldk;
    const float* kb = k_s + (lane + 32) * ldk;
    for (int c = 0; c < ldq; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ka + c);
      const float4 bb = *reinterpret_cast<const float4*>(kb + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * ldq + c);
        s[r][0] += qv.x * a.x + qv.y * a.y + qv.z * a.z + qv.w * a.w;
        s[r][1] += qv.x * bb.x + qv.y * bb.y + qv.z * bb.z + qv.w * bb.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
      const bool la = attends(p, row, k0 + lane, len, seg);
      const bool lb = attends(p, row, k0 + lane + 32, len, seg);
      const float mx =
          warp_max(fmaxf(la ? s[r][0] : kNeg, lb ? s[r][1] : kNeg));
      const float m_new = fmaxf(m[r], mx);
      // p is zeroed where the mask is false: while every key so far is
      // masked, m_new == kNeg and exp(s - m_new) would be 1
      const float pa = la ? expf(s[r][0] - m_new) : 0.f;
      const float pb = lb ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(pa + pb);
      m[r] = m_new;
    }
  }
  float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (lane == 0 && row < p.Sq) lse[row] = m[r] + logf(fmaxf(l[r], 1e-30f));
  }
  write_delta<T>(p, b, h, q0, kTile, warp, kWarps, lane);
}

// K2: dq of 64 query rows. A lane scores keys lane, lane + 32 for the
// warp's 8 rows (S and dP), writes dS to shared memory, then sums
// dq[row][d] over the tile's keys for d = lane + 32 c.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = row_stride(D);
  const int ldk = ldq + 4;
  float* q_s = smem;                  // [kTile][ldq], times scale
  float* do_s = q_s + kTile * ldq;    // [kTile][ldq]
  float* k_s = do_s + kTile * ldq;    // [kTile][ldk]
  float* v_s = k_s + kTile * ldk;     // [kTile][ldk]
  float* ds_s = v_s + kTile * ldk;    // [kTile][kTile]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRows;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + kTile) + kTile - 1) / kTile;

  stage(q_s, ldq, q, p.q_ss, q0, p.Sq, D, p.scale, tid);
  stage(do_s, ldq, dout, p.do_ss, q0, p.Sq, D, 1.f, tid);
  float lse_r[kRows], delta_r[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    lse_r[r] = row < p.Sq ? lse[row] : 0.f;
    delta_r[r] = row < p.Sq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  float* ds_w = ds_s + r0 * kTile;  // this warp's rows of dS

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage(k_s, ldk, k, p.k_ss, k0, p.Sk, D, 1.f, tid);
    stage(v_s, ldk, v, p.v_ss, k0, p.Sk, D, 1.f, tid);
    __syncthreads();
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int c = 0; c < ldq; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_s + lane * ldk + c);
      const float4 kb =
          *reinterpret_cast<const float4*>(k_s + (lane + 32) * ldk + c);
      const float4 va = *reinterpret_cast<const float4*>(v_s + lane * ldk + c);
      const float4 vb =
          *reinterpret_cast<const float4*>(v_s + (lane + 32) * ldk + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * ldq + c);
        const float4 dv =
            *reinterpret_cast<const float4*>(do_s + (r0 + r) * ldq + c);
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kb.x + qv.y * kb.y + qv.z * kb.z + qv.w * kb.w;
        dp[r][0] += dv.x * va.x + dv.y * va.y + dv.z * va.z + dv.w * va.w;
        dp[r][1] += dv.x * vb.x + dv.y * vb.y + dv.z * vb.z + dv.w * vb.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool live = attends(p, row, k0 + lane + 32 * j, len, seg);
        const float pv = live ? expf(s[r][j] - lse_r[r]) : 0.f;
        ds_w[r * kTile + lane + 32 * j] = pv * (dp[r][j] - delta_r[r]) * p.scale;
      }
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          kk[jj][c] = d < D ? k_s[(j + jj) * ldk + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 dsv =
            *reinterpret_cast<const float4*>(ds_w + r * kTile + j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[r][c] += dsv.x * kk[0][c] + dsv.y * kk[1][c] + dsv.z * kk[2][c] +
                       dsv.w * kk[3][c];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[row * p.dq_ss + d] = from_float<T>(acc[r][c]);
    }
  }
}

// K1: dk and dv of 64 keys. A lane scores queries lane, lane + 32 for the
// warp's 8 keys (S^T and dP^T), writes P^T and dS^T to shared memory, then
// sums dv[key][d] and dk[key][d] over the tile's queries for
// d = lane + 32 c.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldk = row_stride(D);   // the block's own keys: read broadcast
  const int ldq = ldk + 4;         // the walked query tiles: a row a lane
  float* k_s = smem;                  // [kTile][ldk]
  float* v_s = k_s + kTile * ldk;     // [kTile][ldk]
  float* q_s = v_s + kTile * ldk;     // [kTile][ldq], unscaled
  float* do_s = q_s + kTile * ldq;    // [kTile][ldq]
  float* p_s = do_s + kTile * ldq;    // [kTile keys][kTile queries]
  float* ds_s = p_s + kTile * kTile;  // [kTile keys][kTile queries]
  float* lse_s = ds_s + kTile * kTile;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;  // the most work first (causal)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRows;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  const int k1 = min(k0 + kTile, p.Sk);
  if (k0 >= len) {  // no query sees these keys
    zero_rows(dk, p.dk_ss, k0, k1, D, tid, kThreads);
    zero_rows(dv, p.dv_ss, k0, k1, D, tid, kThreads);
    return;
  }
  stage(k_s, ldk, k, p.k_ss, k0, p.Sk, D, 1.f, tid);
  stage(v_s, ldk, v, p.v_ss, k0, p.Sk, D, 1.f, tid);
  float acc_k[kRows][DC], acc_v[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  float* p_w = p_s + r0 * kTile;
  float* ds_w = ds_s + r0 * kTile;

  for (int qt = first_row(p, k0) / kTile; qt * kTile < p.Sq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage(q_s, ldq, q, p.q_ss, q0, p.Sq, D, 1.f, tid);
    stage(do_s, ldq, dout, p.do_ss, q0, p.Sq, D, 1.f, tid);
    for (int i = tid; i < kTile; i += kThreads) {
      lse_s[i] = q0 + i < p.Sq ? lse[q0 + i] : 0.f;
      delta_s[i] = q0 + i < p.Sq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();
    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    for (int c = 0; c < ldk; c += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + lane * ldq + c);
      const float4 qb =
          *reinterpret_cast<const float4*>(q_s + (lane + 32) * ldq + c);
      const float4 da = *reinterpret_cast<const float4*>(do_s + lane * ldq + c);
      const float4 db =
          *reinterpret_cast<const float4*>(do_s + (lane + 32) * ldq + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (r0 + r) * ldk + c);
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + (r0 + r) * ldk + c);
        s[r][0] += kv.x * qa.x + kv.y * qa.y + kv.z * qa.z + kv.w * qa.w;
        s[r][1] += kv.x * qb.x + kv.y * qb.y + kv.z * qb.z + kv.w * qb.w;
        dp[r][0] += vv.x * da.x + vv.y * da.y + vv.z * da.z + vv.w * da.w;
        dp[r][1] += vv.x * db.x + vv.y * db.y + vv.z * db.z + vv.w * db.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 32 * j;
        const bool live = attends(p, q0 + col, key, len, seg);
        const float pv = live ? expf(s[r][j] * p.scale - lse_s[col]) : 0.f;
        p_w[r * kTile + col] = pv;
        ds_w[r * kTile + col] = pv * (dp[r][j] - delta_s[col]) * p.scale;
      }
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float qq[4][DC], dd[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          qq[jj][c] = d < D ? q_s[(j + jj) * ldq + d] : 0.f;
          dd[jj][c] = d < D ? do_s[(j + jj) * ldq + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + r * kTile + j);
        const float4 dsv =
            *reinterpret_cast<const float4*>(ds_w + r * kTile + j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[r][c] += pv.x * dd[0][c] + pv.y * dd[1][c] + pv.z * dd[2][c] +
                         pv.w * dd[3][c];
          acc_k[r][c] += dsv.x * qq[0][c] + dsv.y * qq[1][c] +
                         dsv.z * qq[2][c] + dsv.w * qq[3][c];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + r0 + r;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[key * p.dk_ss + d] = from_float<T>(acc_k[r][c]);
        dv[key * p.dv_ss + d] = from_float<T>(acc_v[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core variant: bf16, D = 64 or 128, 16-byte aligned rows.
// Tiles in shared memory as bf16 with rows padded by 16 bytes, so that
// ldmatrix's 8 row addresses fall in distinct banks. A warp owns 16 rows
// of the block's tile; the walked tiles hold NT rows (64 at D = 64, 32 at
// D = 128, which keeps K1's two D-wide sums in registers).
//
// Fragments of mma.sync m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
// a3 = (g + 8, 2t + 8..); B (16 x 8, column-major) b0 = (2t..2t+1, g),
// b1 = (2t + 8.., g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 =
// (g + 8, 2t..). Two products shapes serve every product of the backward:
// - mma_nt: C (16 x NT) += A (16 x D) * M^T for an NT x D tile M stored
//   row-major (S = Q K^T, dP = dO V^T; in K1 S^T = K Q^T, dP^T = V dO^T);
// - mma_pv: C (16 x D) += A (16 x NT, the fp32 C fragments of an mma_nt
//   rounded to bf16) * M for an NT x D tile M stored row-major (dQ = dS K;
//   in K1 dV = P^T dO, dK = dS^T Q).

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;                 // tile row stride
  static constexpr int NT = D == 128 ? 32 : 64;    // rows of a walked tile
  static constexpr int NN = NT / 8;                // 8-wide C tiles of a row
  static constexpr int ND = D / 8;                 // 8-wide C tiles of D
  static constexpr int V8 = D / 8;                 // 16-byte vectors a row
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when !valid (the source address must still be a valid one).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + rows) of a (S, D) bf16 slice into a [rows][LD] tile by
// cp.async; zeros past `limit`
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int rows,
                                          int limit, int tid) {
  constexpr int LD = MmaTile<D>::LD, V8 = MmaTile<D>::V8;
  for (int i = tid; i < rows * V8; i += kMmaThreads) {
    const int r = i / V8, c = (i % V8) * 8;
    const bool in = r0 + r < limit;
    cp_async_16(dst + r * LD + c, src + (in ? r0 + r : 0) * ss + c, in);
  }
}

// A fragment of 16-wide chunk kc of 16 tile rows starting at `rows`
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows,
                                       int kc, int g, int t) {
  const bf16* base = rows + g * LD + kc * 16 + 2 * t;
  a[0] = ld_pair(base);
  a[1] = ld_pair(base + 8 * LD);
  a[2] = ld_pair(base + 8);
  a[3] = ld_pair(base + 8 * LD + 8);
}

// c += A * M^T: A the 16 rows at `a_rows`, M the NN * 8 rows at `m`
template <int D, int NN>
__device__ __forceinline__ void mma_nt(float (&c)[NN][4], const bf16* a_rows,
                                       const bf16* m, int lane) {
  constexpr int LD = MmaTile<D>::LD;
  const int g = lane / 4, t = lane % 4, lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; kc += 2) {
    uint32_t a0[4], a1[4];
    load_a<LD>(a0, a_rows, kc, g, t);
    load_a<LD>(a1, a_rows, kc + 1, g, t);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t f[4];  // B fragments of chunks kc and kc + 1
      ldmatrix_x4(f, m + (n * 8 + lr) * LD + kc * 16 + lm * 8);
      mma_16816(c[n], a0, f[0], f[1]);
      mma_16816(c[n], a1, f[2], f[3]);
    }
  }
}

// acc += A * M: A the C fragments `x` (16 x NN * 8) rounded to bf16, M the
// NN * 8 rows at `m`
template <int D, int NN>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&x)[NN][4], const bf16* m,
                                       int lane) {
  constexpr int LD = MmaTile<D>::LD;
  const int lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int j = 0; j < NN / 2; ++j) {
    const uint32_t a[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                           pack_bf16(x[2 * j][2], x[2 * j][3]),
                           pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t f[4];  // B fragments of column tiles nd and nd + 1
      ldmatrix_x4_trans(f, m + (j * 16 + lr + 8 * (lm & 1)) * LD +
                               (nd + lm / 2) * 8);
      mma_16816(acc[nd], a, f[0], f[1]);
      mma_16816(acc[nd + 1], a, f[2], f[3]);
    }
  }
}

// the 16 x D C fragments `acc` into rows r, r + 8 (r = row0 + g) of a
// (S, D) bf16 slice with row stride ss; rows at or past `limit` skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss,
                                           const float (&acc)[D / 8][4],
                                           int row0, int limit, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 + g < limit) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + g) * ss + col) =
          __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
    }
    if (row0 + g + 8 < limit) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (row0 + g + 8) * ss + col) =
          __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
    }
  }
}

template <int D>
constexpr size_t mma_prep_shared_bytes() {
  using Tl = MmaTile<D>;
  return sizeof(bf16) * (kTile + 2 * Tl::NT) * Tl::LD;
}

template <int D>
constexpr size_t mma_dq_shared_bytes() {
  using Tl = MmaTile<D>;
  return sizeof(bf16) * (2 * kTile + 4 * Tl::NT) * Tl::LD;
}

template <int D>
constexpr size_t mma_dkdv_shared_bytes() {
  using Tl = MmaTile<D>;
  return sizeof(bf16) * (2 * kTile + 4 * Tl::NT) * Tl::LD +
         sizeof(float) * 4 * Tl::NT;
}

// K0, tensor-core variant: S = Q K^T a K tile at a time and the online
// max and sum in log2 units (exp2), as the forward's mma.sync variant.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_prep_mma_kernel(const Params p) {
  using Tl = MmaTile<D>;
  constexpr int LD = Tl::LD, NT = Tl::NT, NN = Tl::NN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* k_s = q_s + kTile * LD;                   // [2][NT][LD]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + kTile) + NT - 1) / NT;

  load_rows<D>(q_s, q, p.q_ss, q0, kTile, p.Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<D>(k_s, k, p.k_ss, 0, NT, p.Sk, tid);
    cp_async_commit();
  }
  const int row_a = q0 + wr + g, row_b = row_a + 8;
  const float scale_log2 = p.scale * kLog2e;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;  // l: this lane's part

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * NT;
    if (kt + 1 < n_tiles) {
      load_rows<D>(k_s + (buf ^ 1) * NT * LD, k, p.k_ss, k0 + NT, NT, p.Sk,
                   tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!p.causal || k0 <= q0 + wr + 15 + (p.Sk - p.Sq)) {
      float s[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      mma_nt<D, NN>(s, q_s + wr * LD, k_s + buf * NT * LD, lane);
      // no score of the warp's rows in this tile is masked
      const bool full = seg == nullptr && k0 + NT <= len &&
                        q0 + wr + 16 <= p.Sq &&
                        (!p.causal || k0 + NT - 1 <= q0 + wr + (p.Sk - p.Sq));
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const bool ok = full || attends(p, e < 2 ? row_a : row_b, key, len,
                                          seg);
          s[n][e] = ok ? s[n][e] * scale_log2 : kNeg;
          if (e < 2) {
            mx_a = fmaxf(mx_a, s[n][e]);
          } else {
            mx_b = fmaxf(mx_b, s[n][e]);
          }
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        // masked scores are exactly kNeg; p is zeroed there (see K0's
        // CUDA-core variant)
        sum_a += (s[n][0] > kNeg ? exp2f(s[n][0] - mn_a) : 0.f) +
                 (s[n][1] > kNeg ? exp2f(s[n][1] - mn_a) : 0.f);
        sum_b += (s[n][2] > kNeg ? exp2f(s[n][2] - mn_b) : 0.f) +
                 (s[n][3] > kNeg ? exp2f(s[n][3] - mn_b) : 0.f);
      }
      l_a = l_a * exp2f(m_a - mn_a) + sum_a;
      l_b = l_b * exp2f(m_b - mn_b) + sum_b;
      m_a = mn_a;
      m_b = mn_b;
    }
    __syncthreads();  // every warp is done with buffer buf before its reload
  }
  cp_async_wait<0>();
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  if (t == 0 && row_a < p.Sq) lse[row_a] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
  if (t == 0 && row_b < p.Sq) lse[row_b] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
  write_delta<bf16>(p, b, h, q0, kTile, warp, kMmaThreads / 32, lane);
}

// K2, tensor-core variant: a warp's 16 query rows against NT-key tiles:
// S = Q K^T, dP = dO V^T, P and dS in registers, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const Params p) {
  using Tl = MmaTile<D>;
  constexpr int LD = Tl::LD, NT = Tl::NT, NN = Tl::NN, ND = Tl::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* do_s = q_s + kTile * LD;                  // [kTile][LD]
  bf16* k_s = do_s + kTile * LD;                  // [2][NT][LD]
  bf16* v_s = k_s + 2 * NT * LD;                  // [2][NT][LD]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + kTile) + NT - 1) / NT;

  const auto load_kv = [&](int kt, int buf) {
    load_rows<D>(k_s + buf * NT * LD, k, p.k_ss, kt * NT, NT, p.Sk, tid);
    load_rows<D>(v_s + buf * NT * LD, v, p.v_ss, kt * NT, NT, p.Sk, tid);
    cp_async_commit();
  };
  load_rows<D>(q_s, q, p.q_ss, q0, kTile, p.Sq, tid);
  load_rows<D>(do_s, dout, p.do_ss, q0, kTile, p.Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);

  const int row_a = q0 + wr + g, row_b = row_a + 8;
  const float lse_a = row_a < p.Sq ? lse[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < p.Sq ? lse[row_b] * kLog2e : 0.f;
  const float delta_a = row_a < p.Sq ? delta[row_a] : 0.f;
  const float delta_b = row_b < p.Sq ? delta[row_b] : 0.f;
  const float scale_log2 = p.scale * kLog2e;
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * NT;
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!p.causal || k0 <= q0 + wr + 15 + (p.Sk - p.Sq)) {
      const bf16* kb = k_s + buf * NT * LD;
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_nt<D, NN>(s, q_s + wr * LD, kb, lane);
      mma_nt<D, NN>(dp, do_s + wr * LD, v_s + buf * NT * LD, lane);
      const bool full = seg == nullptr && k0 + NT <= len &&
                        q0 + wr + 16 <= p.Sq &&
                        (!p.causal || k0 + NT - 1 <= q0 + wr + (p.Sk - p.Sq));
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const bool ok = full || attends(p, e < 2 ? row_a : row_b, key, len,
                                          seg);
          const float pv =
              ok ? exp2f(s[n][e] * scale_log2 - (e < 2 ? lse_a : lse_b)) : 0.f;
          dp[n][e] = pv * (dp[n][e] - (e < 2 ? delta_a : delta_b)) * p.scale;
        }
      }
      mma_pv<D, NN>(acc, dp, kb, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<D>(dq, p.dq_ss, acc, q0 + wr, p.Sq, lane);
}

// K1, tensor-core variant: a warp's 16 keys against NT-row query tiles:
// S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers, dV += P^T dO,
// dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_mma_kernel(const Params p) {
  using Tl = MmaTile<D>;
  constexpr int LD = Tl::LD, NT = Tl::NT, NN = Tl::NN, ND = Tl::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* v_s = k_s + kTile * LD;                   // [kTile][LD]
  bf16* q_s = v_s + kTile * LD;                   // [2][NT][LD]
  bf16* do_s = q_s + 2 * NT * LD;                 // [2][NT][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * NT * LD);  // [2][NT]
  float* delta_s = lse_s + 2 * NT;                              // [2][NT]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;  // the most work first (causal)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  bf16* dk = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dv = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  if (k0 >= len) {  // no query sees these keys
    const int k1 = min(k0 + kTile, p.Sk);
    zero_rows(dk, p.dk_ss, k0, k1, D, tid, kMmaThreads);
    zero_rows(dv, p.dv_ss, k0, k1, D, tid, kMmaThreads);
    return;
  }
  const int qt0 = first_row(p, k0) / NT;
  const int n_qt = (p.Sq + NT - 1) / NT;

  const auto load_q = [&](int qt, int buf) {
    const int r0 = qt * NT;
    load_rows<D>(q_s + buf * NT * LD, q, p.q_ss, r0, NT, p.Sq, tid);
    load_rows<D>(do_s + buf * NT * LD, dout, p.do_ss, r0, NT, p.Sq, tid);
    for (int i = tid; i < NT; i += kMmaThreads) {
      const bool in = r0 + i < p.Sq;
      lse_s[buf * NT + i] = in ? lse[r0 + i] * kLog2e : 0.f;
      delta_s[buf * NT + i] = in ? delta[r0 + i] : 0.f;
    }
    cp_async_commit();
  };
  load_rows<D>(k_s, k, p.k_ss, k0, kTile, p.Sk, tid);
  load_rows<D>(v_s, v, p.v_ss, k0, kTile, p.Sk, tid);
  cp_async_commit();
  load_q(qt0, 0);

  const int key_a = k0 + wr + g, key_b = key_a + 8;
  const float scale_log2 = p.scale * kLog2e;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    const int q0 = qt * NT;
    if (qt + 1 < n_qt) {
      load_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // some row of the tile sees the warp's first key
    if (!p.causal || k0 + wr <= q0 + NT - 1 + (p.Sk - p.Sq)) {
      const bf16* qb = q_s + buf * NT * LD;
      const bf16* db = do_s + buf * NT * LD;
      const float* lse_t = lse_s + buf * NT;
      const float* delta_t = delta_s + buf * NT;
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_nt<D, NN>(s, k_s + wr * LD, qb, lane);   // S^T
      mma_nt<D, NN>(dp, v_s + wr * LD, db, lane);  // dP^T
      const bool full = seg == nullptr && k0 + wr + 16 <= len &&
                        q0 + NT <= p.Sq &&
                        (!p.causal || k0 + wr + 15 <= q0 + (p.Sk - p.Sq));
#pragma unroll
      for (int n = 0; n < NN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const bool ok = full || attends(p, q0 + col, e < 2 ? key_a : key_b,
                                          len, seg);
          const float pv = ok ? exp2f(s[n][e] * scale_log2 - lse_t[col]) : 0.f;
          s[n][e] = pv;
          dp[n][e] = pv * (dp[n][e] - delta_t[col]) * p.scale;
        }
      }
      mma_pv<D, NN>(acc_v, s, db, lane);   // dV += P^T dO
      mma_pv<D, NN>(acc_k, dp, qb, lane);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with buffer buf before its reload
  }
  cp_async_wait<0>();
  store_rows<D>(dk, p.dk_ss, acc_k, k0 + wr, p.Sk, lane);
  store_rows<D>(dv, p.dv_ss, acc_v, k0 + wr, p.Sk, lane);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int tiles, int threads,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(tiles, p.B * p.H), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int q_tiles(const Params& p) { return (p.Sq + kTile - 1) / kTile; }
int k_tiles(const Params& p) { return (p.Sk + kTile - 1) / kTile; }

template <int D>
int run_mma(const Params& p, cudaStream_t s) {
  int err = launch(flash_bwd_prep_mma_kernel<D>, p, q_tiles(p), kMmaThreads,
                   mma_prep_shared_bytes<D>(), s);
  if (err == 0) {
    err = launch(flash_bwd_dkdv_mma_kernel<D>, p, k_tiles(p), kMmaThreads,
                 mma_dkdv_shared_bytes<D>(), s);
  }
  if (err == 0) {
    err = launch(flash_bwd_dq_mma_kernel<D>, p, q_tiles(p), kMmaThreads,
                 mma_dq_shared_bytes<D>(), s);
  }
  return err;
}

template <typename T, int DC>
int run_scalar(const Params& p, cudaStream_t s) {
  int err = launch(flash_bwd_prep_kernel<T>, p, q_tiles(p), kThreads,
                   prep_shared_bytes(p.D), s);
  if (err == 0) {
    err = launch(flash_bwd_dkdv_kernel<T, DC>, p, k_tiles(p), kThreads,
                 dkdv_shared_bytes(p.D), s);
  }
  if (err == 0) {
    err = launch(flash_bwd_dq_kernel<T, DC>, p, q_tiles(p), kThreads,
                 dq_shared_bytes(p.D), s);
  }
  return err;
}

template <typename T>
int run_scalar_d(const Params& p, cudaStream_t s) {
  return p.D <= 64 ? run_scalar<T, 2>(p, s) : run_scalar<T, 4>(p, s);
}

// The tensor-core variant reads q, k, v and dO in 16-byte vectors and
// writes the gradients in 4-byte pairs: every row must start on such a
// boundary.
bool mma_aligned(const Params& p) {
  const auto a16 = [](const void* ptr, long long sb, long long sh,
                      long long ss) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
           sh % 8 == 0 && ss % 8 == 0;
  };
  const auto a4 = [](const void* ptr, long long sb, long long sh,
                     long long ss) {
    return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && sb % 2 == 0 &&
           sh % 2 == 0 && ss % 2 == 0;
  };
  return a16(p.q, p.q_sb, p.q_sh, p.q_ss) && a16(p.k, p.k_sb, p.k_sh, p.k_ss) &&
         a16(p.v, p.v_sb, p.v_sh, p.v_ss) &&
         a16(p.dout, p.do_sb, p.do_sh, p.do_ss) &&
         a4(p.dq, p.dq_sb, p.dq_sh, p.dq_ss) &&
         a4(p.dk, p.dk_sb, p.dk_sh, p.dk_ss) &&
         a4(p.dv, p.dv_sb, p.dv_sh, p.dv_ss);
}

}  // namespace

extern "C" {

// strides: 24 element strides (batch, head, row) of q, k, v, o, dout, dq,
// dk and dv; the head dim of each is contiguous. lse and delta: (B, H, Sq)
// fp32 scratch on the card, written by the first launch and read by the
// other two. lengths (B,) and segment_ids (B, Sk) are int32 on the card,
// or null. dtype: 0 = float32, 1 = bfloat16. *variant is set to the
// variant launched: 0 the CUDA-core one, 1 mma.sync. Returns the
// cudaError_t of the first launch that failed, or 0.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, void* lse, void* delta,
                             const void* lengths, const void* segment_ids,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, float scale, int causal, int dtype,
                             int* variant, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      B * H > 65535 || (segment_ids != nullptr && Sq != Sk) || dtype < 0 ||
      dtype > 1 || (causal != 0 && Sq > Sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout;
  p.dq = dq, p.dk = dk, p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.lengths = static_cast<const int*>(lengths);
  p.seg = static_cast<const int*>(segment_ids);
  long long* dst[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,
                        &p.k_ss,  &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,
                        &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                        &p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                        &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.D = D;
  p.causal = causal != 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128) && mma_aligned(p)) {
    *variant = 1;
    return D == 64 ? run_mma<64>(p, s) : run_mma<128>(p, s);
  }
  *variant = 0;
  return dtype == 0 ? run_scalar_d<float>(p, s) : run_scalar_d<bf16>(p, s);
}

const char* flash_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
