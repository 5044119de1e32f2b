// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the gradients of two TPU kernels of
// mxnet_tpu/ops/pallas/attention.py:
//   _blockwise_bwd   the custom VJP of _flash_attention_dense (B2), and
//   the VJP of _masked_reference, through which _masked_attention (B3) is
//   differentiated.
// Given q, k, v, the forward's output o, its row logsumexps lse and the
// cotangent dO, all (B, H, S, D) but lse (B, H, S), it computes dq, dk
// and dv with the recurrence of _blockwise_bwd: lse = m + log(max(l,
// 1e-30)) over the scores of q * scale (kept by the forward kernel, where
// _blockwise_bwd recomputes it), delta = rowsum(dO * O), P = exp(S - lse)
// where the mask attends and 0 elsewhere, dP = dO V^T, dS = P * (dP -
// delta) * scale, dV = P^T dO, dK = dS^T q (the unscaled q), dQ = dS K;
// sums in fp32, each gradient written once in its input's dtype. The
// masks are the forward's (csrc/flash_attention.cu): the causal diagonal
// at kpos <= qpos + (Sk - Sq), per-batch key lengths (kpos < len), packed
// segment ids (seg_q == seg_k and seg_q > 0). A query row that sees no
// key gets P = 0 on every key, so its dq is exact 0 and it adds nothing to
// dk or dv, whatever its lse; for the masked core delta = rowsum(dO * O)
// equals the VJP's rowsum(P * dP).
//
// Bound. One backward must read q, k, v, o and dO once and write dq, dk
// and dv once, and do 5 products of 2*D operations for every (query, key)
// pair the mask keeps alive (S, dP, dV, dK and dQ; _blockwise_bwd
// recomputes S in its first pass as well, which the bound does not
// credit, and which the forward's lse spares this library). At the
// transformer's shapes (B=4, H=8, S=2048, D=64, causal, bf16, 67.1 M live
// pairs) that is 10*D*pairs = 43.0 GFLOP, 43.4 us at the 989 TFLOP/s bf16
// tensor-core peak, against 67 MB (20 us at 3.35
// TB/s): operations bound it, so the products must run on wgmma, fed by
// TMA, with the softmax's exp2 and the dQ sums hidden behind them.
//
// Three variants, all with strides as arguments (the transformer's v and
// dO are (B, H, S, D) views of (B, S, H, D) memory), chosen before the
// launch by dtype, D and alignment. The tensor-core ones take bf16 and
// fp16 (one template over the element type; P and dS rounded to it for
// their products, as the forward rounds P):
// - the Hopper variant (flash_bwd_wgmma_kernel and its two passes), taken
//   for bf16 or fp16 at D = 64 or 128 when TMA can describe q, k, v and dO and the
//   forward's lse is at hand: one TMA + wgmma kernel a block per 128 keys
//   (64 at D = 128) that keeps its K and V tiles in shared memory, walks
//   the query tiles that see them, writes dK and dV once and adds dQ's
//   partial sums into an fp32 accumulator by TMA bulk reduce-adds; its
//   design is set out above the kernel. Not deterministic in dq's last
//   bits (the reduce-adds arrive in any order);
// - the mma.sync variant (the first design: K0 delta, K1 dK dV, K2 dQ),
//   kept for aligned 16-bit views TMA cannot take, taken at D = 256 (B5:
//   K1 in two column halves, see below) and, through route 1, for
//   timing beside the Hopper one: 4 warps of 16 rows, each product an
//   mma.sync m16n8k16 from ldmatrix fragments, the walked tiles double
//   buffered by cp.async; K1 owns 64 keys and K2 64 query rows, so every
//   gradient is written once and the result does not depend on block
//   order. The tensor cores wait while the softmax runs;
// - the CUDA-core variant (fp32, every other D, unaligned views): the
//   same three launches, K1 and K2 with 8 warps of 8 rows, the tiles
//   staged as fp32 in shared memory, a lane scoring 2 keys (or 2 queries)
//   with fp32 FMAs, P and dS through shared memory, a lane summing D/32
//   columns. Past D = 128 (B5) a block owns 32 rows or keys (4 a warp),
//   and past D = 256 16 (2 a warp) walking tiles of 32 (one a lane), so
//   that its four D-wide fp32 tiles fit in 227 KB: K1's, the larger, up
//   to D = 588, the library's limit (kMaxD; the forward's tiles would
//   reach 592). It is a simple kernel at the fp32 rate, far below the
//   tensor-core bound.
// All three read the forward's lse; the earlier two share K0
// (flash_bwd_delta_rows_kernel), which computes delta alone.
//
// The library links the CUDA driver (-lcuda) for cuTensorMapEncodeTiled:
// the Hopper variant's tensor maps are encoded on the host at each call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // rows (or keys) a block owns
constexpr int kThreads = 256;    // CUDA-core variant: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMmaThreads = 128;       // tensor-core variant: 4 warps of 16
constexpr int kNarrowD = 128;  // the CUDA-core variant's 64-row tiles
constexpr int kWideD = 256;    // its 32-row tiles up to it, 16-row past it
constexpr int kMaxD = 588;     // the largest D whose K1 tiles fit
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block may use
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;     // (B, H, Sq) contiguous, natural log: the forward's
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
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// two floats rounded to a 16-bit type, packed into one 32-bit register
// (the lower one first): an mma/wgmma A fragment pair, or a stored pair
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<T>(lo, hi);
}

// a pair of 16-bit values of T in one register as two floats
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
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
// A block owns BR = 8 R rows (K2) or keys (K1), R a warp, and walks tiles
// of BW = 32 KL keys (K2) or rows (K1), KL a lane: 64 and 64 up to
// kNarrowD, 32 and 64 up to kWideD, 16 and 32 past it.

__host__ __device__ inline int row_stride(int d) { return (d + 3) & ~3; }

template <int R, int KL>
struct ScalarTile {
  static constexpr int BR = kWarps * R;
  static constexpr int BW = 32 * KL;
  // K2: q and dO of the block, K and V walked, dS
  static size_t dq_smem(int d) {
    const size_t ld = row_stride(d);
    return sizeof(float) * (2 * BR * ld + 2 * BW * (ld + 4) +
                            static_cast<size_t>(BR) * BW);
  }
  // K1: K and V of the block, q and dO walked, P^T and dS^T, lse and delta
  static size_t dkdv_smem(int d) {
    const size_t ld = row_stride(d);
    return sizeof(float) * (2 * BR * ld + 2 * BW * (ld + 4) +
                            2 * static_cast<size_t>(BR) * BW + 2 * BW);
  }
};
using WideTile = ScalarTile<2, 1>;  // past kWideD

// fp32 copy of rows [r0, r0 + rows) of a (S, D) slice with row stride ss
// into a [rows][ld] tile, times `mul`; zeros past `limit` rows and D.
template <typename T>
__device__ void stage(float* dst, int ld, const T* src, long long ss, int r0,
                      int rows, int limit, int D, float mul, int tid) {
  for (int i = tid; i < rows * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    dst[i] = (r0 + r < limit && c < D) ? to_float(src[(r0 + r) * ss + c]) * mul
                                       : 0.f;
  }
}

// K0 of the earlier two variants: delta = rowsum(dO * O) of 64 query
// rows, a warp a row (lse is the forward's).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_rows_kernel(const Params p) {
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  write_delta<T>(p, b, h, blockIdx.x * kTile, kTile, threadIdx.x / 32,
                 kWarps, threadIdx.x % 32);
}

// acc[r][c] += sum over 4 walked rows j .. j + 3 of w[r][jj] * m[j + jj][d]
// for d = lane + 32 c: x holds the R rows' 4 weights, m the walked tile
// (row stride ld); each value of m is read once for all R rows.
template <int R, int DC>
__device__ __forceinline__ void sum_rows(float (&acc)[R][DC],
                                         const float4 (&x)[R], const float* m,
                                         int ld, int j, int D, int lane) {
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    const int d = lane + 32 * c;
    float mm[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) mm[jj] = d < D ? m[(j + jj) * ld + d] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][c] += x[r].x * mm[0] + x[r].y * mm[1] + x[r].z * mm[2] +
                   x[r].w * mm[3];
    }
  }
}

// K2: dq of BR query rows. A lane scores keys lane + 32 j (j < KL) for the
// warp's R rows (S and dP), writes dS to shared memory, then sums
// dq[row][d] over the tile's keys for d = lane + 32 c.
template <typename T, int DC, int R, int KL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int BR = ScalarTile<R, KL>::BR, BW = ScalarTile<R, KL>::BW;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = row_stride(D);
  const int ldk = ldq + 4;
  float* q_s = smem;                  // [BR][ldq], times scale
  float* do_s = q_s + BR * ldq;       // [BR][ldq]
  float* k_s = do_s + BR * ldq;       // [BW][ldk]
  float* v_s = k_s + BW * ldk;        // [BW][ldk]
  float* ds_s = v_s + BW * ldk;       // [BR][BW]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * R;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + BR) + BW - 1) / BW;

  stage(q_s, ldq, q, p.q_ss, q0, BR, p.Sq, D, p.scale, tid);
  stage(do_s, ldq, dout, p.do_ss, q0, BR, p.Sq, D, 1.f, tid);
  float lse_r[R], delta_r[R], acc[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + r0 + r;
    lse_r[r] = row < p.Sq ? lse[row] : 0.f;
    delta_r[r] = row < p.Sq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  float* ds_w = ds_s + r0 * BW;  // this warp's rows of dS

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BW;
    __syncthreads();
    stage(k_s, ldk, k, p.k_ss, k0, BW, p.Sk, D, 1.f, tid);
    stage(v_s, ldk, v, p.v_ss, k0, BW, p.Sk, D, 1.f, tid);
    __syncthreads();
    float s[R][KL], dp[R][KL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KL; ++j) s[r][j] = dp[r][j] = 0.f;
    }
    for (int c = 0; c < ldq; c += 4) {
      float4 kv[KL], vv[KL];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(k_s + (lane + 32 * j) * ldk + c);
        vv[j] = *reinterpret_cast<const float4*>(v_s + (lane + 32 * j) * ldk + c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * ldq + c);
        const float4 dv =
            *reinterpret_cast<const float4*>(do_s + (r0 + r) * ldq + c);
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          s[r][j] += qv.x * kv[j].x + qv.y * kv[j].y + qv.z * kv[j].z +
                     qv.w * kv[j].w;
          dp[r][j] += dv.x * vv[j].x + dv.y * vv[j].y + dv.z * vv[j].z +
                      dv.w * vv[j].w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const bool live = attends(p, row, k0 + lane + 32 * j, len, seg);
        const float pv = live ? expf(s[r][j] - lse_r[r]) : 0.f;
        ds_w[r * BW + lane + 32 * j] = pv * (dp[r][j] - delta_r[r]) * p.scale;
      }
    }
    __syncwarp();
    for (int j = 0; j < BW; j += 4) {
      float4 dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dsv[r] = *reinterpret_cast<const float4*>(ds_w + r * BW + j);
      }
      sum_rows<R, DC>(acc, dsv, k_s, ldk, j, D, lane);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[row * p.dq_ss + d] = from_float<T>(acc[r][c]);
    }
  }
}

// K1: dk and dv of BR keys. A lane scores queries lane + 32 j (j < KL) for
// the warp's R keys (S^T and dP^T), writes P^T and dS^T to shared memory,
// then sums dv[key][d] and dk[key][d] over the tile's queries for
// d = lane + 32 c.
template <typename T, int DC, int R, int KL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Params p) {
  constexpr int BR = ScalarTile<R, KL>::BR, BW = ScalarTile<R, KL>::BW;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldk = row_stride(D);   // the block's own keys: read broadcast
  const int ldq = ldk + 4;         // the walked query tiles: a row a lane
  float* k_s = smem;                  // [BR][ldk]
  float* v_s = k_s + BR * ldk;        // [BR][ldk]
  float* q_s = v_s + BR * ldk;        // [BW][ldq], unscaled
  float* do_s = q_s + BW * ldq;       // [BW][ldq]
  float* p_s = do_s + BW * ldq;       // [BR keys][BW queries]
  float* ds_s = p_s + BR * BW;        // [BR keys][BW queries]
  float* lse_s = ds_s + BR * BW;
  float* delta_s = lse_s + BW;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * BR;  // the most work first (causal)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * R;
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
  const int k1 = min(k0 + BR, p.Sk);
  if (k0 >= len) {  // no query sees these keys
    zero_rows(dk, p.dk_ss, k0, k1, D, tid, kThreads);
    zero_rows(dv, p.dv_ss, k0, k1, D, tid, kThreads);
    return;
  }
  stage(k_s, ldk, k, p.k_ss, k0, BR, p.Sk, D, 1.f, tid);
  stage(v_s, ldk, v, p.v_ss, k0, BR, p.Sk, D, 1.f, tid);
  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  float* p_w = p_s + r0 * BW;
  float* ds_w = ds_s + r0 * BW;

  for (int qt = first_row(p, k0) / BW; qt * BW < p.Sq; ++qt) {
    const int q0 = qt * BW;
    __syncthreads();
    stage(q_s, ldq, q, p.q_ss, q0, BW, p.Sq, D, 1.f, tid);
    stage(do_s, ldq, dout, p.do_ss, q0, BW, p.Sq, D, 1.f, tid);
    for (int i = tid; i < BW; i += kThreads) {
      lse_s[i] = q0 + i < p.Sq ? lse[q0 + i] : 0.f;
      delta_s[i] = q0 + i < p.Sq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();
    float s[R][KL], dp[R][KL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KL; ++j) s[r][j] = dp[r][j] = 0.f;
    }
    for (int c = 0; c < ldk; c += 4) {
      float4 qa[KL], da[KL];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        qa[j] = *reinterpret_cast<const float4*>(q_s + (lane + 32 * j) * ldq + c);
        da[j] = *reinterpret_cast<const float4*>(do_s + (lane + 32 * j) * ldq + c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (r0 + r) * ldk + c);
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + (r0 + r) * ldk + c);
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          s[r][j] += kv.x * qa[j].x + kv.y * qa[j].y + kv.z * qa[j].z +
                     kv.w * qa[j].w;
          dp[r][j] += vv.x * da[j].x + vv.y * da[j].y + vv.z * da[j].z +
                      vv.w * da[j].w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const int col = lane + 32 * j;
        const bool live = attends(p, q0 + col, key, len, seg);
        const float pv = live ? expf(s[r][j] * p.scale - lse_s[col]) : 0.f;
        p_w[r * BW + col] = pv;
        ds_w[r * BW + col] = pv * (dp[r][j] - delta_s[col]) * p.scale;
      }
    }
    __syncwarp();
    for (int j = 0; j < BW; j += 4) {
      float4 pv[R], dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(p_w + r * BW + j);
        dsv[r] = *reinterpret_cast<const float4*>(ds_w + r * BW + j);
      }
      sum_rows<R, DC>(acc_v, pv, do_s, ldq, j, D, lane);
      sum_rows<R, DC>(acc_k, dsv, q_s, ldq, j, D, lane);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
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
// The tensor-core variant: bf16 or fp16 (T), D = 64, 128 or 256, 16-byte
// aligned rows. Tiles in shared memory in T with rows padded by 16 bytes, so that
// ldmatrix's 8 row addresses fall in distinct banks. A warp owns 16 rows
// of the block's tile; the walked tiles hold NT rows (64 at D = 64, 32 at
// D = 128 and 256, which keeps K1's two sums in registers). At D = 256
// K1's two sums of a 16 x 256 block would take 256 registers a thread, so
// each K1 block sums DO = 128 of the columns (blockIdx.z picks which) and
// computes S^T and dP^T, over the whole D, once for each half: 12 D
// operations a live pair in K1 where 8 D would do.
//
// Fragments of mma.sync m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
// a3 = (g + 8, 2t + 8..); B (16 x 8, column-major) b0 = (2t..2t+1, g),
// b1 = (2t + 8.., g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 =
// (g + 8, 2t..). Two products shapes serve every product of the backward:
// - mma_nt: C (16 x NT) += A (16 x D) * M^T for an NT x D tile M stored
//   row-major (S = Q K^T, dP = dO V^T; in K1 S^T = K Q^T, dP^T = V dO^T);
// - mma_pv: C (16 x D) += A (16 x NT, the fp32 C fragments of an mma_nt
//   rounded to T) * M for an NT x D tile M stored row-major (dQ = dS K;
//   in K1 dV = P^T dO, dK = dS^T Q).

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;                 // tile row stride
  static constexpr int NT = D == 64 ? 64 : 32;     // rows of a walked tile
  static constexpr int NN = NT / 8;                // 8-wide C tiles of a row
  static constexpr int ND = D / 8;                 // 8-wide C tiles of D
  static constexpr int V8 = D / 8;                 // 16-byte vectors a row
  static constexpr int DO = D < 128 ? D : 128;     // K1's columns a block
  static constexpr int SPLIT = D / DO;             // K1 blocks a key tile
};

__device__ __forceinline__ uint32_t ld_pair(const void* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (kIsF16<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
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

// rows [r0, r0 + rows) of a (S, D) slice of T into a [rows][LD] tile by
// cp.async; zeros past `limit`
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
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
template <int LD, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* rows,
                                       int kc, int g, int t) {
  const T* base = rows + g * LD + kc * 16 + 2 * t;
  a[0] = ld_pair(base);
  a[1] = ld_pair(base + 8 * LD);
  a[2] = ld_pair(base + 8);
  a[3] = ld_pair(base + 8 * LD + 8);
}

// c += A * M^T: A the 16 rows at `a_rows`, M the NN * 8 rows at `m`
template <typename T, int D, int NN>
__device__ __forceinline__ void mma_nt(float (&c)[NN][4], const T* a_rows,
                                       const T* m, int lane) {
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
      mma_16816<T>(c[n], a0, f[0], f[1]);
      mma_16816<T>(c[n], a1, f[2], f[3]);
    }
  }
}

// acc += A * M: A the C fragments `x` (16 x NN * 8) rounded to T, M the
// NN * 8 rows at `m` (of a tile with D + 8 a row), its first DO columns
template <typename T, int D, int NN, int DO = D>
__device__ __forceinline__ void mma_pv(float (&acc)[DO / 8][4],
                                       const float (&x)[NN][4], const T* m,
                                       int lane) {
  constexpr int LD = MmaTile<D>::LD;
  const int lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int j = 0; j < NN / 2; ++j) {
    const uint32_t a[4] = {pack2<T>(x[2 * j][0], x[2 * j][1]),
                           pack2<T>(x[2 * j][2], x[2 * j][3]),
                           pack2<T>(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack2<T>(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int nd = 0; nd < DO / 8; nd += 2) {
      uint32_t f[4];  // B fragments of column tiles nd and nd + 1
      ldmatrix_x4_trans(f, m + (j * 16 + lr + 8 * (lm & 1)) * LD +
                               (nd + lm / 2) * 8);
      mma_16816<T>(acc[nd], a, f[0], f[1]);
      mma_16816<T>(acc[nd + 1], a, f[2], f[3]);
    }
  }
}

// the 16 x DO C fragments `acc` into rows r, r + 8 (r = row0 + g) of a
// (S, D) slice of T with row stride ss, from its column `dst` points at;
// rows at or past `limit` skipped
template <typename T, int DO>
__device__ __forceinline__ void store_rows(T* dst, long long ss,
                                           const float (&acc)[DO / 8][4],
                                           int row0, int limit, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nd = 0; nd < DO / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row0 + g < limit) {
      store2<T>(dst + (row0 + g) * ss + col, acc[nd][0], acc[nd][1]);
    }
    if (row0 + g + 8 < limit) {
      store2<T>(dst + (row0 + g + 8) * ss + col, acc[nd][2], acc[nd][3]);
    }
  }
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

// K2, tensor-core variant: a warp's 16 query rows against NT-key tiles:
// S = Q K^T, dP = dO V^T, P and dS in registers, dQ += dS K.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const Params p) {
  using Tl = MmaTile<D>;
  constexpr int LD = Tl::LD, NT = Tl::NT, NN = Tl::NN, ND = Tl::ND;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTile][LD]
  T* do_s = q_s + kTile * LD;                  // [kTile][LD]
  T* k_s = do_s + kTile * LD;                  // [2][NT][LD]
  T* v_s = k_s + 2 * NT * LD;                  // [2][NT][LD]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  const int n_tiles = (keys_seen(p, len, q0 + kTile) + NT - 1) / NT;

  const auto load_kv = [&](int kt, int buf) {
    load_rows<T, D>(k_s + buf * NT * LD, k, p.k_ss, kt * NT, NT, p.Sk, tid);
    load_rows<T, D>(v_s + buf * NT * LD, v, p.v_ss, kt * NT, NT, p.Sk, tid);
    cp_async_commit();
  };
  load_rows<T, D>(q_s, q, p.q_ss, q0, kTile, p.Sq, tid);
  load_rows<T, D>(do_s, dout, p.do_ss, q0, kTile, p.Sq, tid);
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
      const T* kb = k_s + buf * NT * LD;
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_nt<T, D, NN>(s, q_s + wr * LD, kb, lane);
      mma_nt<T, D, NN>(dp, do_s + wr * LD, v_s + buf * NT * LD, lane);
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
      mma_pv<T, D, NN>(acc, dp, kb, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows<T, D>(dq, p.dq_ss, acc, q0 + wr, p.Sq, lane);
}

// K1, tensor-core variant: a warp's 16 keys against NT-row query tiles:
// S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers, dV += P^T dO,
// dK += dS^T Q.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkdv_mma_kernel(const Params p) {
  using Tl = MmaTile<D>;
  constexpr int LD = Tl::LD, NT = Tl::NT, NN = Tl::NN, DO = Tl::DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kTile][LD]
  T* v_s = k_s + kTile * LD;                   // [kTile][LD]
  T* q_s = v_s + kTile * LD;                   // [2][NT][LD]
  T* do_s = q_s + 2 * NT * LD;                 // [2][NT][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * NT * LD);  // [2][NT]
  float* delta_s = lse_s + 2 * NT;                              // [2][NT]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kTile;  // the most work first (causal)
  const int c0 = blockIdx.z * DO;     // the block's first column of dk, dv
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout =
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const int* seg = p.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;
  const float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const float* delta = p.delta + (static_cast<size_t>(b) * p.H + h) * p.Sq;
  const int len = key_limit(p, b);
  if (k0 >= len) {  // no query sees these keys
    const int k1 = min(k0 + kTile, p.Sk);
    zero_rows(dk + c0, p.dk_ss, k0, k1, DO, tid, kMmaThreads);
    zero_rows(dv + c0, p.dv_ss, k0, k1, DO, tid, kMmaThreads);
    return;
  }
  const int qt0 = first_row(p, k0) / NT;
  const int n_qt = (p.Sq + NT - 1) / NT;

  const auto load_q = [&](int qt, int buf) {
    const int r0 = qt * NT;
    load_rows<T, D>(q_s + buf * NT * LD, q, p.q_ss, r0, NT, p.Sq, tid);
    load_rows<T, D>(do_s + buf * NT * LD, dout, p.do_ss, r0, NT, p.Sq, tid);
    for (int i = tid; i < NT; i += kMmaThreads) {
      const bool in = r0 + i < p.Sq;
      lse_s[buf * NT + i] = in ? lse[r0 + i] * kLog2e : 0.f;
      delta_s[buf * NT + i] = in ? delta[r0 + i] : 0.f;
    }
    cp_async_commit();
  };
  load_rows<T, D>(k_s, k, p.k_ss, k0, kTile, p.Sk, tid);
  load_rows<T, D>(v_s, v, p.v_ss, k0, kTile, p.Sk, tid);
  cp_async_commit();
  load_q(qt0, 0);

  const int key_a = k0 + wr + g, key_b = key_a + 8;
  const float scale_log2 = p.scale * kLog2e;
  float acc_k[DO / 8][4], acc_v[DO / 8][4];
#pragma unroll
  for (int nd = 0; nd < DO / 8; ++nd) {
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
      const T* qb = q_s + buf * NT * LD;
      const T* db = do_s + buf * NT * LD;
      const float* lse_t = lse_s + buf * NT;
      const float* delta_t = delta_s + buf * NT;
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_nt<T, D, NN>(s, k_s + wr * LD, qb, lane);   // S^T
      mma_nt<T, D, NN>(dp, v_s + wr * LD, db, lane);  // dP^T
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
      mma_pv<T, D, NN, DO>(acc_v, s, db + c0, lane);   // dV += P^T dO
      mma_pv<T, D, NN, DO>(acc_k, dp, qb + c0, lane);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with buffer buf before its reload
  }
  cp_async_wait<0>();
  store_rows<T, DO>(dk + c0, p.dk_ss, acc_k, k0 + wr, p.Sk, lane);
  store_rows<T, DO>(dv + c0, p.dv_ss, acc_v, k0 + wr, p.Sk, lane);
}

// ---------------------------------------------------------------------------
// The Hopper variant (flash_bwd_wgmma_kernel): bf16 or fp16 (TE), D = 64
// or 128, q, k,
// v, o and dO views that TMA can describe, the forward's lse at hand.
// FlashAttention-3's backward layout, three launches and a pre-pass:
//
// - K0 (flash_bwd_delta_kernel) reads o and dO once: delta =
//   rowsum(dO * O) in fp32; lse2 = lse * log2(e) from the forward's lse,
//   +inf for rows past Sq and rows that see no key (so that exp2 gives
//   their P = 0 without a predicate); and zeroes an fp32 dQ accumulator.
//   All three are (B * H, sq_pad) rows, sq_pad = Sq rounded up to 64, so
//   that a producer bulk-copies a query tile's 64 values in bounds;
// - the main kernel: a block per (batch*head, BN keys) of one producer
//   warpgroup and NC consumer warpgroups of 64 keys each (BN = 128, NC = 2
//   at D = 64; BN = 64, NC = 1 at D = 128, whose dK and dV sums alone are
//   128 registers a thread). The block's K and V tiles stay in shared
//   memory for the whole walk. The producer (its registers handed to the
//   consumers by setmaxnreg) streams the Q and dO tiles, lse2, delta and
//   (with segments) the ids of every 64-row query tile that can see the
//   block's keys, by TMA into a ring of kBwdStages stages, each guarded by
//   a full and an empty mbarrier. A consumer computes, per query tile:
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands from shared
//   memory, K-major, two groups); P^T = exp2(S^T * scale * log2 e -
//   lse2), zeroed by the mask predicate where the tile is not whole,
//   while dP^T's products run; dV += P^T dO, issued before dS^T = P^T
//   (dP^T - delta) * scale is computed, so that it runs meanwhile; then
//   dK += dS^T Q (P^T and dS^T packed to TE as wgmma's register A
//   operand, dO and Q read MN-major through the descriptor's transpose
//   bit) and dQ_partial = dS K, with dS^T stored to shared memory in TE
//   in the 128-byte swizzle and read back as an MN-major A, K as an
//   MN-major B. The partial is staged in
//   shared memory in the fragment's own order and added into the fp32
//   accumulator by one TMA bulk reduce-add (cp.reduce.async.bulk .add.f32,
//   16 KB a tile), which measured faster at the model's shape than 8-byte
//   red.global.add from every thread, and than summing the two
//   consumers' partials in shared memory first (the named barriers that
//   takes tie the consumers together, and cost more than the halved
//   traffic saves).
//   dK and dV are written once, in their inputs' layout and dtype. The
//   consumers run unsynchronised, so that the tensor cores take one's
//   products while the other's exp2 and dQ staging run; three stages
//   measured faster than two or four;
// - K2 (flash_bwd_dq_store_kernel): the accumulator becomes dq in q's
//   dtype and layout.
//
// Masks on the same pipeline (B3): a block whose keys all lie at or past
// its batch element's length loads nothing and writes zeros to dK and dV;
// causally a block walks only the query tiles on or below its diagonal;
// with segment ids a pre-pass (seg_ranges_kernel) sums up each 64
// positions' ids, and the producer and the consumers walk the same tiles
// (one predicate: the query tile's id range meets the block's keys'),
// skipping every pair of tiles that cannot meet. A consumer's tile that no
// mask touches takes P without the per-score predicate. A query row that
// sees no key gets dS = 0 by the predicate, adds +0.0 to a zeroed
// accumulator and comes out exact 0; keys no row sees sum zeros.
//
// Determinism: dK and dV are written once, whatever the block order; the
// partial sums of dQ arrive in an order that changes from run to run, so
// dq may differ in its last bits between two calls on the same inputs
// (PyTorch's own scaled_dot_product_attention backward makes the same
// trade). The mma.sync variant above stays deterministic. A
// deterministic dQ here would be a second kernel walking each query
// tile's keys, with S and dP computed again (6 D operations a live pair
// on top of this kernel's own): PERF.md (section 6) sets out why it was not
// taken.

constexpr int kBwdBlockM = 64;  // query rows of a walked tile
constexpr int kBwdStages = 3;   // query tiles in the ring
// floats of one (64 query rows, 64 columns) tile of the dQ accumulator.
// The accumulator holds such tiles, (B * H, sq_pad / 64, D / 64) of them,
// each in wgmma's fragment order: float pair j (0-15) of thread t (0-127)
// of the consumer warpgroup at 2 (128 j + t), pair j = 2 n + h holding
// row 16 (t / 32) + (t % 32) / 4 + 8 h, columns 8 n + 2 (t % 4) + 0, 1.
// So a consumer stages its part with conflict-free 8-byte stores, and a
// tile is 16 contiguous KB for one bulk reduce-add.
constexpr int kBwdDqTile = 64 * 64;

template <int D>
struct BwdTile {
  static constexpr int NC = D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int BN = 64 * NC;          // keys of a block
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int PANELS = D / 64;       // 128-byte column panels
  static constexpr int KV_PANEL = BN * kPanelBytes;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one of K or V
  static constexpr int Q_PANEL = kBwdBlockM * kPanelBytes;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;    // one of Q or dO
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;     // Q, then dO
  static constexpr int DS_BYTES = 64 * kPanelBytes;   // a consumer's dS^T
  static constexpr int DQ_BYTES = kBwdDqTile * 4;     // a consumer's dQ part
  static constexpr int ROW_BYTES = kBwdBlockM * 4;    // lse2, delta or ids
  static constexpr int BAR_BYTES = 64;  // 1 + 2 * kBwdStages mbarriers
  // the tiles (aligned to the 1024 bytes the 128-byte swizzle repeats
  // over), then each consumer's dQ staging, each stage's rows, the
  // mbarriers
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES +
                                 kBwdStages * STAGE_BYTES + NC * DS_BYTES +
                                 NC * DQ_BYTES + kBwdStages * 3 * ROW_BYTES +
                                 BAR_BYTES;
};

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // 4-D maps (encode_map)
  void* dk;
  void* dv;
  float* dq_acc;           // dQ tiles (kBwdDqTile), zeroed by K0
  const float* lse2;       // (B * H, sq_pad)
  const float* delta;      // (B * H, sq_pad)
  const int* lengths;      // (B,) key lengths, or null
  const int* seg_pad;      // (B, s_pad) segment ids, zeros past S (HAS_SEG)
  const int4* seg_range;   // (B, s_pad / kSegChunk) of (lo, hi, uni, 0)
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int H, Sq, Sk, sq_pad, s_pad;
  int q_slots, k_slots, v_slots, do_slots;
  float scale, scale_log2;
};

// `bytes` of fp32 at src in shared memory added element by element into
// global memory at dst by the TMA unit (atomically per element), as one
// bulk group of this thread
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// K0: one thread per 8 columns of a (B * H, sq_pad) row.
template <typename TE, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const TE* __restrict__ o,
                           const TE* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ lse2, float* __restrict__ delta,
                           float* __restrict__ dq_acc, long long o_sb,
                           long long o_sh, long long o_ss, long long do_sb,
                           long long do_sh, long long do_ss, int H, int Sq,
                           int sq_pad) {
  constexpr int CH = D / 8;  // threads of a row: 8 or 16, within a warp
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  const size_t row = idx / CH;  // of (B * H, sq_pad)
  const int ch = static_cast<int>(idx % CH);
  const int bh = static_cast<int>(row / sq_pad);
  const int r = static_cast<int>(row % sq_pad);
  const int b = bh / H, h = bh % H;
  float acc = 0.f;
  if (r < Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_sb + h * o_sh + r * o_ss + 8 * ch);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * do_sb + h * do_sh + r * do_ss + 8 * ch);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = unpack2<TE>(ow[j]);
      const float2 d = unpack2<TE>(dw[j]);
      acc += a.x * d.x + a.y * d.y;
    }
  }
#pragma unroll
  for (int off = CH / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  float4* z = reinterpret_cast<float4*>(dq_acc + row * D + 8 * ch);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ch == 0) {
    delta[row] = acc;
    // a row that sees no key has a forward lse near -1e30 (m stayed at its
    // floor): its P is 0, as the mask says
    const float l = r < Sq ? lse[static_cast<size_t>(bh) * Sq + r] : kNeg;
    lse2[row] = l > -1e29f ? l * kLog2e : __int_as_float(0x7f800000);
  }
}

// K2: one thread per 8 columns of a row of dq.
template <typename TE, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_store_kernel(const float* __restrict__ dq_acc,
                              TE* __restrict__ dq, long long dq_sb,
                              long long dq_sh, long long dq_ss, int H, int Sq,
                              int sq_pad, size_t count) {
  constexpr int CH = D / 8;
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= count) return;
  const size_t row = idx / CH;  // of (B * H, Sq)
  const int ch = static_cast<int>(idx % CH);
  const int bh = static_cast<int>(row / Sq);
  const int r = static_cast<int>(row % Sq);
  // columns 8 ch .. 8 ch + 7 of row r: in tile (r / 64, ch / 8) the pairs
  // j = 2 n + h of threads 32 w + 4 g + 0..3, 8 contiguous floats
  const int tr = r % 64, n = ch % 8;
  const int t = 32 * (tr / 16) + 4 * (tr % 8);
  const int j = 2 * n + (tr % 16) / 8;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc +
      ((static_cast<size_t>(bh) * (sq_pad / 64) + r / 64) * (D / 64) +
       ch / 8) * kBwdDqTile +
      2 * (128 * j + t));
  const float4 a = src[0], c = src[1];
  uint4 out;
  out.x = pack2<TE>(a.x, a.y);
  out.y = pack2<TE>(a.z, a.w);
  out.z = pack2<TE>(c.x, c.y);
  out.w = pack2<TE>(c.z, c.w);
  *reinterpret_cast<uint4*>(dq + (bh / H) * dq_sb + (bh % H) * dq_sh +
                            r * dq_ss + 8 * ch) = out;
}

template <typename TE, int D, bool CAUSAL, bool HAS_SEG>
__global__ void __launch_bounds__(BwdTile<D>::THREADS, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ BwdParams p) {
  using T = BwdTile<D>;
  constexpr int NC = T::NC, BN = T::BN, ST = kBwdStages;
  constexpr bool F16 = kIsF16<TE>;  // the .f16 products, else .bf16
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + T::KV_BYTES;
  const uint32_t st_s = v_s + T::KV_BYTES;           // stage s: Q, dO
  const uint32_t ds_s = st_s + ST * T::STAGE_BYTES;  // consumer c's dS^T
  const uint32_t dq_s = ds_s + NC * T::DS_BYTES;     // consumer c's dQ part
  const uint32_t row_s = dq_s + NC * T::DQ_BYTES;    // stage s: 3 rows
  const uint32_t kv_full = row_s + ST * 3 * T::ROW_BYTES;
  const auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8u * (1 + ST + s); };
  // generic pointers into shared memory, for the threads' own reads
  const auto at = [&](uint32_t addr) { return smem_raw + (addr - base); };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BN;  // the heaviest causal blocks first
  const int shift = p.Sk - p.Sq;   // the causal diagonal: key <= row + shift
  const int len =
      p.lengths != nullptr ? min(max(p.lengths[b], 0), p.Sk) : p.Sk;
  const int n_m = (p.Sq + kBwdBlockM - 1) / kBwdBlockM;
  // the first query tile that can see the block's keys (none if every key
  // is at or past the length)
  const int m_first = k0 >= len ? n_m
                      : CAUSAL  ? max(0, k0 - shift) / kBwdBlockM
                                : 0;

  // Segment tile skipping: a query tile is walked only if its id range
  // meets the block's keys'; producer and consumers evaluate this one
  // predicate, so that they walk the same sequence through the ring.
  const int4* ranges = HAS_SEG ? p.seg_range + static_cast<size_t>(b) *
                                                   (p.s_pad / kSegChunk)
                               : nullptr;
  int4 k_range = make_int4(INT_MAX, 0, 0, 0);
  if constexpr (HAS_SEG) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int4 x = __ldg(ranges + k0 / kSegChunk + j);
      k_range.x = min(k_range.x, x.x);
      k_range.y = max(k_range.y, x.y);
    }
  }
  const auto loaded = [&](int m) {
    if constexpr (!HAS_SEG) return true;
    const int4 x = __ldg(ranges + m);
    return ranges_meet(make_int2(x.x, x.y), k_range);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: lane 0 of warp 0 issues every load
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    // Load i (query tile m) goes to stage i % ST; K and V come with the
    // first, so that a block that walks no tile leaves no copy in flight.
    const auto issue = [&](int m, int i) {
      if (i == 0) {
        mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load(k_s + pn * T::KV_PANEL, &p.tk, kv_full, p.k_slots, 64 * pn,
                   k0, h, b);
          tma_load(v_s + pn * T::KV_PANEL, &p.tv, kv_full, p.v_slots, 64 * pn,
                   k0, h, b);
        }
      }
      const int s = i % ST;
      mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
      mbar_expect_tx(full(s), T::STAGE_BYTES + (HAS_SEG ? 3 : 2) * T::ROW_BYTES);
      const uint32_t qs = st_s + s * T::STAGE_BYTES;
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        tma_load(qs + pn * T::Q_PANEL, &p.tq, full(s), p.q_slots, 64 * pn,
                 m * kBwdBlockM, h, b);
        tma_load(qs + T::Q_BYTES + pn * T::Q_PANEL, &p.tdo, full(s),
                 p.do_slots, 64 * pn, m * kBwdBlockM, h, b);
      }
      const size_t row0 = static_cast<size_t>(bh) * p.sq_pad + m * kBwdBlockM;
      const uint32_t rows = row_s + s * 3 * T::ROW_BYTES;
      bulk_load(rows, p.lse2 + row0, T::ROW_BYTES, full(s));
      bulk_load(rows + T::ROW_BYTES, p.delta + row0, T::ROW_BYTES, full(s));
      if constexpr (HAS_SEG) {
        bulk_load(rows + 2 * T::ROW_BYTES,
                  p.seg_pad + static_cast<size_t>(b) * p.s_pad +
                      m * kBwdBlockM,
                  T::ROW_BYTES, full(s));
      }
    };
    if (threadIdx.x < 32) {
      // 32 tiles tested at a time, a lane each (one round trip for the
      // segment ranges, not one a tile); lane 0 issues the walked ones
      const int lane = threadIdx.x;
      int i = 0;
      for (int w0 = m_first; w0 < n_m; w0 += 32) {
        unsigned msk = __ballot_sync(0xffffffffu,
                                     w0 + lane < n_m && loaded(w0 + lane));
        for (; msk != 0u; msk &= msk - 1u, ++i) {
          if (lane == 0) issue(w0 + __ffs(msk) - 1, i);
        }
      }
    }
    return;
  }
  // the consumers take the registers the producer gave back: 24 + 2 x 240
  // a thread over the three warpgroups, within the block's 3 x 168
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");

  // a consumer: 64 keys, warp w of it keys 16w .. 16w + 15
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row within 8
  const int t4 = lane % 4;  // fragment column pair
  const int kc0 = k0 + 64 * c;
  const int key_a = kc0 + 16 * warp + g;  // this lane's two keys
  const int key_b = key_a + 8;
  const float sl2 = p.scale_log2, scale = p.scale;
  int seg_a = 0, seg_b = 0, k_uni = 0;  // this lane's keys' segments
  if constexpr (HAS_SEG) {
    const int* ids = p.seg_pad + static_cast<size_t>(b) * p.s_pad;
    seg_a = __ldg(ids + key_a);
    seg_b = __ldg(ids + key_b);
    k_uni = __ldg(ranges + kc0 / kSegChunk).z;
  }
  // The walked tiles after m - 1 (n_m if none); warp-uniform. Each warp
  // tests 32 tiles at a time, a lane each, and keeps the window's masks:
  // which tiles are walked, and which hold only its keys' one id.
  int win = -64;
  unsigned win_loaded = 0u, win_uni = 0u;
  const auto next_tile = [&](int m) {
    if constexpr (HAS_SEG) {
      while (m < n_m) {
        const int w0 = m & ~31;
        if (w0 != win) {
          win = w0;
          bool in = false, one = false;
          if (w0 + lane < n_m) {
            const int4 x = __ldg(ranges + w0 + lane);
            in = ranges_meet(make_int2(x.x, x.y), k_range);
            one = k_uni > 0 && x.z == k_uni;
          }
          win_loaded = __ballot_sync(0xffffffffu, in);
          win_uni = __ballot_sync(0xffffffffu, one);
        }
        const unsigned msk = win_loaded >> (m - w0);
        if (msk != 0u) return m + __ffs(msk) - 1;
        m = w0 + 32;
      }
    }
    return min(m, n_m);
  };

  float dk[T::PANELS][32], dv[T::PANELS][32];
  float sacc[32], pacc[32], dq[32];
#pragma unroll
  for (int pn = 0; pn < T::PANELS; ++pn) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[pn][i] = dv[pn][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = dq[i] = 0.f;

  const uint32_t my_ds = ds_s + c * T::DS_BYTES;
  uint32_t* ds_w = reinterpret_cast<uint32_t*>(at(my_ds));
  const uint32_t my_dq = dq_s + c * T::DQ_BYTES;
  float2* dq_w = reinterpret_cast<float2*>(at(my_dq));
  // dQ_partial of query tile m and one 64-column panel of D into the fp32
  // accumulator: staged in fragment order (conflict-free 8-byte stores),
  // then added by one bulk reduce-add of the tile's 16 KB. The last
  // reduce from the staging tile has read it (thread 0 waited before the
  // warpgroup's last barrier).
  const auto add_dq = [&](int m, int pn) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      dq_w[128 * j + tid] = make_float2(dq[2 * j], dq[2 * j + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    if (tid == 0) {
      bulk_reduce_add(
          p.dq_acc +
              ((static_cast<size_t>(bh) * (p.sq_pad / 64) + m) * T::PANELS +
               pn) * kBwdDqTile,
          my_dq, T::DQ_BYTES);
    }
  };
  // dQ_partial = dS K for panel pn: A = dS (64 queries x 64 keys), read
  // MN-major from the dS^T tile (16 keys a step, 2048 bytes apart); B =
  // this consumer's K rows, MN-major, as the forward reads V
  const auto issue_dq = [&](int pn) {
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n64k16_ss<1, 1, F16>(
          dq, smem_desc(my_ds + j * 16 * kPanelBytes, 1024, 1024),
          smem_desc(k_s + pn * T::KV_PANEL + (64 * c + 16 * j) * kPanelBytes,
                    1024, 1024),
          j > 0);
    }
  };

  int i = 0;
  for (int m = next_tile(m_first); m < n_m; m = next_tile(m + 1), ++i) {
    const int s = i % ST;
    const int q0 = m * kBwdBlockM;
    if (i == 0) mbar_wait(kv_full, 0);
    mbar_wait(full(s), (i / ST) & 1);
    // the dQ staging tile is free again by the warpgroup's next barrier
    if (tid == 0) bulk_wait_read();
    const uint32_t qs = st_s + s * T::STAGE_BYTES;
    const uint32_t dos = qs + T::Q_BYTES;

    // S^T = K Q^T, then dP^T = V dO^T, as two groups: D/16 steps of 16
    // along the head dim, 32 bytes apart inside a panel's swizzled
    // 128-byte rows. P^T is computed while dP^T's products run, and
    // dV += P^T dO runs while dS^T is computed and stored.
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int pn = kk / 4, off = (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0, F16>(
          sacc,
          smem_desc(k_s + pn * T::KV_PANEL + 64 * c * kPanelBytes + off, 16,
                    1024),
          smem_desc(qs + pn * T::Q_PANEL + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int pn = kk / 4, off = (kk % 4) * 32;
      wgmma_m64n64k16_ss<0, 0, F16>(
          pacc,
          smem_desc(v_s + pn * T::KV_PANEL + 64 * c * kPanelBytes + off, 16,
                    1024),
          smem_desc(dos + pn * T::Q_PANEL + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(sacc);  // S^T has landed; dP^T may still run

    // P^T on the fragment: sacc[4n + e] is key (e < 2 ? key_a : key_b),
    // query q0 + 8n + 2 t4 + (e & 1). A tile no mask touches (all 64 keys
    // before the length and on or below the tile's first row's diagonal;
    // under segments, keys and rows all of one id) skips the predicate;
    // lse2 is +inf on rows past Sq.
    bool whole = kc0 + 64 <= len && (!CAUSAL || kc0 + 63 <= q0 + shift);
    if constexpr (HAS_SEG) whole = whole && ((win_uni >> (m - win)) & 1u);
    const uint32_t rows = row_s + s * 3 * T::ROW_BYTES;
    const float* lse_t = reinterpret_cast<const float*>(at(rows));
    const float* del_t = reinterpret_cast<const float*>(at(rows + T::ROW_BYTES));
    const int* ids_t = reinterpret_cast<const int*>(at(rows + 2 * T::ROW_BYTES));
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      int2 qid = make_int2(0, 0);
      if constexpr (HAS_SEG) qid = *reinterpret_cast<const int2*>(ids_t + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * n + e;
        float pv = fast_exp2(fmaf(sacc[idx], sl2, (e & 1) ? -l2.y : -l2.x));
        if (!whole) {
          const int key = e < 2 ? key_a : key_b;
          bool ok = key < len &&
                    (!CAUSAL || key <= q0 + col + (e & 1) + shift);
          if constexpr (HAS_SEG) {
            const int sq = (e & 1) ? qid.y : qid.x;
            ok = ok && sq > 0 && sq == (e < 2 ? seg_a : seg_b);
          }
          pv = ok ? pv : 0.f;
        }
        sacc[idx] = pv;
      }
    }
    // P^T as A fragments in TE, 16 queries a step; dV += P^T dO: dO's rows
    // of each 16-query step, 2048 bytes a step, MN-major (one 64-column
    // atom along N, so the leading and the stride offsets are both the
    // 8-row step)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[j][r] = pack2<TE>(sacc[8 * j + 2 * r], sacc[8 * j + 2 * r + 1]);
      }
    }
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) fence_regs(dv[pn]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        wgmma_m64n64k16_rs<F16>(
            dv[pn], pa[j],
            smem_desc(dos + pn * T::Q_PANEL + j * 16 * kPanelBytes, 1024,
                      1024));
      }
    }
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(pacc);  // dP^T has landed; dV may still run

    // dS^T = P^T (dP^T - delta) * scale, as A fragments in TE
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl =
          *reinterpret_cast<const float2*>(del_t + 8 * n + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * n + e;
        pacc[idx] = sacc[idx] * (pacc[idx] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        da[j][r] = pack2<TE>(pacc[8 * j + 2 * r], pacc[8 * j + 2 * r + 1]);
      }
    }
    // dS^T into this consumer's tile, rows of 64 queries in the 128-byte
    // swizzle (16-byte unit n of row r at unit n ^ (r & 7)); key rows
    // 16 warp + g and + 8 share r & 7 = g. The wgmma of the last tile that
    // read it has retired.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int ra = 16 * warp + g;
      const int unit = ((n ^ g) << 2) + t4;  // in 4-byte words
      ds_w[ra * 32 + unit] = da[n / 2][(n & 1) * 2];
      ds_w[(ra + 8) * 32 + unit] = da[n / 2][(n & 1) * 2 + 1];
    }
    // visible to the async proxy (wgmma) for the whole warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");

    // dK += dS^T Q (Q's rows as dO's above), then dQ's first panel
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) fence_regs(dk[pn]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        wgmma_m64n64k16_rs<F16>(
            dk[pn], da[j],
            smem_desc(qs + pn * T::Q_PANEL + j * 16 * kPanelBytes, 1024,
                      1024));
      }
    }
    issue_dq(0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
      fence_regs(dv[pn]);
      fence_regs(dk[pn]);
    }
    fence_regs(dq);
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    add_dq(m, 0);
    if constexpr (T::PANELS > 1) {
      issue_dq(1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      if (tid == 0) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      add_dq(m, 1);
    }
  }
  if (tid == 0) bulk_wait();  // the reduces are done before the block exits

  // dK and dV once, in their inputs' layout (keys past Sk not stored;
  // keys no row saw hold exact zeros)
  TE* dk_o = static_cast<TE*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  TE* dv_o = static_cast<TE*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int pn = 0; pn < T::PANELS; ++pn) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = pn * 64 + n * 8 + 2 * t4;
      if (key_a < p.Sk) {
        store2<TE>(dk_o + key_a * p.dk_ss + col, dk[pn][4 * n],
                   dk[pn][4 * n + 1]);
        store2<TE>(dv_o + key_a * p.dv_ss + col, dv[pn][4 * n],
                   dv[pn][4 * n + 1]);
      }
      if (key_b < p.Sk) {
        store2<TE>(dk_o + key_b * p.dk_ss + col, dk[pn][4 * n + 2],
                   dk[pn][4 * n + 3]);
        store2<TE>(dv_o + key_b * p.dv_ss + col, dv[pn][4 * n + 2],
                   dv[pn][4 * n + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int tiles, int threads,
           size_t smem, cudaStream_t stream, int split = 1) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(tiles, p.B * p.H, split), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int q_tiles(const Params& p) { return (p.Sq + kTile - 1) / kTile; }
int k_tiles(const Params& p) { return (p.Sk + kTile - 1) / kTile; }

template <typename T, int D>
int run_mma(const Params& p, cudaStream_t s) {
  int err = launch(flash_bwd_delta_rows_kernel<T>, p, q_tiles(p),
                   kThreads, 0, s);
  if (err == 0) {
    err = launch(flash_bwd_dkdv_mma_kernel<T, D>, p, k_tiles(p), kMmaThreads,
                 mma_dkdv_shared_bytes<D>(), s, MmaTile<D>::SPLIT);
  }
  if (err == 0) {
    err = launch(flash_bwd_dq_mma_kernel<T, D>, p, q_tiles(p), kMmaThreads,
                 mma_dq_shared_bytes<D>(), s);
  }
  return err;
}

template <typename T>
int run_mma_d(const Params& p, cudaStream_t s) {
  if (p.D == 64) return run_mma<T, 64>(p, s);
  return p.D == 128 ? run_mma<T, 128>(p, s) : run_mma<T, 256>(p, s);
}


// The Hopper variant: K0, the segment pre-pass, the main kernel and K2 on
// one stream, no host sync. scratch: fp32 (lse2, delta, the dQ
// accumulator); seg_scratch: seg_scratch_ints(B, Sk) int32 with segment
// ids.
int sq_pad_of(int Sq) {
  return (Sq + kBwdBlockM - 1) / kBwdBlockM * kBwdBlockM;
}

template <typename TE, int D, bool CAUSAL, bool HAS_SEG>
int launch_bwd_wgmma(const Params& p, const float* lse, float* scratch,
                     int* seg_scratch, cudaStream_t stream) {
  using T = BwdTile<D>;
  const int bh = p.B * p.H;
  const int sq_pad = sq_pad_of(p.Sq);
  float* lse2 = scratch;
  float* delta = lse2 + static_cast<size_t>(bh) * sq_pad;
  float* dq_acc = delta + static_cast<size_t>(bh) * sq_pad;
  const size_t prep = static_cast<size_t>(bh) * sq_pad * (D / 8);
  flash_bwd_delta_kernel<TE, D><<<static_cast<unsigned>(prep / 256), 256, 0,
                                  stream>>>(
      static_cast<const TE*>(p.o), static_cast<const TE*>(p.dout), lse,
      lse2, delta, dq_acc, p.o_sb, p.o_sh, p.o_ss, p.do_sb, p.do_sh, p.do_ss,
      p.H, p.Sq, sq_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // the maps are encoded after a runtime launch: the backward runs on
  // autograd's own thread, where the driver call needs the context that
  // the launch has made current
  BwdParams w;
  err = encode_map(&w.tq, &w.q_slots, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh,
                   p.q_sb, kBwdBlockM);
  if (err == 0) {
    err = encode_map(&w.tdo, &w.do_slots, p.dout, D, p.Sq, p.H, p.B,
                     p.do_ss, p.do_sh, p.do_sb, kBwdBlockM);
  }
  if (err == 0) {
    err = encode_map(&w.tk, &w.k_slots, p.k, D, p.Sk, p.H, p.B, p.k_ss,
                     p.k_sh, p.k_sb, T::BN);
  }
  if (err == 0) {
    err = encode_map(&w.tv, &w.v_slots, p.v, D, p.Sk, p.H, p.B, p.v_ss,
                     p.v_sh, p.v_sb, T::BN);
  }
  if (err != 0) return err;
  w.dk = p.dk;
  w.dv = p.dv;
  w.dq_acc = dq_acc;
  w.lse2 = lse2;
  w.delta = delta;
  w.lengths = p.lengths;
  w.seg_pad = nullptr;
  w.seg_range = nullptr;
  w.s_pad = 0;
  if constexpr (HAS_SEG) {
    w.s_pad = seg_pad_length(p.Sk);
    w.seg_pad = seg_scratch;
    w.seg_range = reinterpret_cast<int4*>(
        seg_scratch + static_cast<size_t>(p.B) * w.s_pad);
    err = launch_seg_ranges(p.seg, p.B, p.Sk, seg_scratch, stream);
    if (err != 0) return err;
  }
  w.dk_sb = p.dk_sb, w.dk_sh = p.dk_sh, w.dk_ss = p.dk_ss;
  w.dv_sb = p.dv_sb, w.dv_sh = p.dv_sh, w.dv_ss = p.dv_ss;
  w.H = p.H, w.Sq = p.Sq, w.Sk = p.Sk, w.sq_pad = sq_pad;
  w.scale = p.scale;
  w.scale_log2 = p.scale * kLog2e;
  const auto kernel = flash_bwd_wgmma_kernel<TE, D, CAUSAL, HAS_SEG>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM)));
  if (err != 0) return err;
  const dim3 grid(bh, (p.Sk + T::BN - 1) / T::BN);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(w);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t n = static_cast<size_t>(bh) * p.Sq * (D / 8);
  flash_bwd_dq_store_kernel<TE, D><<<static_cast<unsigned>((n + 255) / 256),
                                     256, 0, stream>>>(
      dq_acc, static_cast<TE*>(p.dq), p.dq_sb, p.dq_sh, p.dq_ss, p.H, p.Sq,
      sq_pad, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TE, int D>
int run_wgmma(const Params& p, const float* lse, float* scratch,
              int* seg_scratch, cudaStream_t s) {
  if (p.seg != nullptr) {
    return p.causal ? launch_bwd_wgmma<TE, D, true, true>(p, lse, scratch,
                                                          seg_scratch, s)
                    : launch_bwd_wgmma<TE, D, false, true>(p, lse, scratch,
                                                           seg_scratch, s);
  }
  return p.causal
             ? launch_bwd_wgmma<TE, D, true, false>(p, lse, scratch, nullptr, s)
             : launch_bwd_wgmma<TE, D, false, false>(p, lse, scratch, nullptr,
                                                     s);
}

template <typename TE>
int run_wgmma_d(const Params& p, const float* lse, float* scratch,
                int* seg_scratch, cudaStream_t s) {
  return p.D == 64 ? run_wgmma<TE, 64>(p, lse, scratch, seg_scratch, s)
                   : run_wgmma<TE, 128>(p, lse, scratch, seg_scratch, s);
}

template <typename T, int DC, int R, int KL>
int run_scalar(const Params& p, cudaStream_t s) {
  using Tile = ScalarTile<R, KL>;
  const int rows = (p.Sq + Tile::BR - 1) / Tile::BR;
  const int keys = (p.Sk + Tile::BR - 1) / Tile::BR;
  int err = launch(flash_bwd_delta_rows_kernel<T>, p, q_tiles(p), kThreads,
                   0, s);
  if (err == 0) {
    err = launch(flash_bwd_dkdv_kernel<T, DC, R, KL>, p, keys, kThreads,
                 Tile::dkdv_smem(p.D), s);
  }
  if (err == 0) {
    err = launch(flash_bwd_dq_kernel<T, DC, R, KL>, p, rows, kThreads,
                 Tile::dq_smem(p.D), s);
  }
  return err;
}

// the narrow tiles up to D = 128, the medium ones up to 256, the wide ones
// past it, in chunks of 64 columns (19 chunks of 32 for the last 12)
template <typename T>
int run_scalar_d(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return run_scalar<T, 2, 8, 2>(p, s);
  if (p.D <= kNarrowD) return run_scalar<T, 4, 8, 2>(p, s);
#define MXT_WIDE(DC, R, KL) \
  if (p.D <= 32 * (DC)) return run_scalar<T, DC, R, KL>(p, s);
  MXT_WIDE(6, 4, 2)
  MXT_WIDE(8, 4, 2)
  MXT_WIDE(10, 2, 1)
  MXT_WIDE(12, 2, 1)
  MXT_WIDE(14, 2, 1)
  MXT_WIDE(16, 2, 1)
  MXT_WIDE(18, 2, 1)
  MXT_WIDE(19, 2, 1)
#undef MXT_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
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

// The Hopper variant reads q, k, v and dO through TMA maps, o (K0) and
// writes dq (K2) in 16-byte vectors, and writes dk and dv in 4-byte pairs.
bool wgmma_aligned(const Params& p) {
  const auto a4 = [](const void* ptr, long long sb, long long sh,
                     long long ss) {
    return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && sb % 2 == 0 &&
           sh % 2 == 0 && ss % 2 == 0;
  };
  return tma_operand(p.q, p.q_sb, p.q_sh, p.q_ss, p.B, p.H, p.Sq) &&
         tma_operand(p.k, p.k_sb, p.k_sh, p.k_ss, p.B, p.H, p.Sk) &&
         tma_operand(p.v, p.v_sb, p.v_sh, p.v_ss, p.B, p.H, p.Sk) &&
         tma_operand(p.dout, p.do_sb, p.do_sh, p.do_ss, p.B, p.H, p.Sq) &&
         tma_operand(p.o, p.o_sb, p.o_sh, p.o_ss, p.B, p.H, p.Sq) &&
         tma_operand(p.dq, p.dq_sb, p.dq_sh, p.dq_ss, p.B, p.H, p.Sq) &&
         a4(p.dk, p.dk_sb, p.dk_sh, p.dk_ss) &&
         a4(p.dv, p.dv_sb, p.dv_sh, p.dv_ss);
}

// A call's Params from the C entry points' arguments (lse and delta are
// set by the caller).
Params make_params(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, const long long* strides, int B, int H, int Sq,
                   int Sk, int D, float scale, int causal) {
  Params p;
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout;
  p.dq = dq, p.dk = dk, p.dv = dv;
  p.lse = nullptr, p.delta = nullptr, p.lengths = nullptr, p.seg = nullptr;
  long long* dst[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,
                        &p.k_ss,  &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,
                        &p.o_sh,  &p.o_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                        &p.dq_sb, &p.dq_sh, &p.dq_ss, &p.dk_sb, &p.dk_sh,
                        &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.D = D;
  p.causal = causal != 0;
  p.scale = scale;
  return p;
}

// The variant a call takes, by dtype, D and alignment: 2 the Hopper one
// (D = 64, 128), 1 mma.sync (D = 64, 128, 256), 0 CUDA cores; -1 where
// route 1 asks for mma.sync and it does not apply.
int pick_variant(const Params& p, int dtype, int route) {
  const bool tc = dtype != 0 && (p.D == 64 || p.D == 128);
  if (route == 0 && tc && wgmma_aligned(p)) return 2;
  if ((tc || (dtype != 0 && p.D == 256)) && mma_aligned(p)) return 1;
  return route == 0 ? 0 : -1;
}

// fp32 scratch of a variant: the Hopper one's lse2 and delta rows of
// (B * H, sq_pad) and its dQ accumulator (B * H, sq_pad, D); the earlier
// two's delta, (B, H, Sq)
size_t scratch_floats(int variant, int B, int H, int Sq, int D) {
  const size_t rows = static_cast<size_t>(B) * H;
  return variant == 2 ? rows * sq_pad_of(Sq) * (2 + D) : rows * Sq;
}

}  // namespace

extern "C" {

// strides: 24 element strides (batch, head, row) of q, k, v, o, dout, dq,
// dk and dv; the head dim of each is contiguous. lse: the forward's
// (B, H, Sq) fp32 row logsumexps (natural log), contiguous on the card;
// every variant reads them. scratch: flash_attention_backward_scratch_floats
// of the same arguments, fp32 on the card, 16-byte aligned. seg_scratch:
// with segment_ids, the forward library's
// flash_attention_seg_scratch_ints(B, Sk) int32, 16-byte aligned (the
// Hopper variant's tile skipping writes it), else null. lengths (B,) and
// segment_ids (B, Sk) are int32 on the card, or null. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. D: 1 to kMaxD (588). route: 0 picks the
// variant by dtype, D and alignment; 1 takes the mma.sync variant wherever
// it applies (bf16 or fp16, D = 64 or 128, aligned rows), so that it can
// be timed beside the Hopper one. *variant
// is set to the variant launched: 0 the CUDA-core one, 1 mma.sync, 2
// wgmma. Returns the cudaError_t of the first launch that failed,
// kCuBase + a CUresult of the TMA map encoding, or 0.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const void* lse,
                             void* scratch, void* seg_scratch,
                             const void* lengths, const void* segment_ids,
                             const long long* strides, int B, int H, int Sq,
                             int Sk, int D, float scale, int causal, int dtype,
                             int route, int* variant, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      B * H > 65535 || (segment_ids != nullptr && Sq != Sk) || dtype < 0 ||
      dtype > 2 || (causal != 0 && Sq > Sk) || route < 0 || route > 1 ||
      lse == nullptr || scratch == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = make_params(q, k, v, o, dout, dq, dk, dv, strides, B, H, Sq, Sk,
                         D, scale, causal);
  p.lse = static_cast<const float*>(lse);
  p.lengths = static_cast<const int*>(lengths);
  p.seg = static_cast<const int*>(segment_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  const bool half = dtype == 2;
  switch (*variant = pick_variant(p, dtype, route)) {
    case 2: {
      int* seg = static_cast<int*>(seg_scratch);
      if (segment_ids != nullptr &&
          (seg == nullptr || reinterpret_cast<uintptr_t>(seg) % 16)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return half ? run_wgmma_d<__half>(p, p.lse, f, seg, s)
                  : run_wgmma_d<bf16>(p, p.lse, f, seg, s);
    }
    case 1:
      p.delta = f;
      return half ? run_mma_d<__half>(p, s) : run_mma_d<bf16>(p, s);
    case 0:
      p.delta = f;
      if (D > kWideD && (WideTile::dkdv_smem(D) > kMaxSharedBytes ||
                         WideTile::dq_smem(D) > kMaxSharedBytes)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (dtype == 0) return run_scalar_d<float>(p, s);
      return half ? run_scalar_d<__half>(p, s) : run_scalar_d<bf16>(p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32 scratch floats of a backward with these arguments (those of
// flash_attention_backward): what the variant it takes needs
size_t flash_attention_backward_scratch_floats(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const long long* strides,
    int B, int H, int Sq, int Sk, int D, int dtype, int route) {
  const Params p = make_params(q, k, v, o, dout, dq, dk, dv, strides, B, H,
                               Sq, Sk, D, 0.f, 0);
  return scratch_floats(pick_variant(p, dtype, route), B, H, Sq, D);
}

// the sizes of the Hopper variant's shared memory, D = 64 and 128
size_t flash_attention_backward_wgmma_smem_bytes(int d) {
  return d == 64 ? BwdTile<64>::SMEM : d == 128 ? BwdTile<128>::SMEM : 0;
}

const char* flash_attention_backward_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
