// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces two TPU kernels of mxnet_tpu/ops/pallas/attention.py:
//   _flash_kernel         (launched by _flash_attention_dense, B2), and
//   _flash_kernel_masked  (launched by _masked_attention, B3).
// Each of the three variants below computes what those kernels compute
// (the older two switched by CAUSAL, HAS_LEN and HAS_SEG): exact softmax attention over
// (B, H, S, D) with an online softmax over K/V tiles, fp32 running max m,
// normalizer l and accumulator, the scale applied in fp32 (to q before the
// product, or to the scores after it: they differ only in rounding), the
// causal diagonal at kpos <= qpos + (Sk - Sq), per-batch key lengths
// (kpos < len), packed segment ids (seg_q == seg_k and seg_q > 0), p zeroed
// where the mask is false (so rows that see no key come out exact 0), the
// normalizer floored at 1e-30, and the output in q's dtype. Asked for it
// (training), each variant also writes every row's logsumexp
// lse = m + log(max(l, 1e-30)), so that the backward
// (flash_attention_bwd.cu) need not recompute it.
//
// Bound. A launch must read q, k and v once and write o once, and must do
// 4*D operations for every (query, key) pair the mask keeps alive. At the
// transformer's shapes (B=4, H=8, S=2048, D=64, causal, bf16) that is
// 33.6 MB against 17.2 GFLOP: 10.0 us by bytes at 3.35 TB/s, 17.4 us by
// operations at the 989 TFLOP/s bf16 tensor-core peak. Operations bound it,
// so the tensor cores have to be kept busy: on Hopper only wgmma reaches
// their full rate, and only if the loads and the softmax hide behind it.
//
// Three variants, all with no score matrix leaving the block, K tiles
// wholly above the causal diagonal (or past the batch element's length)
// skipped, and strides as arguments, so that the transposed (B, S, H, D)
// views the transformer makes are read in place. Each takes every dtype
// the JAX kernel takes in 16 bits, bf16 and fp16 (one template over the
// element type: the tensor-core products in their .bf16 or .f16 form, P
// rounded to the inputs' type before the P V product); fp32 runs on CUDA
// cores:
//
// - the Hopper variant (flash_fwd_wgmma_kernel), taken for the dense core
//   (B2) and the masked core (B3: key lengths, segment ids) in bf16 or
//   fp16 with D = 64 or 128 when TMA can describe q, k and v: one block of a TMA
//   producer warpgroup and three wgmma consumer warpgroups per
//   (batch*head, 192 query rows), K/V tiles (128 keys at D = 64, 64 at
//   D = 128) in a ring of 3 stages guarded by mbarriers, S = Q K^T and
//   O += P V as wgmma with P fed from registers; tiles past a batch
//   element's length, and tiles whose segment ids cannot meet the query
//   tile's, are neither loaded nor computed. Its design and what each part
//   answers are set out above the kernel;
// - the mma.sync tensor-core variant (flash_fwd_mma_kernel), kept for
//   views TMA cannot take (and, through route 1, for timing beside the
//   Hopper one), bf16 or fp16 with D = 64 or 128 and 16-byte aligned
//   rows, and the variant for D = 256 (see below): one block of 4 warps of 16 query rows
//   per (batch*head, 64 rows), mma.sync m16n8k16 (the Ampere instruction,
//   below the wgmma rate on Hopper), K/V double buffered by cp.async from
//   the computing threads, read by ldmatrix; the tensor cores idle while
//   the softmax runs. It measured 0.10 of the bound at the shape above
//   with lengths (PERF.md);
// - the CUDA-core variant (flash_fwd_kernel) for fp32, for every other D
//   and for unaligned views: 8 warps of 8 query rows, q (times scale),
//   K and V staged as fp32, a lane scoring 2 keys with fp32 FMAs, p through
//   shared memory, a lane accumulating D/32 output columns. It runs at the
//   fp32 rate (67 TFLOP/s), far below the tensor-core bound. Past D = 128
//   the masks are read at run time rather than compiled in (the D-long
//   dot products dwarf the test); past D = 256 its tiles shrink to 32
//   query rows (4 a warp) and 32 keys (one a lane), so that q, K and V
//   staged as fp32 fit in 227 KB up to D = 592. The backward's CUDA-core tiles stop at
//   D = 588 (flash_attention_bwd.cu), so the library takes D up to 588:
//   kMaxD.
//
// Head dims past 128 (B5). At D = 256 a 64-row fp32 output accumulator is
// 128 registers a thread of a warpgroup, on top of the score tile and the
// P fragments; the wgmma kernel's three consumer warpgroups would have to
// become one or two with a new register split and four 64-column TMA boxes
// a row. The mma.sync variant takes D = 256 with no new layout: a warp's
// 16 rows hold their 16 x 256 fp32 output (128 registers) and its 16 x 64
// scores; Q's fragments, 64 more registers at D = 256, are read again from
// shared memory by ldmatrix for every K tile instead of being kept. Its
// tiles (64 query rows, two 64-key K and V stages, bf16 or fp16) take
// 169,728 bytes. So bf16 and fp16 at D = 256 run on mma.sync tensor cores
// (below the wgmma rate), and every other D past 128 on CUDA cores.
//
// The library links the CUDA driver (-lcuda) for cuTensorMapEncodeTiled:
// the Hopper variant's tensor maps are encoded on the host at each call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper_tma.cuh"

namespace {

constexpr int kBlockQ = 64;                   // query rows of a block
constexpr int kBlockK = 64;                   // keys of a K/V tile
constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowD = 128;  // CUDA-core masks compiled in up to it
constexpr int kWideD = 256;    // the CUDA-core variant's 32-row tiles past it
constexpr int kMaxD = 588;     // the backward's CUDA-core tiles' limit
constexpr size_t kMaxSharedBytes = 232448;    // 227 KB, the most a block may use
constexpr float kNeg = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;  // lse from log2 units

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;           // (B, H, Sq) row logsumexps, contiguous, or null
  const int* lengths;   // (B,) key lengths, or null
  const int* seg;       // (B, S) segment ids, contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Sq, Sk, D;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
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
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
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

// The masks a kernel applies: each template flag may compile a mask out,
// and a kernel compiled with a flag on still reads whether the call has
// that mask (p.causal, a lengths or ids pointer), so that one
// instantiation can serve every mask where the test costs little.
template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
struct Masks {
  bool causal, len, seg;
  __device__ __forceinline__ explicit Masks(const Params& p)
      : causal(CAUSAL && p.causal != 0),
        len(HAS_LEN && p.lengths != nullptr),
        seg(HAS_SEG && p.seg != nullptr) {}
};

// Whether query row `row` attends to key `key`: in bounds, on or below the
// causal diagonal, before the batch element's key length, and in the same
// nonzero segment.
template <typename M>
__device__ __forceinline__ bool attends(const Params& p, const M& mk, int row,
                                        int key, int len, int seg_row,
                                        int seg_key) {
  bool ok = key < p.Sk;
  if (mk.causal) ok = ok && key <= row + (p.Sk - p.Sq);
  if (mk.len) ok = ok && key < len;
  if (mk.seg) ok = ok && seg_row > 0 && seg_key == seg_row;
  return ok;
}

// q and v tile row stride in shared memory: D rounded up to 4 floats (zero
// padded), so rows are read as float4 and every array stays 16-byte
// aligned. K rows get 4 more floats, so the 8 lanes of a quarter warp
// reading one float4 column of 8 keys hit distinct banks.
__host__ __device__ inline int row_stride(int d) { return (d + 3) & ~3; }

// The CUDA-core variant's tiles: R query rows a warp (kWarps * R a block)
// and KL keys a lane (32 * KL a K/V tile). Up to kWideD: 64 and 64; past
// it 32 and 32, so that D up to 592 fits in shared memory.
template <int R, int KL>
struct ScalarTile {
  static constexpr int BQ = kWarps * R;
  static constexpr int BK = 32 * KL;
  static size_t smem(int d) {
    const size_t ldq = row_stride(d);
    return sizeof(float) * (BQ * ldq + BK * (ldq + 4) + BK * ldq +
                            static_cast<size_t>(BQ) * BK) +
           sizeof(int) * (BQ + BK);
  }
};
using NarrowTile = ScalarTile<8, 2>;
using WideTile = ScalarTile<4, 1>;

// DC: 32-wide column chunks of the output a lane holds (D <= 32 * DC).
template <typename T, int DC, int R, int KL, bool CAUSAL, bool HAS_LEN,
          bool HAS_SEG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int BQ = ScalarTile<R, KL>::BQ, BK = ScalarTile<R, KL>::BK;
  extern __shared__ __align__(16) float smem[];
  const Masks<CAUSAL, HAS_LEN, HAS_SEG> mk(p);
  const int D = p.D;
  const int ldq = row_stride(D);
  const int ldk = ldq + 4;
  float* q_s = smem;                          // [BQ][ldq], times scale
  float* k_s = q_s + BQ * ldq;                // [BK][ldk]
  float* v_s = k_s + BK * ldk;                // [BK][ldq]
  float* p_s = v_s + BK * ldq;                // [BQ][BK]
  int* seg_q = reinterpret_cast<int*>(p_s + BQ * BK);
  int* seg_k = seg_q + BQ;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * R;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* seg = mk.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;

  for (int i = tid; i < BQ * ldq; i += kThreads) {
    const int r = i / ldq, c = i % ldq;
    const int row = q0 + r;
    q_s[i] = (row < p.Sq && c < D)
                 ? to_float(q[row * p.q_ss + c]) * p.scale
                 : 0.f;
  }
  if (mk.seg) {
    for (int i = tid; i < BQ; i += kThreads) {
      seg_q[i] = q0 + i < p.Sq ? seg[q0 + i] : 0;
    }
  }

  // keys this block can see: none past the length, none above the
  // diagonal of its last row
  const int len = mk.len ? p.lengths[b] : p.Sk;
  int n_keys = p.Sk;
  if (mk.len) n_keys = min(n_keys, max(len, 0));
  if (mk.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    n_keys = min(n_keys, last_row + (p.Sk - p.Sq) + 1);
  }
  const int n_tiles = (n_keys + BK - 1) / BK;

  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  float* p_w = p_s + r0 * BK;  // this warp's rows of p

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * ldq; i += kThreads) {
      const int r = i / ldq, c = i % ldq;
      const int key = k0 + r;
      const bool in = key < p.Sk && c < D;
      k_s[r * ldk + c] = in ? to_float(k[key * p.k_ss + c]) : 0.f;
      v_s[r * ldq + c] = in ? to_float(v[key * p.v_ss + c]) : 0.f;
    }
    if (mk.seg) {
      for (int i = tid; i < BK; i += kThreads) {
        seg_k[i] = k0 + i < p.Sk ? seg[k0 + i] : 0;
      }
    }
    __syncthreads();

    // scores of keys lane + 32 j (j < KL) for the warp's rows
    float s[R][KL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KL; ++j) s[r][j] = 0.f;
    }
    for (int c = 0; c < ldq; c += 4) {
      float4 kv[KL];
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(k_s + (lane + 32 * j) * ldk +
                                                 c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (r0 + r) * ldq + c);
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          s[r][j] += qv.x * kv[j].x + qv.y * kv[j].y + qv.z * kv[j].z +
                     qv.w * kv[j].w;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + r0 + r;
      bool live[KL];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const bool ok = attends(p, mk, row, k0 + lane + 32 * j, len,
                                mk.seg ? seg_q[r0 + r] : 0,
                                mk.seg ? seg_k[lane + 32 * j] : 0);
        live[j] = ok;
        mx = fmaxf(mx, ok ? s[r][j] : kNeg);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      // p is zeroed where the mask is false: while every key so far is
      // masked, m_new == kNeg and exp(s - m_new) would be 1
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KL; ++j) {
        const float pv = live[j] ? expf(s[r][j] - m_new) : 0.f;
        p_w[r * BK + lane + 32 * j] = pv;
        sum += pv;
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // O += P V: 4 keys at a time, each V value read once for all R rows
    for (int j = 0; j < BK; j += 4) {
      float4 pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pv[r] = *reinterpret_cast<const float4*>(p_w + r * BK + j);
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        float vv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          vv[jj] = d < D ? v_s[(j + jj) * ldq + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][c] += pv[r].x * vv[0] + pv[r].y * vv[1] + pv[r].z * vv[2] +
                       pv[r].w * vv[3];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
    const float norm = fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && lane == 0) {  // natural log: q was scaled
      p.lse[(static_cast<size_t>(b) * p.H + h) * p.Sq + row] =
          m[r] + logf(norm);
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[row * p.o_ss + d] = from_float<T>(acc[r][c] / norm);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core variant: bf16 or fp16 inputs (T), D = 64, 128 or 256,
// 16-byte aligned rows. One block of 4 warps per (batch*head, tile of 64
// query rows); a warp owns 16 rows. Scores S = Q K^T and the output
// O += P V are mma.sync m16n8k16 products in T with fp32 accumulation; the
// warp holds its Q fragments (up to D = 128; at 256 it reads them from
// shared memory a K tile), its 16 x 64 score tile and its 16 x D output in
// registers, and the online
// softmax runs on the score fragments (a row spans the 4 lanes of a quad),
// in log2 units so that exp2 serves. K and V tiles (rows padded by 16
// bytes, so that ldmatrix rows fall in distinct banks) are double
// buffered: cp.async loads tile kt + 1 while tile kt computes. ldmatrix
// reads the K fragments, and with .trans the V fragments of the row-major
// V tile. Tiles no mask touches skip the per-score mask. The scale
// multiplies the fp32 scores (it is inexact in bf16 for D = 128), and p is
// rounded to T for the P V product, as tensor-core flash attention does.

constexpr int kMmaThreads = 128;  // 4 warps of 16 query rows

__device__ __forceinline__ uint32_t ld_pair(const void* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// c += a . b for a 16 x 16 A of T (row-major fragment), a 16 x 8 B of T
// (column-major fragment) and a 16 x 8 fp32 C; T bf16 or fp16.
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

// Four 8 x 8 b16 matrices from shared memory; lanes 8m..8m+7 give the row
// addresses of matrix m, and r[m] holds this lane's fragment of it (of its
// transpose with .trans).
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

// q tile, two K and two V tiles of 16-bit values (rows padded by 16
// bytes), segment ids
template <int D>
constexpr size_t mma_shared_bytes() {
  return sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) * (D + 8) +
         sizeof(int) * (kBlockQ + 2 * kBlockK);
}

template <typename T, int D, bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;          // row stride of the q, k and v tiles
  constexpr int KC = D / 16;         // 16-wide chunks of the head dim
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  constexpr int NK = kBlockK / 8;    // 8-key tiles of the scores
  constexpr int V8 = D / 8;          // 16-byte vectors in a row
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr bool kQRegs = D <= 128;  // Q's fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Masks<CAUSAL, HAS_LEN, HAS_SEG> mk(p);
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kBlockQ][LD]
  T* k_s = q_s + kBlockQ * LD;                 // [2][kBlockK][LD]
  T* v_s = k_s + 2 * kBlockK * LD;             // [2][kBlockK][LD]
  int* seg_q = reinterpret_cast<int*>(v_s + 2 * kBlockK * LD);
  int* seg_k = seg_q + kBlockQ;                   // [2][kBlockK]

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest rows first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row (and key) within 8
  const int t = lane % 4;   // fragment column pair
  const int lm = lane / 8;  // the ldmatrix matrix this lane addresses
  const int lr = lane % 8;  // and its row in it
  const int wr = warp * 16;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* seg = mk.seg ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;

  const int len = mk.len ? p.lengths[b] : p.Sk;
  int n_keys = p.Sk;
  if (mk.len) n_keys = min(n_keys, max(len, 0));
  if (mk.causal) {
    const int last_row = min(q0 + kBlockQ, p.Sq) - 1;
    n_keys = min(n_keys, last_row + (p.Sk - p.Sq) + 1);
  }
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;

  // K/V tile kt into buffer buf, by cp.async; rows past Sk are zeros
  const auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlockK;
    T* kd = k_s + buf * kBlockK * LD;
    T* vd = v_s + buf * kBlockK * LD;
    for (int i = tid; i < kBlockK * V8; i += kMmaThreads) {
      const int r = i / V8, c = (i % V8) * 8;
      const bool in = k0 + r < p.Sk;
      const int key = in ? k0 + r : 0;
      cp_async_16(kd + r * LD + c, k + key * p.k_ss + c, in);
      cp_async_16(vd + r * LD + c, v + key * p.v_ss + c, in);
    }
    if (mk.seg) {
      for (int i = tid; i < kBlockK; i += kMmaThreads) {
        seg_k[buf * kBlockK + i] = k0 + i < p.Sk ? seg[k0 + i] : 0;
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);  // in flight while q is staged

  for (int i = tid; i < kBlockQ * V8; i += kMmaThreads) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.Sq) {
      val = *reinterpret_cast<const uint4*>(q + (q0 + r) * p.q_ss + c);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c) = val;
  }
  if (mk.seg) {
    for (int i = tid; i < kBlockQ; i += kMmaThreads) {
      seg_q[i] = q0 + i < p.Sq ? seg[q0 + i] : 0;
    }
  }
  __syncthreads();

  // the A fragment of Q's 16-wide chunk kc for the warp's 16 rows
  const auto q_frag = [&](uint32_t (&a)[4], int kc) {
    const T* base = q_s + (wr + g) * LD + kc * 16 + 2 * t;
    a[0] = ld_pair(base);
    a[1] = ld_pair(base + 8 * LD);
    a[2] = ld_pair(base + 8);
    a[3] = ld_pair(base + 8 * LD + 8);
  };
  uint32_t qa[kQRegs ? KC : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) q_frag(qa[kc], kc);
  }
  const int row_a = q0 + wr + g;  // this lane's two rows
  const int row_b = row_a + 8;
  const int seg_a = mk.seg ? seg_q[wr + g] : 0;
  const int seg_b = mk.seg ? seg_q[wr + g + 8] : 0;
  // scores are kept in log2 units, so that exp2 gives the softmax's exp
  const float scale_log2 = p.scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;  // l: this lane's part

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * kBlockK;
    if (kt + 1 < n_tiles) {  // the next tile loads while this one computes
      load_kv(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in shared memory for every warp
    // a tile wholly above this warp's part of the diagonal adds nothing
    if (!mk.causal || k0 <= q0 + wr + 15 + (p.Sk - p.Sq)) {
      const T* kb = k_s + buf * kBlockK * LD;
      const T* vb = v_s + buf * kBlockK * LD;
      const int* sk = seg_k + buf * kBlockK;
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
        uint32_t a0[4], a1[4];  // Q's fragments of chunks kc and kc + 1
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a0[e] = qa[kc][e], a1[e] = qa[kc + 1][e];
        } else {
          q_frag(a0, kc);
          q_frag(a1, kc + 1);
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          uint32_t kf[4];  // B fragments of chunks kc and kc + 1
          ldmatrix_x4(kf, kb + (n * 8 + lr) * LD + kc * 16 + lm * 8);
          mma_16816<T>(s[n], a0, kf[0], kf[1]);
          mma_16816<T>(s[n], a1, kf[2], kf[3]);
        }
      }

      // no key of the tile is masked for any row of the warp
      const bool full =
          !mk.seg && k0 + kBlockK <= p.Sk &&
          (!mk.len || k0 + kBlockK <= len) &&
          (!mk.causal || k0 + kBlockK - 1 <= q0 + wr + (p.Sk - p.Sq));
      unsigned live = 0u;  // bit 4n + e: score s[n][e] is attended
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = n * 8 + 2 * t + (e & 1);
          const bool ok =
              full || attends(p, mk, e < 2 ? row_a : row_b, k0 + kk, len,
                              e < 2 ? seg_a : seg_b, mk.seg ? sk[kk] : 0);
          live |= static_cast<unsigned>(ok) << (4 * n + e);
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
      const float alpha_a = exp2f(m_a - mn_a);
      const float alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // p is zeroed where the mask is false (see the scalar kernel)
          const float pv = (live >> (4 * n + e)) & 1u
                               ? exp2f(s[n][e] - (e < 2 ? mn_a : mn_b))
                               : 0.f;
          s[n][e] = pv;
          if (e < 2) {
            sum_a += pv;
          } else {
            sum_b += pv;
          }
        }
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[nd][0] *= alpha_a;
        acc[nd][1] *= alpha_a;
        acc[nd][2] *= alpha_b;
        acc[nd][3] *= alpha_b;
      }
#pragma unroll
      for (int j = 0; j < kBlockK / 16; ++j) {
        const uint32_t pa[4] = {pack2<T>(s[2 * j][0], s[2 * j][1]),
                                pack2<T>(s[2 * j][2], s[2 * j][3]),
                                pack2<T>(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack2<T>(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t vf[4];  // B fragments of column tiles nd and nd + 1
          ldmatrix_x4_trans(
              vf, vb + (j * 16 + lr + 8 * (lm & 1)) * LD + (nd + lm / 2) * 8);
          mma_16816<T>(acc[nd], pa, vf[0], vf[1]);
          mma_16816<T>(acc[nd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer buf before its reload
  }

  const float norm_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float norm_b = fmaxf(quad_sum(l_b), 1e-30f);
  if (p.lse != nullptr && t == 0) {  // m is in log2 units
    float* lse = p.lse + (static_cast<size_t>(b) * p.H + h) * p.Sq;
    if (row_a < p.Sq) lse[row_a] = (m_a + log2f(norm_a)) * kLn2;
    if (row_b < p.Sq) lse[row_b] = (m_b + log2f(norm_b)) * kLn2;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < p.Sq) {
      store2<T>(o + row_a * p.o_ss + col, acc[nd][0] / norm_a,
                acc[nd][1] / norm_a);
    }
    if (row_b < p.Sq) {
      store2<T>(o + row_b * p.o_ss + col, acc[nd][2] / norm_b,
                acc[nd][3] / norm_b);
    }
  }
}

// ---------------------------------------------------------------------------
// The Hopper variant (flash_fwd_wgmma_kernel): bf16 or fp16 (TE), D = 64
// or 128, the
// dense and the masked core, q, k and v views that TMA can describe
// (16-byte aligned bases, strides of whole 16-byte units).
//
// One block of 4 warpgroups per (batch*head, tile of 192 query rows):
// - warpgroup 0 is the producer (its registers handed to the consumers by
//   setmaxnreg): one thread loads the Q tile and then the K and V tiles of
//   the block into a ring of kStages stages by TMA (4-D tensor maps over
//   (D, S, H, B), so that a ragged tile edge reads TMA's zeros and never
//   the next head's rows), each stage guarded by a "full" mbarrier (the
//   TMA's bytes) and an "empty" one (the consumers' release);
// - warpgroups 1-3 are consumers of 64 query rows each: S = Q K^T as
//   wgmma with Q and K read from shared memory through 128-byte-swizzled
//   matrix descriptors, the online softmax on the accumulator fragment in
//   registers (a row spans a quad of lanes; exp2, the scale in log2
//   units), P packed to TE in registers and fed as wgmma's register A
//   operand for O += P V with V read as stored (MN-major, the descriptor's
//   transpose bit). S of tile kt is issued with P V of tile kt - 1, so the
//   tensor cores run the latter while the softmax of kt runs. A consumer
//   releases a stage once its wgmmas on it have retired; only then does
//   the producer load into it again. The three consumers run
//   unsynchronised, so that the tensor cores take one's products while
//   the others' softmax runs; three measured faster than two (with or
//   without named barriers making two take turns), though ptxas then
//   holds a consumer to 128 registers and spills a few bytes.
// K tiles wholly above a consumer's causal diagonal are skipped by that
// consumer; the producer loads no tile that neither needs. Tiles no mask
// touches take a softmax without the per-score mask. Keys past Sk (TMA's
// zero rows) are masked by the key < Sk predicate; rows past Sq are
// computed on zeros and not stored.
//
// The masked core (B3) runs on the same pipeline:
// - key lengths are a runtime cut, read once a block: producer and
//   consumers stop at ceil(len / BK) tiles as at the diagonal, and keys
//   at or past len are masked. A block with no tile left (len = 0) loads
//   nothing, not even its Q tile, waits on no barrier, and writes 0;
// - segment ids (HAS_SEG) skip whole tiles: seg_ranges_kernel first sums
//   up the ids of every 64 positions of each row (smallest and largest
//   positive id, and the one id that fills the chunk), on the device. The
//   producer loads a K tile only if its id range meets the block's Q
//   range; the consumers walk the same sequence of loads (one predicate,
//   so that the stage ring stays in step) and compute, of those, the ones
//   from the first to the last whose range meets their own 64 rows'. The
//   range test only drops tiles in which no pair can match, so the result
//   is the same for ids in any order. The producer stages each K tile's
//   ids by a bulk copy into the stage's shared memory (512 bytes at
//   BK = 128), where a masked tile's softmax reads them; each lane keeps
//   its two rows' ids in registers. A tile takes the unmasked softmax only
//   if its keys and the consumer's 64 rows all hold one id;
// - under segments a row may see no live key for some tiles (a pad row, a
//   row whose first tiles hold another segment), so m can still be kNeg
//   after a tile and exp2(kNeg - kNeg) would be 1: p is zeroed there, as
//   the mask says, and a row that never sees a key writes exact 0.
//
// What holds it back (PERF.md): at D = 64 a score costs the softmax about
// as much issue and special-function time (one exp2 per score) as the
// tensor cores spend on its 4 D products, and the consumers overlap the
// two only in part; each block also pays its pipeline's fill and drain.

constexpr int kConsumers = 3;    // consumer warpgroups, 64 query rows each
constexpr int kWgThreads = 128 * (1 + kConsumers);  // and the producer
constexpr int kWgBlockQ = 64 * kConsumers;  // query rows of a block
constexpr int kStages = 3;       // K/V stages in the ring

template <int D>
struct WgTile {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys of a K/V tile
  static constexpr int PANELS = D / 64;          // 128-byte column panels
  static constexpr int Q_PANEL = kWgBlockQ * kPanelBytes;
  static constexpr int KV_PANEL = BK * kPanelBytes;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 64;         // 1 + 2 * kStages mbarriers
  static constexpr int SEG_BYTES = BK * 4;     // a K tile's segment ids
  // tiles, then the mbarriers, then each stage's segment ids, plus slack
  // to align the tiles to the 1024 bytes that the 128-byte swizzle
  // repeats over
  static constexpr size_t SMEM = 1024 + Q_BYTES + kStages * STAGE_BYTES +
                                 BAR_BYTES + kStages * SEG_BYTES;
};

struct WgParams {
  CUtensorMap tq, tk, tv;  // 4-D maps over q, k and v (see encode_map)
  void* o;
  float* lse;              // (B, H, Sq) row logsumexps, or null
  const int* lengths;      // (B,) key lengths, or null
  const int* seg_pad;      // (B, s_pad) segment ids, zeros past S (HAS_SEG)
  const int4* seg_range;   // (B, s_pad / kSegChunk) of (lo, hi, uni, 0)
  long long o_sb, o_sh, o_ss;
  int H, Sq, Sk, s_pad;
  int q_slots, k_slots, v_slots;  // where S, H and B sit in each map
  float scale_log2;
};

template <typename TE, int D, bool CAUSAL, bool HAS_SEG>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using T = WgTile<D>;
  constexpr int BK = T::BK;
  constexpr int NS = BK / 2;  // score accumulator floats of a thread
  constexpr int CPT = BK / kSegChunk;  // id chunks of a K tile
  constexpr bool F16 = kIsF16<TE>;     // the .f16 products, else .bf16
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats over 1024 bytes: tiles start on such a
  // boundary, so that TMA's and wgmma's swizzles agree
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::Q_BYTES;  // stage s: K, then V
  const uint32_t q_full = kv_s + kStages * T::STAGE_BYTES;
  const uint32_t seg_s = q_full + T::BAR_BYTES;  // stage s's key ids
  const auto full = [&](int s) { return q_full + 8u * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  // the longest causal tiles first, for every head in the first wave
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgBlockQ;
  const int shift = p.Sk - p.Sq;  // the causal diagonal: key <= row + shift
  // keys at or past the batch element's length are masked, and tiles
  // wholly past it are not loaded
  const int len =
      p.lengths != nullptr ? min(max(p.lengths[b], 0), p.Sk) : p.Sk;
  // K/V tiles that rows up to `last` attend to
  const auto tiles_to = [&](int last) {
    const int keys = CAUSAL ? min(len, last + shift + 1) : len;
    return (keys + BK - 1) / BK;
  };
  const int n_tiles = tiles_to(min(q0 + kWgBlockQ, p.Sq) - 1);

  // Segment tile skipping: (lo, hi) of the positive ids of `count` chunks
  // of rows from chunk `first` (none past Sq), and (lo, hi, uni) of K tile
  // kt. A K tile is loaded only if its range meets the block's Q range;
  // producer and consumers evaluate that one predicate, so that they walk
  // the same sequence of loads through the stage ring.
  const int4* ranges = HAS_SEG ? p.seg_range + static_cast<size_t>(b) *
                                                   (p.s_pad / kSegChunk)
                               : nullptr;
  const auto q_range = [&](int first, int count) {
    int2 r = make_int2(INT_MAX, 0);
    for (int j = 0; j < count && (first + j) * kSegChunk < p.Sq; ++j) {
      const int4 x = __ldg(ranges + first + j);
      r.x = min(r.x, x.x);
      r.y = max(r.y, x.y);
    }
    return r;
  };
  const auto k_tile = [&](int kt) {
    int4 r = __ldg(ranges + kt * CPT);
#pragma unroll
    for (int j = 1; j < CPT; ++j) {
      const int4 x = __ldg(ranges + kt * CPT + j);
      r.x = min(r.x, x.x);
      r.y = max(r.y, x.y);
      r.z = r.z == x.z ? r.z : 0;
    }
    return r;
  };
  const int2 q_block = HAS_SEG ? q_range(q0 / kSegChunk, kConsumers)
                               : make_int2(0, 0);
  const auto loaded = [&](int kt) {
    return !HAS_SEG || ranges_meet(q_block, k_tile(kt));
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // the producer: one thread issues every load
    if constexpr (HAS_SEG) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    }
    // Load i (K/V tile kt) goes to stage i % kStages. The Q tile is
    // loaded with the first K/V tile: a block that loads none (no key
    // left by the length cut or the segments) leaves no copy in flight at
    // its exit.
    const auto issue = [&](int kt, int i) {
      if (i == 0) {
        mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
        for (int pn = 0; pn < T::PANELS; ++pn) {
          tma_load(q_s + pn * T::Q_PANEL, &p.tq, q_full, p.q_slots, 64 * pn,
                   q0, h, b);
        }
      }
      const int s = i % kStages;
      mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(full(s), T::STAGE_BYTES + (HAS_SEG ? T::SEG_BYTES : 0));
      const uint32_t ks = kv_s + s * T::STAGE_BYTES;
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        tma_load(ks + pn * T::KV_PANEL, &p.tk, full(s), p.k_slots, 64 * pn,
                 kt * BK, h, b);
        tma_load(ks + T::KV_BYTES + pn * T::KV_PANEL, &p.tv, full(s),
                 p.v_slots, 64 * pn, kt * BK, h, b);
      }
      if constexpr (HAS_SEG) {
        bulk_load(seg_s + s * T::SEG_BYTES,
                  p.seg_pad + static_cast<size_t>(b) * p.s_pad + kt * BK,
                  T::SEG_BYTES, full(s));
      }
    };
    if constexpr (HAS_SEG) {
      // warp 0 tests 32 tiles at a time, a lane each, and lane 0 issues
      // the loaded ones: one round trip for the ranges, not one a tile
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int i = 0;
        for (int base = 0; base < n_tiles; base += 32) {
          unsigned m = __ballot_sync(
              0xffffffffu, base + lane < n_tiles && loaded(base + lane));
          for (; m != 0u; m &= m - 1u, ++i) {
            if (lane == 0) issue(base + __ffs(m) - 1, i);
          }
        }
      }
    } else if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_tiles; ++kt) issue(kt, kt);
    }
    return;
  }
  // the consumers take the registers the producer gave back: 24 (32) +
  // 3 x 160 a thread over the four warpgroups, within the block's 4 x 128
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");

  // a consumer: 64 query rows, warp w of it rows 16w .. 16w + 15
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row within 8
  const int t4 = lane % 4;  // fragment column pair
  const int r0 = q0 + 64 * c;
  const int wr0 = r0 + 16 * warp;
  const int row_a = wr0 + g;  // this lane's two rows
  const int row_b = row_a + 8;
  const int my_tiles = r0 < p.Sq ? tiles_to(min(r0 + 64, p.Sq) - 1) : 0;
  const float sl2 = p.scale_log2;

  // The loaded tiles this consumer computes: from the first to the last
  // one below my_tiles whose ids can meet its rows' (a tile between them
  // that cannot is computed and masked whole). The rest it waits for and
  // releases unread, in load order, holding no stage meanwhile. Each warp
  // tests 32 tiles at a time, a lane each, and keeps the window's masks:
  // which tiles are loaded, and which hold only its rows' one id.
  int c_first = 0, c_last = my_tiles - 1;
  int seg_a = 0, seg_b = 0, q_uni = 0;  // this lane's rows' segments
  int win = -32;                         // the window's first tile
  unsigned win_loaded = 0u, win_uni = 0u;
  if constexpr (HAS_SEG) {
    const int* ids = p.seg_pad + static_cast<size_t>(b) * p.s_pad;
    seg_a = row_a < p.Sq ? __ldg(ids + row_a) : 0;
    seg_b = row_b < p.Sq ? __ldg(ids + row_b) : 0;
    if (r0 < p.Sq) q_uni = __ldg(ranges + r0 / kSegChunk).z;
    const int2 q_mine = q_range(r0 / kSegChunk, 1);
    c_first = my_tiles;
    c_last = -1;
    for (int base = 0; base < my_tiles; base += 32) {
      const unsigned m = __ballot_sync(
          0xffffffffu, base + lane < my_tiles &&
                           ranges_meet(q_mine, k_tile(base + lane)));
      if (m != 0u) {
        c_first = min(c_first, base + __ffs(m) - 1);
        c_last = base + 31 - __clz(m);
      }
    }
  }
  // the first loaded tile after kt (n_tiles if none); warp-uniform
  const auto next_loaded = [&](int kt) {
    ++kt;
    if constexpr (HAS_SEG) {
      while (kt < n_tiles) {
        const int base = kt & ~31;
        if (base != win) {
          win = base;
          bool in = false, one = false;
          if (base + lane < n_tiles) {
            const int4 r = k_tile(base + lane);
            in = ranges_meet(q_block, r);
            one = q_uni > 0 && r.z == q_uni;
          }
          win_loaded = __ballot_sync(0xffffffffu, in);
          win_uni = __ballot_sync(0xffffffffu, one);
        }
        const unsigned m = win_loaded >> (kt - base);
        if (m != 0u) return kt + __ffs(m) - 1;
        kt = base + 32;
      }
    }
    return kt;
  };

  float sacc[NS];           // scores of the tile in flight
  uint32_t pa[BK / 16][4];  // P of the previous tile, A fragments in TE
  float oacc[T::PANELS][32];
#pragma unroll
  for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int pn = 0; pn < T::PANELS; ++pn) {
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[pn][i] = 0.f;
  }
  // running max in log2 units (scores times sl2), l: this lane's part
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  const auto stage_k = [&](int i) {  // load i's stage
    return kv_s + (i % kStages) * T::STAGE_BYTES;
  };
  // S = Q K^T for load i: D/16 steps of 16 along the head dim, 32 bytes
  // apart inside a panel's swizzled 128-byte rows
  const auto issue_s = [&](int i) {
    const uint32_t ks = stage_k(i);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int pn = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = smem_desc(
          q_s + pn * T::Q_PANEL + c * 64 * kPanelBytes + off, 16, 1024);
      const uint64_t db = smem_desc(ks + pn * T::KV_PANEL + off, 16, 1024);
      if constexpr (BK == 128) {
        wgmma_m64n128k16_ss<F16>(sacc, da, db, kk > 0);
      } else {
        wgmma_m64n64k16_ss<0, 0, F16>(sacc, da, db, kk > 0);
      }
    }
    wgmma_commit();
  };
  // O += P V for load i: V's rows of each 16-key step, 2048 bytes a step;
  // MN-major with one 64-column atom along N, so the leading and the
  // stride offsets are both the 8-key step
  const auto issue_pv = [&](int i) {
    const uint32_t vs = stage_k(i) + T::KV_BYTES;
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) fence_regs(oacc[pn]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) {
        wgmma_m64n64k16_rs<F16>(
            oacc[pn], pa[j],
            smem_desc(vs + pn * T::KV_PANEL + j * 16 * kPanelBytes, 1024,
                      1024));
      }
    }
    wgmma_commit();
  };
  // the online softmax on tile kt's fragment (load ld): sacc[4n + e] is row
  // (e < 2 ? row_a : row_b), key k0 + 8n + 2 t4 + (e & 1). Leaves P in
  // sacc and returns the factors that rescale O. Two paths, by a
  // warp-uniform branch: a tile no mask touches with a positive scale
  // takes the row max of the raw scores and one fma a score
  // (exp2(s sl2 - m)); a masked tile (the diagonal, the ragged end, the
  // length, other segments) or any other scale scales first, so that
  // masked scores sit at kNeg. Under segments a tile is unmasked only if
  // its keys and the consumer's 64 rows all hold one id.
  const auto softmax = [&](int kt, int ld, float& alpha_a, float& alpha_b) {
    const int k0 = kt * BK;
    bool whole = k0 + BK <= len && (!CAUSAL || k0 + BK - 1 <= wr0 + shift);
    // kt lies in the window next_loaded last set
    if constexpr (HAS_SEG) whole = whole && ((win_uni >> (kt - win)) & 1u);
    float mx_a = kNeg, mx_b = kNeg;
    float mn_a, mn_b;
    if (whole && sl2 > 0.f) {
      // two chains a row, so that the reductions do not wait on each
      // other's latency
      float mx[4] = {kNeg, kNeg, kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        mx[((i & 2) >> 1) + ((i >> 1) & 2)] =
            fmaxf(mx[((i & 2) >> 1) + ((i >> 1) & 2)], sacc[i]);
      }
      mx_a = fmaxf(mx[0], mx[2]);
      mx_b = fmaxf(mx[1], mx[3]);
      mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
      mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sacc[i] = fast_exp2(fmaf(sacc[i], sl2, (i & 2) ? -mn_b : -mn_a));
      }
    } else {
      const int* ids = nullptr;  // the tile's key ids, staged with it
      if constexpr (HAS_SEG) {
        ids = reinterpret_cast<const int*>(
            smem_raw + (seg_s - smem_addr(smem_raw)) +
            (ld % kStages) * T::SEG_BYTES);
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        int2 kid = make_int2(0, 0);
        if constexpr (HAS_SEG) {
          kid = *reinterpret_cast<const int2*>(ids + n * 8 + 2 * t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          float& x = sacc[4 * n + e];
          bool ok = key < len &&
                    (!CAUSAL || key <= (e < 2 ? row_a : row_b) + shift);
          if constexpr (HAS_SEG) {
            const int sq = e < 2 ? seg_a : seg_b;
            ok = ok && sq > 0 && ((e & 1) ? kid.y : kid.x) == sq;
          }
          x = ok ? x * sl2 : kNeg;
          if (e < 2) {
            mx_a = fmaxf(mx_a, x);
          } else {
            mx_b = fmaxf(mx_b, x);
          }
        }
      }
      mn_a = fmaxf(m_a, quad_max(mx_a));
      mn_b = fmaxf(m_b, quad_max(mx_b));
      // Without segments every row sees key 0 in tile 0 (the length cut
      // leaves a block no tile where the length is 0), so m is a real
      // score from then on and a masked score's exp2(kNeg - m) is exact
      // 0. Under segments a row may see no live key for several tiles (a
      // pad row, a row whose first tiles are another segment's): while m
      // is kNeg its p is zeroed, as the mask says, by subtracting +inf.
      float sub_a = mn_a, sub_b = mn_b;
      if constexpr (HAS_SEG) {
        if (mn_a == kNeg) sub_a = __int_as_float(0x7f800000);
        if (mn_b == kNeg) sub_b = __int_as_float(0x7f800000);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        sacc[i] = fast_exp2(sacc[i] - ((i & 2) ? sub_b : sub_a));
      }
    }
    alpha_a = fast_exp2(m_a - mn_a);
    alpha_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};  // two chains a row
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sum[((i & 2) >> 1) + ((i >> 1) & 2)] += sacc[i];
    }
    l_a = l_a * alpha_a + (sum[0] + sum[2]);
    l_b = l_b * alpha_b + (sum[1] + sum[3]);
  };
  const auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      pa[j][0] = pack2<TE>(sacc[8 * j + 0], sacc[8 * j + 1]);
      pa[j][1] = pack2<TE>(sacc[8 * j + 2], sacc[8 * j + 3]);
      pa[j][2] = pack2<TE>(sacc[8 * j + 4], sacc[8 * j + 5]);
      pa[j][3] = pack2<TE>(sacc[8 * j + 6], sacc[8 * j + 7]);
    }
  };
  const auto rescale_o = [&](float alpha_a, float alpha_b) {
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        oacc[pn][i] *= (i & 2) ? alpha_b : alpha_a;
      }
    }
  };
  const auto release = [&](int i) {  // this warp is done with load i
    if (lane == 0) mbar_arrive(empty(i % kStages));
  };
  const auto wait_full = [&](int i) {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
  };

  // S of tile kt is issued with P V of the tile before it, and the
  // softmax of kt runs while P V does. Every wgmma and its wait sit in
  // straight-line code, so that ptxas keeps them asynchronous. kt walks
  // the loaded tiles, i counts them.
  int kt = next_loaded(-1), i = 0;
  for (; kt < c_first; kt = next_loaded(kt), ++i) {  // before its first
    wait_full(i);
    release(i);
  }
  if (c_first <= c_last) {  // kt == c_first: the Q tile was loaded with it
    mbar_wait(q_full, 0);
    wait_full(i);
    issue_s(i);
    wgmma_wait_all();
    fence_regs(sacc);
    float alpha_a, alpha_b;
    softmax(kt, i, alpha_a, alpha_b);
    pack_p();
    int prev = i;
    for (kt = next_loaded(kt), ++i; kt <= c_last;
         kt = next_loaded(kt), ++i) {
      wait_full(i);
      issue_s(i);
      issue_pv(prev);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(sacc);  // S of tile kt has landed; P V may still run
      softmax(kt, i, alpha_a, alpha_b);
      wgmma_wait_all();
#pragma unroll
      for (int pn = 0; pn < T::PANELS; ++pn) fence_regs(oacc[pn]);
      release(prev);
      rescale_o(alpha_a, alpha_b);
      pack_p();
      prev = i;
    }
    issue_pv(prev);
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < T::PANELS; ++pn) fence_regs(oacc[pn]);
    release(prev);
  }
  for (; kt < n_tiles; kt = next_loaded(kt), ++i) {  // past its last
    wait_full(i);
    release(i);
  }
  if constexpr (HAS_SEG) {
    // a loaded tile may meet the block's id range but no consumer's: the
    // Q tile then came with it unread, and must land before the block
    // exits
    if (i > 0) mbar_wait(q_full, 0);
  }

  // a row that saw no key (its length 0, a pad row) has l = 0 and
  // oacc = 0: exact 0 over the floored normalizer
  const float norm_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float norm_b = fmaxf(quad_sum(l_b), 1e-30f);
  if (p.lse != nullptr && t4 == 0) {  // m is in log2 units
    float* lse = p.lse + static_cast<size_t>(blockIdx.x) * p.Sq;
    if (row_a < p.Sq) lse[row_a] = (m_a + log2f(norm_a)) * kLn2;
    if (row_b < p.Sq) lse[row_b] = (m_b + log2f(norm_b)) * kLn2;
  }
  TE* o = static_cast<TE*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int pn = 0; pn < T::PANELS; ++pn) {
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int col = pn * 64 + nd * 8 + 2 * t4;
      if (row_a < p.Sq) {
        store2<TE>(o + row_a * p.o_ss + col, oacc[pn][4 * nd] / norm_a,
                   oacc[pn][4 * nd + 1] / norm_a);
      }
      if (row_b < p.Sq) {
        store2<TE>(o + row_b * p.o_ss + col, oacc[pn][4 * nd + 2] / norm_b,
                   oacc[pn][4 * nd + 3] / norm_b);
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, int threads,
           int block_q, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.Sq + block_q - 1) / block_q, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DC, int R, int KL>
struct ScalarKernel {
  template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
  static int run(const Params& p, cudaStream_t s) {
    using Tile = ScalarTile<R, KL>;
    return launch(flash_fwd_kernel<T, DC, R, KL, CAUSAL, HAS_LEN, HAS_SEG>, p,
                  Tile::smem(p.D), kThreads, Tile::BQ, s);
  }
};

template <typename T, int D>
struct MmaKernel {
  template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
  static int run(const Params& p, cudaStream_t s) {
    return launch(flash_fwd_mma_kernel<T, D, CAUSAL, HAS_LEN, HAS_SEG>, p,
                  mma_shared_bytes<D>(), kMmaThreads, kBlockQ, s);
  }
};

template <typename K>
int dispatch_mask(const Params& p, cudaStream_t s) {
  const bool causal = p.causal != 0;
  const bool len = p.lengths != nullptr, seg = p.seg != nullptr;
  if (!len && !seg) {
    return causal ? K::template run<true, false, false>(p, s)
                  : K::template run<false, false, false>(p, s);
  }
  if (len && !seg) {
    return causal ? K::template run<true, true, false>(p, s)
                  : K::template run<false, true, false>(p, s);
  }
  if (!len && seg) {
    return causal ? K::template run<true, false, true>(p, s)
                  : K::template run<false, false, true>(p, s);
  }
  return causal ? K::template run<true, true, true>(p, s)
                : K::template run<false, true, true>(p, s);
}

// The kernels that read their lengths and ids at run time (Masks): one
// instantiation a causal flag.
template <typename K>
int dispatch_causal(const Params& p, cudaStream_t s) {
  return p.causal ? K::template run<true, true, true>(p, s)
                  : K::template run<false, true, true>(p, s);
}

// The CUDA-core variant: every mask compiled in up to D = 128; past it,
// in chunks of 64 columns (19 chunks of 32 for the last 12), the masks
// read at run time, on the 64-row tiles up to kWideD and the 32-row ones
// past it.
template <typename T>
int dispatch_scalar(const Params& p, cudaStream_t s) {
  if (p.D <= 64) return dispatch_mask<ScalarKernel<T, 2, 8, 2>>(p, s);
  if (p.D <= kNarrowD) return dispatch_mask<ScalarKernel<T, 4, 8, 2>>(p, s);
#define MXT_WIDE(DC, R, KL)                                       \
  if (p.D <= 32 * (DC)) {                                         \
    return dispatch_causal<ScalarKernel<T, DC, R, KL>>(p, s);     \
  }
  MXT_WIDE(6, 8, 2)
  MXT_WIDE(8, 8, 2)
  MXT_WIDE(10, 4, 1)
  MXT_WIDE(12, 4, 1)
  MXT_WIDE(14, 4, 1)
  MXT_WIDE(16, 4, 1)
  MXT_WIDE(18, 4, 1)
  MXT_WIDE(19, 4, 1)
#undef MXT_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core variant reads q, k and v in 16-byte vectors and writes o
// in 4-byte pairs: every row must start on such a boundary.
bool mma_aligned(const Params& p) {
  const auto aligned = [](const void* ptr, unsigned bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  return aligned(p.q, 16) && aligned(p.k, 16) && aligned(p.v, 16) &&
         aligned(p.o, 4) && p.q_sb % 8 == 0 && p.q_sh % 8 == 0 &&
         p.q_ss % 8 == 0 && p.k_sb % 8 == 0 && p.k_sh % 8 == 0 &&
         p.k_ss % 8 == 0 && p.v_sb % 8 == 0 && p.v_sh % 8 == 0 &&
         p.v_ss % 8 == 0 && p.o_sb % 2 == 0 && p.o_sh % 2 == 0 &&
         p.o_ss % 2 == 0;
}

template <typename T>
int dispatch_mma(const Params& p, cudaStream_t s) {
  if (p.D == 64) return dispatch_mask<MmaKernel<T, 64>>(p, s);
  if (p.D == 128) return dispatch_mask<MmaKernel<T, 128>>(p, s);
  return dispatch_causal<MmaKernel<T, 256>>(p, s);
}


// seg_scratch: flash_attention_seg_scratch_ints(B, Sk) int32 on the card,
// 16-byte aligned, when p.seg is not null: the padded ids (B, s_pad), then
// their chunk ranges (B, s_pad / kSegChunk, 4), both written by
// seg_ranges_kernel ahead of the attention kernel on the same stream, with
// no host sync.
template <typename TE, int D, bool CAUSAL, bool HAS_SEG>
int launch_wgmma(const Params& p, int* seg_scratch, cudaStream_t stream) {
  using T = WgTile<D>;
  WgParams w;
  int err = encode_map(&w.tq, &w.q_slots, p.q, D, p.Sq, p.H, p.B, p.q_ss,
                       p.q_sh, p.q_sb, kWgBlockQ);
  if (err == 0) {
    err = encode_map(&w.tk, &w.k_slots, p.k, D, p.Sk, p.H, p.B, p.k_ss,
                     p.k_sh, p.k_sb, T::BK);
  }
  if (err == 0) {
    err = encode_map(&w.tv, &w.v_slots, p.v, D, p.Sk, p.H, p.B, p.v_ss,
                     p.v_sh, p.v_sb, T::BK);
  }
  if (err != 0) return err;
  w.o = p.o;
  w.lse = p.lse;
  w.lengths = p.lengths;
  w.seg_pad = nullptr;
  w.seg_range = nullptr;
  w.s_pad = 0;
  if constexpr (HAS_SEG) {
    w.s_pad = seg_pad_length(p.Sk);
    w.seg_pad = seg_scratch;
    w.seg_range = reinterpret_cast<int4*>(
        seg_scratch + static_cast<size_t>(p.B) * w.s_pad);
    const int pre = launch_seg_ranges(p.seg, p.B, p.Sk, seg_scratch, stream);
    if (pre != 0) return pre;
  }
  w.o_sb = p.o_sb, w.o_sh = p.o_sh, w.o_ss = p.o_ss;
  w.H = p.H, w.Sq = p.Sq, w.Sk = p.Sk;
  w.scale_log2 = p.scale * 1.4426950408889634f;
  const auto kernel = flash_fwd_wgmma_kernel<TE, D, CAUSAL, HAS_SEG>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.B * p.H, (p.Sq + kWgBlockQ - 1) / kWgBlockQ);
  kernel<<<grid, kWgThreads, T::SMEM, stream>>>(w);
  return static_cast<int>(cudaGetLastError());
}

template <typename TE, int D>
int dispatch_wgmma(const Params& p, int* seg_scratch, cudaStream_t s) {
  const bool causal = p.causal != 0;
  if (p.seg != nullptr) {
    return causal ? launch_wgmma<TE, D, true, true>(p, seg_scratch, s)
                  : launch_wgmma<TE, D, false, true>(p, seg_scratch, s);
  }
  return causal ? launch_wgmma<TE, D, true, false>(p, nullptr, s)
                : launch_wgmma<TE, D, false, false>(p, nullptr, s);
}

template <typename TE>
int dispatch_wgmma_d(const Params& p, int* seg_scratch, cudaStream_t s) {
  return p.D == 64 ? dispatch_wgmma<TE, 64>(p, seg_scratch, s)
                   : dispatch_wgmma<TE, 128>(p, seg_scratch, s);
}

// The Hopper variant reads q, k and v through TMA maps (tma_operand) and
// writes o in 4-byte pairs.
bool wgmma_aligned(const Params& p) {
  return tma_operand(p.q, p.q_sb, p.q_sh, p.q_ss, p.B, p.H, p.Sq) &&
         tma_operand(p.k, p.k_sb, p.k_sh, p.k_ss, p.B, p.H, p.Sk) &&
         tma_operand(p.v, p.v_sb, p.v_sh, p.v_ss, p.B, p.H, p.Sk) &&
         reinterpret_cast<uintptr_t>(p.o) % 4 == 0 && p.o_sb % 2 == 0 &&
         p.o_sh % 2 == 0 && p.o_ss % 2 == 0;
}

}  // namespace

extern "C" {

// strides: 12 element strides (batch, head, row) of q, k, v and o; the
// head dim of each is contiguous. lse: null, or (B, H, Sq) fp32 on the
// card, contiguous, into which every variant writes each row's logsumexp
// m + log(max(l, 1e-30)) over the scores of q * scale (natural log; a row
// that sees no key gets a large negative finite value, which the backward
// does not read). lengths (B,) and segment_ids (B, Sk)
// are int32 on the card, or null; with segment_ids, seg_scratch holds
// flash_attention_seg_scratch_ints(B, Sk) int32 on the card, 16-byte
// aligned (the Hopper variant's tile skipping writes it). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. D: 1 to kMaxD (588). route: 0 picks
// the variant by dtype, D and alignment; 1 takes the mma.sync variant
// wherever it applies (bf16 or fp16, D = 64, 128 or 256, aligned rows), so
// that it can be timed beside the Hopper one. *variant is set to the
// variant launched: 0 the CUDA-core one, 1 mma.sync, 2 wgmma. Returns the
// cudaError_t of the launch, or kCuBase + a CUresult of the TMA map
// encoding.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* lengths,
                            const void* segment_ids, void* seg_scratch,
                            const long long* strides, int B, int H, int Sq,
                            int Sk, int D, float scale, int causal, int dtype,
                            int route, int* variant, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      B * H > 65535 || dtype < 0 || dtype > 2 ||
      (segment_ids != nullptr && Sq != Sk) || route < 0 || route > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.lengths = static_cast<const int*>(lengths);
  p.seg = static_cast<const int*>(segment_ids);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.D = D;
  p.causal = causal != 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool half = dtype == 2;
  const bool mma =
      dtype != 0 && (D == 64 || D == 128 || D == 256) && mma_aligned(p);
  if (route == 1 && !mma) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0 && dtype != 0 && (D == 64 || D == 128) &&
      wgmma_aligned(p)) {
    int* scratch = static_cast<int*>(seg_scratch);
    if (segment_ids != nullptr &&
        (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    *variant = 2;
    return half ? dispatch_wgmma_d<__half>(p, scratch, s)
                : dispatch_wgmma_d<__nv_bfloat16>(p, scratch, s);
  }
  if (mma) {
    *variant = 1;
    return half ? dispatch_mma<__half>(p, s)
                : dispatch_mma<__nv_bfloat16>(p, s);
  }
  const size_t smem = D <= kWideD ? NarrowTile::smem(D) : WideTile::smem(D);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  *variant = 0;
  if (dtype == 0) return dispatch_scalar<float>(p, s);
  return half ? dispatch_scalar<__half>(p, s)
              : dispatch_scalar<__nv_bfloat16>(p, s);
}

// the largest head dim the library takes
int flash_attention_max_head_dim() { return kMaxD; }

// the int32 scratch the Hopper variant takes with segment ids
size_t flash_attention_seg_scratch_ints(int B, int S) {
  return seg_scratch_ints(B, S);
}

// the sizes of the Hopper variant's shared memory, D = 64 and 128
size_t flash_attention_wgmma_smem_bytes(int d) {
  return d == 64 ? WgTile<64>::SMEM : d == 128 ? WgTile<128>::SMEM : 0;
}

const char* flash_attention_error_string(int err) {
  return error_string(err);
}

}  // extern "C"
