// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces two TPU kernels of mxnet_tpu/ops/pallas/attention.py:
//   _flash_kernel         (launched by _flash_attention_dense, B2), and
//   _flash_kernel_masked  (launched by _masked_attention, B3).
// One template serves both, switched by CAUSAL, HAS_LEN and HAS_SEG. It
// computes what those kernels compute: exact softmax attention over
// (B, H, S, D) with an online softmax over K/V tiles, fp32 running max m,
// normalizer l and accumulator, the scale applied in fp32 (to q before the
// product, or to the scores after it: they differ only in rounding), the
// causal diagonal at kpos <= qpos + (Sk - Sq), per-batch key lengths
// (kpos < len), packed segment ids (seg_q == seg_k and seg_q > 0), p zeroed
// where the mask is false (so rows that see no key come out exact 0), the
// normalizer floored at 1e-30, and the output in q's dtype.
//
// Bound. A launch must read q, k and v once and write o once, and must do
// 4*D operations for every (query, key) pair the mask keeps alive. At the
// transformer's shapes (B=4, H=8, S=2048, D=64, causal, bf16) that is
// 33.6 MB against 17.2 GFLOP: 10.0 us by bytes at 3.35 TB/s, 17.4 us by
// operations at the 989 TFLOP/s bf16 tensor-core peak. Operations bound it.
//
// Two variants, both one block per (batch*head, tile of 64 query rows),
// tiles taken longest-first so that the causal tail is short, both with no
// score matrix leaving the block, K tiles wholly above the causal diagonal
// or past the batch element's length skipped, and strides as arguments, so
// that the transposed (B, S, H, D) views the transformer makes are read in
// place:
//
// - the tensor-core variant (flash_fwd_mma_kernel), taken for bf16 with
//   D = 64 or 128 and 16-byte aligned rows, the transformer's case: 4 warps
//   of 16 query rows, Q K^T and P V as mma.sync m16n8k16 bf16 products
//   accumulated in fp32, the online softmax on the fragments in registers,
//   K/V tiles double buffered by cp.async and read by ldmatrix;
// - the CUDA-core variant (flash_fwd_kernel) for fp32, for other D up to
//   128 and for unaligned views: 8 warps of 8 query rows, q (times scale),
//   K and V staged as fp32, a lane scoring 2 keys with fp32 FMAs, p through
//   shared memory, a lane accumulating D/32 output columns. It runs at the
//   fp32 rate (67 TFLOP/s), far below the tensor-core bound.
//
// wgmma, TMA, warp specialization and larger query tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;                   // query rows of a block
constexpr int kBlockK = 64;                   // keys of a K/V tile
constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlockQ / kWarps;       // query rows of a warp
constexpr int kMaxD = 128;
constexpr size_t kMaxSharedBytes = 232448;    // 227 KB, the most a block may use
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;   // (B,) key lengths, or null
  const int* seg;       // (B, S) segment ids, contiguous, or null
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Sq, Sk, D;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Whether query row `row` attends to key `key`: in bounds, on or below the
// causal diagonal, before the batch element's key length, and in the same
// nonzero segment.
template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
__device__ __forceinline__ bool attends(const Params& p, int row, int key,
                                        int len, int seg_row, int seg_key) {
  bool ok = key < p.Sk;
  if (CAUSAL) ok = ok && key <= row + (p.Sk - p.Sq);
  if (HAS_LEN) ok = ok && key < len;
  if (HAS_SEG) ok = ok && seg_row > 0 && seg_key == seg_row;
  return ok;
}

// q and v tile row stride in shared memory: D rounded up to 4 floats (zero
// padded), so rows are read as float4 and every array stays 16-byte
// aligned. K rows get 4 more floats, so the 8 lanes of a quarter warp
// reading one float4 column of 8 keys hit distinct banks.
__host__ __device__ inline int row_stride(int d) { return (d + 3) & ~3; }

__host__ __device__ inline size_t shared_bytes(int d) {
  const int ldq = row_stride(d);
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * ldq +
                          static_cast<size_t>(kBlockK) * (ldq + 4) +
                          static_cast<size_t>(kBlockK) * ldq +
                          static_cast<size_t>(kBlockQ) * kBlockK) +
         sizeof(int) * (kBlockQ + kBlockK);
}

// DC: 32-wide column chunks of the output a lane holds (D <= 32 * DC).
template <typename T, int DC, bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int ldq = row_stride(D);
  const int ldk = ldq + 4;
  float* q_s = smem;                          // [kBlockQ][ldq], times scale
  float* k_s = q_s + kBlockQ * ldq;           // [kBlockK][ldk]
  float* v_s = k_s + kBlockK * ldk;           // [kBlockK][ldq]
  float* p_s = v_s + kBlockK * ldq;           // [kBlockQ][kBlockK]
  int* seg_q = reinterpret_cast<int*>(p_s + kBlockQ * kBlockK);
  int* seg_k = seg_q + kBlockQ;

  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest rows first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRows;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* seg = HAS_SEG ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;

  for (int i = tid; i < kBlockQ * ldq; i += kThreads) {
    const int r = i / ldq, c = i % ldq;
    const int row = q0 + r;
    q_s[i] = (row < p.Sq && c < D)
                 ? to_float(q[row * p.q_ss + c]) * p.scale
                 : 0.f;
  }
  if (HAS_SEG) {
    for (int i = tid; i < kBlockQ; i += kThreads) {
      seg_q[i] = q0 + i < p.Sq ? seg[q0 + i] : 0;
    }
  }

  // keys this block can see: none past the length, none above the
  // diagonal of its last row
  const int len = HAS_LEN ? p.lengths[b] : p.Sk;
  int n_keys = p.Sk;
  if (HAS_LEN) n_keys = min(n_keys, max(len, 0));
  if (CAUSAL) {
    const int last_row = min(q0 + kBlockQ, p.Sq) - 1;
    n_keys = min(n_keys, last_row + (p.Sk - p.Sq) + 1);
  }
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  float* p_w = p_s + r0 * kBlockK;  // this warp's rows of p

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * ldq; i += kThreads) {
      const int r = i / ldq, c = i % ldq;
      const int key = k0 + r;
      const bool in = key < p.Sk && c < D;
      k_s[r * ldk + c] = in ? to_float(k[key * p.k_ss + c]) : 0.f;
      v_s[r * ldq + c] = in ? to_float(v[key * p.v_ss + c]) : 0.f;
    }
    if (HAS_SEG) {
      for (int i = tid; i < kBlockK; i += kThreads) {
        seg_k[i] = k0 + i < p.Sk ? seg[k0 + i] : 0;
      }
    }
    __syncthreads();

    // scores of keys (lane, lane + 32) for the warp's rows
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
      bool live[2];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = attends<CAUSAL, HAS_LEN, HAS_SEG>(
            p, row, k0 + lane + 32 * j, len,
            HAS_SEG ? seg_q[r0 + r] : 0, HAS_SEG ? seg_k[lane + 32 * j] : 0);
        live[j] = ok;
        mx = fmaxf(mx, ok ? s[r][j] : kNeg);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      // p is zeroed where the mask is false: while every key so far is
      // masked, m_new == kNeg and exp(s - m_new) would be 1
      const float pa = live[0] ? expf(s[r][0] - m_new) : 0.f;
      const float pb = live[1] ? expf(s[r][1] - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
      p_w[r * kBlockK + lane] = pa;
      p_w[r * kBlockK + lane + 32] = pb;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? v_s[(j + jj) * ldq + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_w + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[r][c] += pv.x * vv[0][c] + pv.y * vv[1][c] + pv.z * vv[2][c] +
                       pv.w * vv[3][c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
    const float norm = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[row * p.o_ss + d] = from_float<T>(acc[r][c] / norm);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core variant: bf16 inputs, D = 64 or 128, 16-byte aligned rows.
// One block of 4 warps per (batch*head, tile of 64 query rows); a warp owns
// 16 rows. Scores S = Q K^T and the output O += P V are mma.sync m16n8k16
// bf16 products with fp32 accumulation; the warp holds its Q fragments, its
// 16 x 64 score tile and its 16 x D output in registers, and the online
// softmax runs on the score fragments (a row spans the 4 lanes of a quad),
// in log2 units so that exp2 serves. K and V tiles (rows padded by 16
// bytes, so that ldmatrix rows fall in distinct banks) are double
// buffered: cp.async loads tile kt + 1 while tile kt computes. ldmatrix
// reads the K fragments, and with .trans the V fragments of the row-major
// V tile. Tiles no mask touches skip the per-score mask. The scale
// multiplies the fp32 scores (it is inexact in bf16 for D = 128), and p is
// rounded to bf16 for the P V product, as tensor-core flash attention does.

constexpr int kMmaThreads = 128;  // 4 warps of 16 query rows

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a . b for a 16 x 16 bf16 A (row-major fragment), a 16 x 8 bf16 B
// (column-major fragment) and a 16 x 8 fp32 C.
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

// q tile, two K and two V tiles (rows padded by 16 bytes), segment ids
template <int D>
constexpr size_t mma_shared_bytes() {
  return sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) * (D + 8) +
         sizeof(int) * (kBlockQ + 2 * kBlockK);
}

template <int D, bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;          // row stride of the q, k and v tiles
  constexpr int KC = D / 16;         // 16-wide chunks of the head dim
  constexpr int ND = D / 8;          // 8-wide column tiles of the output
  constexpr int NK = kBlockK / 8;    // 8-key tiles of the scores
  constexpr int V8 = D / 8;          // 16-byte vectors in a row
  constexpr float kLog2e = 1.4426950408889634f;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockQ][LD]
  bf16* k_s = q_s + kBlockQ * LD;                 // [2][kBlockK][LD]
  bf16* v_s = k_s + 2 * kBlockK * LD;             // [2][kBlockK][LD]
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

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int* seg = HAS_SEG ? p.seg + static_cast<size_t>(b) * p.Sk : nullptr;

  const int len = HAS_LEN ? p.lengths[b] : p.Sk;
  int n_keys = p.Sk;
  if (HAS_LEN) n_keys = min(n_keys, max(len, 0));
  if (CAUSAL) {
    const int last_row = min(q0 + kBlockQ, p.Sq) - 1;
    n_keys = min(n_keys, last_row + (p.Sk - p.Sq) + 1);
  }
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;

  // K/V tile kt into buffer buf, by cp.async; rows past Sk are zeros
  const auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlockK;
    bf16* kd = k_s + buf * kBlockK * LD;
    bf16* vd = v_s + buf * kBlockK * LD;
    for (int i = tid; i < kBlockK * V8; i += kMmaThreads) {
      const int r = i / V8, c = (i % V8) * 8;
      const bool in = k0 + r < p.Sk;
      const int key = in ? k0 + r : 0;
      cp_async_16(kd + r * LD + c, k + key * p.k_ss + c, in);
      cp_async_16(vd + r * LD + c, v + key * p.v_ss + c, in);
    }
    if (HAS_SEG) {
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
  if (HAS_SEG) {
    for (int i = tid; i < kBlockQ; i += kMmaThreads) {
      seg_q[i] = q0 + i < p.Sq ? seg[q0 + i] : 0;
    }
  }
  __syncthreads();

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const bf16* base = q_s + (wr + g) * LD + kc * 16 + 2 * t;
    qa[kc][0] = ld_pair(base);
    qa[kc][1] = ld_pair(base + 8 * LD);
    qa[kc][2] = ld_pair(base + 8);
    qa[kc][3] = ld_pair(base + 8 * LD + 8);
  }
  const int row_a = q0 + wr + g;  // this lane's two rows
  const int row_b = row_a + 8;
  const int seg_a = HAS_SEG ? seg_q[wr + g] : 0;
  const int seg_b = HAS_SEG ? seg_q[wr + g + 8] : 0;
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
    if (!CAUSAL || k0 <= q0 + wr + 15 + (p.Sk - p.Sq)) {
      const bf16* kb = k_s + buf * kBlockK * LD;
      const bf16* vb = v_s + buf * kBlockK * LD;
      const int* sk = seg_k + buf * kBlockK;
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; kc += 2) {
          uint32_t kf[4];  // B fragments of chunks kc and kc + 1
          ldmatrix_x4(kf, kb + (n * 8 + lr) * LD + kc * 16 + lm * 8);
          mma_16816(s[n], qa[kc], kf[0], kf[1]);
          mma_16816(s[n], qa[kc + 1], kf[2], kf[3]);
        }
      }

      // no key of the tile is masked for any row of the warp
      const bool full =
          !HAS_SEG && k0 + kBlockK <= p.Sk &&
          (!HAS_LEN || k0 + kBlockK <= len) &&
          (!CAUSAL || k0 + kBlockK - 1 <= q0 + wr + (p.Sk - p.Sq));
      unsigned live = 0u;  // bit 4n + e: score s[n][e] is attended
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = n * 8 + 2 * t + (e & 1);
          const bool ok =
              full || attends<CAUSAL, HAS_LEN, HAS_SEG>(
                          p, e < 2 ? row_a : row_b, k0 + kk, len,
                          e < 2 ? seg_a : seg_b, HAS_SEG ? sk[kk] : 0);
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
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t vf[4];  // B fragments of column tiles nd and nd + 1
          ldmatrix_x4_trans(
              vf, vb + (j * 16 + lr + 8 * (lm & 1)) * LD + (nd + lm / 2) * 8);
          mma_16816(acc[nd], pa, vf[0], vf[1]);
          mma_16816(acc[nd + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer buf before its reload
  }

  const float norm_a = fmaxf(quad_sum(l_a), 1e-30f);
  const float norm_b = fmaxf(quad_sum(l_b), 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (row_a < p.Sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + row_a * p.o_ss + col) =
          __floats2bfloat162_rn(acc[nd][0] / norm_a, acc[nd][1] / norm_a);
    }
    if (row_b < p.Sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + row_b * p.o_ss + col) =
          __floats2bfloat162_rn(acc[nd][2] / norm_b, acc[nd][3] / norm_b);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, const Params& p, size_t smem, int threads,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DC>
struct ScalarKernel {
  template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
  static int run(const Params& p, cudaStream_t s) {
    return launch(flash_fwd_kernel<T, DC, CAUSAL, HAS_LEN, HAS_SEG>, p,
                  shared_bytes(p.D), kThreads, s);
  }
};

template <int D>
struct MmaKernel {
  template <bool CAUSAL, bool HAS_LEN, bool HAS_SEG>
  static int run(const Params& p, cudaStream_t s) {
    return launch(flash_fwd_mma_kernel<D, CAUSAL, HAS_LEN, HAS_SEG>, p,
                  mma_shared_bytes<D>(), kMmaThreads, s);
  }
};

template <typename K>
int dispatch_mask(const Params& p, bool causal, cudaStream_t s) {
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

template <typename T>
int dispatch_scalar(const Params& p, bool causal, cudaStream_t s) {
  return p.D <= 64 ? dispatch_mask<ScalarKernel<T, 2>>(p, causal, s)
                   : dispatch_mask<ScalarKernel<T, 4>>(p, causal, s);
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

}  // namespace

extern "C" {

// strides: 12 element strides (batch, head, row) of q, k, v and o; the
// head dim of each is contiguous. lengths (B,) and segment_ids (B, Sk)
// are int32 on the card, or null. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, const void* lengths,
                            const void* segment_ids, const long long* strides,
                            int B, int H, int Sq, int Sk, int D, float scale,
                            int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      B * H > 65535 || shared_bytes(D) > kMaxSharedBytes ||
      (segment_ids != nullptr && Sq != Sk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lengths = static_cast<const int*>(lengths);
  p.seg = static_cast<const int*>(segment_ids);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_ss = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_ss = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_ss = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_ss = strides[11];
  p.B = B, p.H = H, p.Sq = Sq, p.Sk = Sk, p.D = D;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_scalar<float>(p, causal != 0, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && mma_aligned(p)) {
    return dispatch_mask<MmaKernel<64>>(p, causal != 0, s);
  }
  if (D == 128 && mma_aligned(p)) {
    return dispatch_mask<MmaKernel<128>>(p, causal != 0, s);
  }
  return dispatch_scalar<__nv_bfloat16>(p, causal != 0, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
