// LSTM forward and backward for Hopper (sm_90a), with a plain C interface:
// two forward kernels, and below them (after "The backward") two backward
// kernels that mirror them, lstm_seq_bwd_kernel and lstm_cell_bwd_kernel.
//
// Both forward kernels compute what the TPU kernel mxnet_tpu/ops/pallas/lstm.py:_lstm_kernel
// computes for one time step (launched by _cell_pallas, once per lax.scan
// step of mxnet_tpu/ops/rnn_ops.py:_run_direction):
//   gates = xproj + h . w_h2h^T, accumulated in fp32, gate order i, f, g, o
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with h' and c' cast to the types of h and c, so that in bf16 both states
// are rounded after every step, as the scan's carry is.
//
// lstm_cell_kernel: one launch per step (the counterpart of one
// _cell_pallas call). One block per hidden unit j stages its four gate rows
// w_h2h[k*H + j, :] in shared memory as fp32 and throws them away at the end
// of the launch, so every step re-reads all of w_h2h (16.8 MB in fp32 at
// H = 1024: 5.0 us at 3.35 TB/s, the step's whole bound). Warps take the
// batch rows in turn; lanes stride along H and a warp shuffle sums them.
//
// lstm_seq_kernel: the whole time loop of one layer and direction in one
// persistent launch (the counterpart of the scan over _cell_pallas). Bound:
// the product's 2*T*N*4H*H operations at the fp32 rate (67 TFLOP/s; TF32
// stays off): 256.4 us at T=128, N=16, H=1024 and 16.0 us at N=1, against
// 17.6 and 5.8 us for the bytes (each input read once, each output written
// once). Operations bound it, and w_h2h must not leave the chip between
// steps. The 132 SMs hold 30 MB of shared memory, enough for one layer's
// 16.8 MB of fp32 weights, so:
//   - a cooperative launch of at most one block per SM (the grid never
//     exceeds what can be resident, which a cooperative launch checks and
//     refuses otherwise); each block owns `units` = ceil(H / SMs) hidden
//     units (8 on 128 blocks at H = 1024; the last block's range may be
//     ragged) and stages their 4*units gate rows of w_h2h in shared memory
//     once, as fp32, laid out [H/4][4*units] in float4s (128 KB at H=1024);
//   - each step the block pulls h_{t-1} into shared memory as fp32, a chunk
//     of up to 16 batch rows at a time (a chunk that does not fit beside
//     the weights is halved; rows past N are zeros), through L2 only
//     (ld.global.cg): h_{t-1} is out[t-1], written by other SMs in this
//     launch, and their L1s are not coherent with this one. The chunk's
//     xproj and c_{t-1} of the block's units are loaded beside it;
//   - a thread owns kSeqTile = 2 gate rows and a slice of K, and holds one
//     fp32 sum per (row, batch row of the chunk), so every weight it reads
//     from shared memory serves all batch rows and every h value two gate
//     rows; h is read as float4 broadcasts (one address a K group). K is
//     split across the 512 threads' groups (32 at H = 1024), so all warps
//     work at N = 1; the groups' partial sums meet in shared memory, summed
//     in a fixed order;
//   - the thread that owns (unit, row) applies the gate epilogue, keeps c
//     in c_out (read back only by its own block), and writes h_t into
//     out[t], which is the next step's h_{t-1};
//   - a grid-wide barrier between steps (an arrival counter; see
//     grid_barrier); reverse walks t from T-1 to 0.
// What bounds a step here is not the bound above: at N = 16 the products
// wait on shared-memory reads (a broadcast float4 costs as much of the
// shared-memory pipe as a full one, so each h value read feeds only two
// rows' FMAs), and at N = 1 on latency: the L2 round trip for h_{t-1}, four
// block barriers, the epilogue and the grid barrier (~1 us), each paid 128
// times. Where the weights do not fit (fp32 and bf16 above H = 1320 on 132
// SMs), the wrapper launches the per-step kernel T times instead:
// seq_plan states the rule, and ops/cuda/lstm.py:sequence_fits asks it
// through lstm_sequence_shared_bytes. In training both kernels also keep
// the activated gates (fp32) and the sequence kernel every step's c, which
// the backward reads instead of recomputing h . w_h2h^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block may use

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const T* __restrict__ xproj, const T* __restrict__ h,
                     const T* __restrict__ c, const T* __restrict__ w,
                     T* __restrict__ h_out, T* __restrict__ c_out,
                     float* __restrict__ gates_out, int n_rows, int hidden) {
  extern __shared__ float w_rows[];  // [4][hidden]
  const int j = blockIdx.x;
  for (int k = 0; k < 4; ++k) {
    const T* src = w + (static_cast<size_t>(k) * hidden + j) * hidden;
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      w_rows[k * hidden + i] = to_float(src[i]);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* w_i = w_rows;
  const float* w_f = w_rows + hidden;
  const float* w_g = w_rows + 2 * hidden;
  const float* w_o = w_rows + 3 * hidden;
  for (int n = warp; n < n_rows; n += kWarps) {
    const T* h_n = h + static_cast<size_t>(n) * hidden;
    float acc_i = 0.f, acc_f = 0.f, acc_g = 0.f, acc_o = 0.f;
    for (int i = lane; i < hidden; i += 32) {
      const float hv = to_float(h_n[i]);
      acc_i += hv * w_i[i];
      acc_f += hv * w_f[i];
      acc_g += hv * w_g[i];
      acc_o += hv * w_o[i];
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc_i += __shfl_xor_sync(0xffffffffu, acc_i, off);
      acc_f += __shfl_xor_sync(0xffffffffu, acc_f, off);
      acc_g += __shfl_xor_sync(0xffffffffu, acc_g, off);
      acc_o += __shfl_xor_sync(0xffffffffu, acc_o, off);
    }
    if (lane == 0) {
      const T* x_n = xproj + static_cast<size_t>(n) * 4 * hidden;
      const float gi = sigmoid(to_float(x_n[j]) + acc_i);
      const float gf = sigmoid(to_float(x_n[hidden + j]) + acc_f);
      const float gg = tanhf(to_float(x_n[2 * hidden + j]) + acc_g);
      const float go = sigmoid(to_float(x_n[3 * hidden + j]) + acc_o);
      const size_t at = static_cast<size_t>(n) * hidden + j;
      const float c_new = gf * to_float(c[at]) + gi * gg;
      c_out[at] = from_float<T>(c_new);
      h_out[at] = from_float<T>(go * tanhf(c_new));
      if (gates_out != nullptr) {
        float* g_n = gates_out + static_cast<size_t>(n) * 4 * hidden + j;
        g_n[0] = gi;
        g_n[hidden] = gf;
        g_n[2 * hidden] = gg;
        g_n[3 * hidden] = go;
      }
    }
  }
}

template <typename T>
int launch(const void* xproj, const void* h, const void* c, const void* w,
           void* h_out, void* c_out, void* gates_out, int n_rows, int hidden,
           cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(hidden) * sizeof(float);
  if (hidden < 1 || n_rows < 1 || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_cell_kernel<T><<<hidden, kThreads, smem, stream>>>(
      static_cast<const T*>(xproj), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(w),
      static_cast<T*>(h_out), static_cast<T*>(c_out),
      static_cast<float*>(gates_out), n_rows, hidden);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// lstm_seq_kernel: the persistent kernel over the time loop.

constexpr int kSeqThreads = 512;
constexpr int kSeqTile = 2;       // gate rows a thread owns
constexpr int kSeqMaxChunk = 16;  // batch rows of h_{t-1} staged at a time

// Dynamic shared memory of a block, in floats: the weights [Hp/4][rows]
// float4s; one region that holds h_{t-1}'s chunk [chunk][Hp] during the
// products and the K groups' partial sums [groups][chunk][rows] after them;
// the gate pre-activations and the chunk's xproj, [chunk][rows] each; the
// chunk's c_{t-1} [chunk][units]. Hp is H rounded up to 4; rows / kSeqTile
// threads make a K group.
size_t seq_shared_bytes(int hidden, int units, int chunk) {
  const size_t rows = 4 * static_cast<size_t>(units);
  const size_t hp = (static_cast<size_t>(hidden) + 3) / 4 * 4;
  const size_t groups = kSeqThreads / (rows / kSeqTile);
  const size_t chunk_h = chunk * hp, chunk_parts = groups * chunk * rows;
  return 4 * (hp * rows + (chunk_h > chunk_parts ? chunk_h : chunk_parts) +
              2 * chunk * rows + chunk * units);
}

// The plan of a launch. False when one layer's weights do not fit in the blocks' shared memory.
struct SeqPlan {
  int units;    // hidden units a block owns: ceil(H / SMs)
  int blocks;   // ceil(H / units), at most one per SM
  int chunk;    // batch rows of h_{t-1} in shared memory at a time
  size_t smem;  // dynamic shared bytes a block
};

bool seq_plan(int n_rows, int hidden, int sm_count, SeqPlan* p) {
  if (n_rows < 1 || hidden < 1 || sm_count < 1) return false;
  p->units = (hidden + sm_count - 1) / sm_count;
  if (4 * p->units > kSeqThreads) return false;
  p->blocks = (hidden + p->units - 1) / p->units;
  int chunk = 1;
  while (chunk < n_rows && chunk < kSeqMaxChunk) chunk *= 2;
  while (chunk > 1 &&
         seq_shared_bytes(hidden, p->units, chunk) > kMaxSharedBytes) {
    chunk /= 2;
  }
  p->chunk = chunk;
  p->smem = seq_shared_bytes(hidden, p->units, chunk);
  return p->smem <= kMaxSharedBytes;
}

// A grid-wide barrier on an arrival counter that only grows (one zeroed
// word a launch): the block's writes are fenced, then one thread a block
// arrives and waits, with acquire loads, for the arrivals of all blocks.
// It measured faster than cooperative_groups' grid sync on the H100
// (PERF.md). It needs every block resident, which the cooperative launch
// guarantees.
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const __nv_bfloat16* p) {
  return bf16_bits_to_float(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// 16 bytes of T as fp32 into dst (16-byte aligned)
__device__ __forceinline__ void store_as_float(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void store_as_float(float* dst, uint4 raw,
                                               __nv_bfloat16) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      bf16_bits_to_float(raw.x & 0xffffu), bf16_bits_to_float(raw.x >> 16),
      bf16_bits_to_float(raw.y & 0xffffu), bf16_bits_to_float(raw.y >> 16));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      bf16_bits_to_float(raw.z & 0xffffu), bf16_bits_to_float(raw.z >> 16),
      bf16_bits_to_float(raw.w & 0xffffu), bf16_bits_to_float(raw.w >> 16));
}

// Rows n0 .. n0+nb-1 of h_prev into h_s [chunk][hp] as fp32, through L2
// only; zeros past H and in rows nb .. chunk-1. 16-byte loads where every
// row starts 16-byte aligned.
template <typename T, int kChunk>
__device__ __forceinline__ void load_h_chunk(float* h_s, const T* h_prev,
                                             int n0, int nb, int hidden,
                                             int hp) {
  constexpr int kVec = 16 / sizeof(T);
  const T* src = h_prev + static_cast<size_t>(n0) * hidden;
  if (hidden % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // here hp == hidden
    const int per_row = hidden / kVec;
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < nb * per_row; idx += kSeqThreads) {
      const int b = idx / per_row, v = idx - b * per_row;
      store_as_float(h_s + b * hp + v * kVec, __ldcg(src4 + idx), T());
    }
    for (int idx = nb * hp + threadIdx.x; idx < kChunk * hp;
         idx += kSeqThreads) {
      h_s[idx] = 0.f;
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kChunk * hp; idx += kSeqThreads) {
      const int b = idx / hp, k = idx - b * hp;
      h_s[idx] = (b < nb && k < hidden)
                     ? load_l2(src + static_cast<size_t>(b) * hidden + k)
                     : 0.f;
    }
  }
}

// Element idx of a chunk's xproj in shared-memory order [b][gate][unit]:
// xproj[t][n0 + b][gate * H + j0 + unit], 0 past the block's units.
template <typename T>
__device__ __forceinline__ float chunk_xproj(const T* x_t, int idx, int n0,
                                             int rows, int units, int owned,
                                             int hidden, int j0) {
  const int b = idx / rows, r = idx - b * rows;
  const int gate = r / units, u = r - gate * units;
  return u < owned ? to_float(x_t[(static_cast<size_t>(n0 + b) * 4 + gate) *
                                      hidden + j0 + u])
                   : 0.f;
}

// xproj (T, N, 4H), h0 and c0 (N, H), w (4H, H), out (T, N, H), h_last and
// c_out (N, H), counter one zeroed word. In training, gates_out (T, N, 4H)
// fp32 keeps the activated gates i, f, g, o and c_all (T, N, H) every
// step's c in c's dtype, which the backward reads; inference passes null. c_out carries c between steps
// (each block reads back only its own units). out and c_out are written
// here and read again, by other blocks for out, so they are not
// const __restrict__: the compiler must not route their loads through the
// non-coherent path.
template <typename T, int kChunk>
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_seq_kernel(const T* __restrict__ xproj, const T* __restrict__ h0,
                    const T* __restrict__ c0, const T* __restrict__ w, T* out,
                    T* h_last, T* c_out, float* __restrict__ gates_out,
                    T* __restrict__ c_all, unsigned* counter, int steps,
                    int n_rows, int hidden, int units, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int rows = 4 * units;  // gate row r = gate * units + unit
  const int lanes = rows / kSeqTile;
  const int groups = kSeqThreads / lanes;
  const int hp = (hidden + 3) & ~3;
  const int hp4 = hp / 4;
  float* w_s = smem;
  float* h_s = smem + static_cast<size_t>(hp) * rows;
  float* part_s = h_s;
  float* gate_s = h_s + max(kChunk * hp, groups * kChunk * rows);
  float* x_s = gate_s + kChunk * rows;
  float* c_s = x_s + kChunk * rows;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * units;
  const int owned = min(units, hidden - j0);

  // the block's gate rows, once, as fp32: w_s[k / 4][r][k % 4]
  for (int idx = tid; idx < rows * hp; idx += kSeqThreads) {
    const int r = idx / hp, k = idx - r * hp;
    const int gate = r / units, u = r - gate * units;
    float v = 0.f;
    if (u < owned && k < hidden) {
      v = to_float(w[(static_cast<size_t>(gate) * hidden + j0 + u) * hidden + k]);
    }
    w_s[(static_cast<size_t>(k >> 2) * rows + r) * 4 + (k & 3)] = v;
  }

  // this thread: gate rows lane + i * lanes (i < kSeqTile) over float4
  // columns [k4_lo, k4_hi) of K
  const int lane = tid % lanes, group = tid / lanes;
  const bool computes = group < groups;
  const int k4_per = (hp4 + groups - 1) / groups;
  const int k4_lo = group * k4_per;
  const int k4_hi = min(hp4, k4_lo + k4_per);
  const size_t step_elems = static_cast<size_t>(n_rows) * hidden;

  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const T* h_prev =
        s == 0 ? h0 : out + static_cast<size_t>(reverse ? t + 1 : t - 1) * step_elems;
    const T* c_prev = s == 0 ? c0 : c_out;
    const T* x_t = xproj + static_cast<size_t>(t) * 4 * step_elems;
    T* h_t = out + static_cast<size_t>(t) * step_elems;
    for (int n0 = 0; n0 < n_rows; n0 += kChunk) {
      const int nb = min(kChunk, n_rows - n0);
      // the previous chunk's epilogue still reads x_s and c_s
      if (n0 > 0) __syncthreads();
      // the chunk's xproj and c_{t-1} of this block's units: issued before
      // the h loads and stored after them, so that their latencies overlap
      float x_first = 0.f, c_first = 0.f;
      if (tid < nb * rows) {
        x_first = chunk_xproj(x_t, tid, n0, rows, units, owned, hidden, j0);
      }
      if (tid < nb * units) {
        const int b = tid / units, u = tid - b * units;
        if (u < owned) c_first = to_float(c_prev[static_cast<size_t>(n0 + b) * hidden + j0 + u]);
      }
      load_h_chunk<T, kChunk>(h_s, h_prev, n0, nb, hidden, hp);
      if (tid < nb * rows) x_s[tid] = x_first;
      if (tid < nb * units) c_s[tid] = c_first;
      for (int idx = tid + kSeqThreads; idx < nb * rows; idx += kSeqThreads) {
        x_s[idx] = chunk_xproj(x_t, idx, n0, rows, units, owned, hidden, j0);
      }
      for (int idx = tid + kSeqThreads; idx < nb * units; idx += kSeqThreads) {
        const int b = idx / units, u = idx - b * units;
        c_s[idx] = u < owned ? to_float(c_prev[static_cast<size_t>(n0 + b) * hidden + j0 + u]) : 0.f;
      }
      __syncthreads();
      float acc[kSeqTile][kChunk];
#pragma unroll
      for (int i = 0; i < kSeqTile; ++i) {
#pragma unroll
        for (int b = 0; b < kChunk; ++b) acc[i][b] = 0.f;
      }
      if (computes) {
        const float4* w4 = reinterpret_cast<const float4*>(w_s) + lane;
        const float4* h4 = reinterpret_cast<const float4*>(h_s);
#pragma unroll 2
        for (int k4 = k4_lo; k4 < k4_hi; ++k4) {
          float4 wv[kSeqTile];
#pragma unroll
          for (int i = 0; i < kSeqTile; ++i) wv[i] = w4[k4 * rows + i * lanes];
#pragma unroll
          for (int b = 0; b < kChunk; ++b) {
            const float4 hv = h4[b * hp4 + k4];  // one address a K group
#pragma unroll
            for (int i = 0; i < kSeqTile; ++i) {
              acc[i][b] = fmaf(wv[i].x, hv.x, acc[i][b]);
              acc[i][b] = fmaf(wv[i].y, hv.y, acc[i][b]);
              acc[i][b] = fmaf(wv[i].z, hv.z, acc[i][b]);
              acc[i][b] = fmaf(wv[i].w, hv.w, acc[i][b]);
            }
          }
        }
      }
      __syncthreads();  // the partial sums overwrite the h chunk
      if (computes) {
#pragma unroll
        for (int i = 0; i < kSeqTile; ++i) {
#pragma unroll
          for (int b = 0; b < kChunk; ++b) {
            part_s[(group * kChunk + b) * rows + lane + i * lanes] = acc[i][b];
          }
        }
      }
      __syncthreads();
      // the K groups' partial sums, in a fixed order, four at a time
      for (int idx = tid; idx < kChunk * rows; idx += kSeqThreads) {
        const float* p = part_s + idx;
        const int stride = kChunk * rows;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int g = 0;
        for (; g + 4 <= groups; g += 4) {
          s0 += p[g * stride];
          s1 += p[(g + 1) * stride];
          s2 += p[(g + 2) * stride];
          s3 += p[(g + 3) * stride];
        }
        for (; g < groups; ++g) s0 += p[g * stride];
        gate_s[idx] = (s0 + s1) + (s2 + s3);
      }
      __syncthreads();
      for (int idx = tid; idx < nb * units; idx += kSeqThreads) {
        const int b = idx / units, u = idx - b * units;
        if (u >= owned) continue;
        const float* g_b = gate_s + b * rows;
        const float* x_b = x_s + b * rows;
        const float gi = sigmoid(x_b[u] + g_b[u]);
        const float gf = sigmoid(x_b[units + u] + g_b[units + u]);
        const float gg = tanhf(x_b[2 * units + u] + g_b[2 * units + u]);
        const float go = sigmoid(x_b[3 * units + u] + g_b[3 * units + u]);
        const size_t at = static_cast<size_t>(n0 + b) * hidden + j0 + u;
        const float c_new = gf * c_s[idx] + gi * gg;
        const T h_new = from_float<T>(go * tanhf(c_new));
        const T c_kept = from_float<T>(c_new);  // the carry keeps c's dtype
        c_out[at] = c_kept;
        h_t[at] = h_new;
        if (s == steps - 1) h_last[at] = h_new;
        if (gates_out != nullptr) {
          float* g_n = gates_out +
                       (static_cast<size_t>(t) * n_rows + n0 + b) * 4 * hidden +
                       j0 + u;
          g_n[0] = gi;
          g_n[hidden] = gf;
          g_n[2 * hidden] = gg;
          g_n[3 * hidden] = go;
        }
        if (c_all != nullptr) c_all[static_cast<size_t>(t) * step_elems + at] = c_kept;
      }
    }
    if (s + 1 < steps) grid_barrier(counter, (s + 1) * gridDim.x);
  }
}

// `steps` grid barriers and nothing else, on the sequence kernel's grid:
// the latency floor of its time loop.
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_barrier_kernel(unsigned* counter, int steps) {
  for (int s = 0; s < steps; ++s) grid_barrier(counter, (s + 1) * gridDim.x);
}

// A cooperative launch of `kernel` on the plan's grid, refused (with
// cudaErrorCooperativeLaunchTooLarge) before it is made when the grid is
// larger than what can be resident.
template <typename Kernel>
int cooperative_launch(Kernel kernel, const SeqPlan& p, void** args,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kSeqThreads, p.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.blocks > per_sm * sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(p.blocks), dim3(kSeqThreads), args,
                                    p.smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next one
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kChunk>
int seq_launch(const SeqPlan& p, const void* xproj, const void* h0,
               const void* c0, const void* w, void* out, void* h_last,
               void* c_out, void* gates_out, void* c_all, void* counter,
               int steps, int n_rows, int hidden, int reverse,
               cudaStream_t stream) {
  const T* xproj_t = static_cast<const T*>(xproj);
  const T* h0_t = static_cast<const T*>(h0);
  const T* c0_t = static_cast<const T*>(c0);
  const T* w_t = static_cast<const T*>(w);
  T* out_t = static_cast<T*>(out);
  T* h_last_t = static_cast<T*>(h_last);
  T* c_out_t = static_cast<T*>(c_out);
  float* gates_t = static_cast<float*>(gates_out);
  T* c_all_t = static_cast<T*>(c_all);
  unsigned* counter_t = static_cast<unsigned*>(counter);
  int units = p.units;
  void* args[] = {&xproj_t,  &h0_t,    &c0_t,    &w_t,       &out_t,
                  &h_last_t, &c_out_t, &gates_t, &c_all_t,   &counter_t,
                  &steps,    &n_rows,  &hidden,  &units,     &reverse};
  return cooperative_launch(lstm_seq_kernel<T, kChunk>, p, args, stream);
}

template <typename T>
int seq_dispatch(const SeqPlan& p, const void* xproj, const void* h0,
                 const void* c0, const void* w, void* out, void* h_last,
                 void* c_out, void* gates_out, void* c_all, void* counter,
                 int steps, int n_rows, int hidden, int reverse,
                 cudaStream_t stream) {
#define MXT_SEQ_CHUNK(C)                                                 \
  case C:                                                                \
    return seq_launch<T, C>(p, xproj, h0, c0, w, out, h_last, c_out,     \
                            gates_out, c_all, counter, steps, n_rows,    \
                            hidden, reverse, stream);
  switch (p.chunk) {
    MXT_SEQ_CHUNK(1)
    MXT_SEQ_CHUNK(2)
    MXT_SEQ_CHUNK(4)
    MXT_SEQ_CHUNK(8)
    MXT_SEQ_CHUNK(16)
  }
#undef MXT_SEQ_CHUNK
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The backward: the adjoint of the scan over the cell, which the JAX package
// writes in jnp (mxnet_tpu/ops/pallas/lstm.py:_cell_bwd, run once a step by
// jax.vjp of the lax.scan in mxnet_tpu/ops/rnn_ops.py:_run_direction). Per
// step t, from the cotangents dh_t (dy_t plus the carry from step t+1) and
// dc_t, and the gates and c_{t-1} the training forward kept:
//   dc      = dc_t + dh_t * o * (1 - tanh(c_t)^2)
//   dgates  = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh_t*tanh(c_t)*o*(1-o)]
//   dh_{t-1} carry = dgates . w_h2h   (in h's dtype)
//   dc_{t-1} carry = dc * f           (in c's dtype)
// dgates (fp32) is dxproj; dw_h2h = sum_t dgates_t^T h_{t-1} is one large
// product outside the loop (ops/cuda/lstm.py). As in the scan, the carries
// are rounded to the states' dtypes every step, and dh_t = dy_t + carry is
// summed in h's dtype.

// the adjoint of one cell step at (n, j): writes dgates of its four gate
// rows and the dc carry
template <typename T>
__device__ __forceinline__ void cell_adjoint(float dh_carry, float dy,
                                             float dc_in, const float* g_n,
                                             float c_prev, int hidden, int j,
                                             float* dg_n, T* dc_out) {
  const float dh = to_float(from_float<T>(dh_carry + dy));
  const float gi = g_n[j], gf = g_n[hidden + j];
  const float gg = g_n[2 * hidden + j], go = g_n[3 * hidden + j];
  const float c_new = gf * c_prev + gi * gg;
  const float tc = tanhf(c_new);
  const float dc = dc_in + dh * go * (1.f - tc * tc);
  dg_n[j] = dc * gg * gi * (1.f - gi);
  dg_n[hidden + j] = dc * c_prev * gf * (1.f - gf);
  dg_n[2 * hidden + j] = dc * gi * (1.f - gg * gg);
  dg_n[3 * hidden + j] = dh * tc * go * (1.f - go);
  *dc_out = from_float<T>(dc * gf);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// lstm_cell_bwd_kernel: one step of the backward, one launch a step (the
// counterpart of lstm_cell_kernel, for layers whose weights do not fit the
// sequence kernels' shared memory). One block per hidden unit j stages
// column j of w_h2h (row j of w_t = w_h2h^T) as fp32; warps take the batch
// rows in turn and lanes stride along 4H. With gates null it only writes
// dh_out = dg_next . w_h2h (the dh0 of the last step).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_bwd_kernel(const float* dg_next, const T* __restrict__ w_t,
                         const float* __restrict__ gates,
                         const T* __restrict__ c_prev, const T* __restrict__ dy,
                         const T* __restrict__ dh_in, const T* dc_in,
                         float* dg_out, T* dc_out, T* dh_out, int n_rows,
                         int hidden) {
  extern __shared__ float w_col[];  // [4H]
  const int j = blockIdx.x;
  const int k = 4 * hidden;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    w_col[i] = to_float(w_t[static_cast<size_t>(j) * k + i]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int n = warp; n < n_rows; n += kWarps) {
    float acc = 0.f;
    if (dg_next != nullptr) {
      const float* d = dg_next + static_cast<size_t>(n) * k;
      for (int i = lane; i < k; i += 32) acc = fmaf(d[i], w_col[i], acc);
      acc = warp_sum(acc);
    }
    if (lane != 0) continue;
    const size_t at = static_cast<size_t>(n) * hidden + j;
    if (gates == nullptr) {
      dh_out[at] = from_float<T>(acc);
      continue;
    }
    const float dh_carry =
        dg_next != nullptr ? to_float(from_float<T>(acc)) : to_float(dh_in[at]);
    cell_adjoint<T>(dh_carry, to_float(dy[at]), to_float(dc_in[at]),
                    gates + static_cast<size_t>(n) * k, to_float(c_prev[at]),
                    hidden, j, dg_out + static_cast<size_t>(n) * k,
                    dc_out + at);
  }
}

template <typename T>
int cell_bwd_launch(const void* dg_next, const void* w_t, const void* gates,
                    const void* c_prev, const void* dy, const void* dh_in,
                    const void* dc_in, void* dg_out, void* dc_out,
                    void* dh_out, int n_rows, int hidden,
                    cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(hidden) * sizeof(float);
  if (hidden < 1 || n_rows < 1 || smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_cell_bwd_kernel<T><<<hidden, kThreads, smem, stream>>>(
      static_cast<const float*>(dg_next), static_cast<const T*>(w_t),
      static_cast<const float*>(gates), static_cast<const T*>(c_prev),
      static_cast<const T*>(dy), static_cast<const T*>(dh_in),
      static_cast<const T*>(dc_in), static_cast<float*>(dg_out),
      static_cast<T*>(dc_out), static_cast<T*>(dh_out), n_rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

// lstm_seq_bwd_kernel: the backward's whole time loop of one layer and
// direction in one persistent cooperative launch, the mirror of
// lstm_seq_kernel. Its bound is the forward's: the products' 2*T*N*4H*H
// operations (dh = dgates . w_h2h) at the fp32 rate, 256.4 us at T=128,
// N=16, H=1024. As in the forward, w_h2h stays on the chip:
//   - each block owns `units` = ceil(H / SMs) hidden units J and keeps the
//     columns w_h2h[:, J] (4H x units, fp32) in shared memory for all T
//     steps, laid out [units][4H]: the same bytes as the forward's rows;
//   - each phase it reads the previous step's dgates (N, 4H, fp32), written
//     by every block, through L2 only (ld.global.cg) into shared memory,
//     `chunk` batch rows at a time: 4x the bytes of the forward's h chunk,
//     so the chunk is smaller (4 rows at H = 1024 where the forward takes
//     16);
//   - a thread takes float4 columns k4 = tid, tid + 512, ... of K = 4H and
//     keeps one fp32 sum per (batch row, unit), at most 32; a warp sums its
//     lanes' 32 sums with 31 shuffles (lane l ends with sum l), and the 16
//     warps' sums meet in shared memory, added in a fixed order;
//   - the thread that owns (row, unit) applies cell_adjoint and writes the
//     step's dgates for its unit's four gate rows, and keeps the dc carry
//     in dc0 (read back only by itself);
//   - a grid barrier (grid_barrier: fence, then acquire) between phases.
// Phase s (0 <= s <= T) takes the product for the step done in phase s-1
// and runs step t = T-1-s (reverse: t = s); phase T only writes
// dh0 = dgates_0 . w_h2h.

constexpr int kBwdMaxOut = 32;   // (batch row, unit) sums a thread keeps
constexpr int kBwdMaxUnits = 10;  // H <= 1320 on 132 SMs

__host__ __device__ constexpr int bwd_max_chunk(int units) {
  return units * 16 <= kBwdMaxOut  ? 16
         : units * 8 <= kBwdMaxOut ? 8
         : units * 4 <= kBwdMaxOut ? 4
         : units * 2 <= kBwdMaxOut ? 2
                                   : 1;
}

// One level of warp_transpose_sum: lanes with bit S set keep the upper S of
// their 2S sums and send the lower S, the others the reverse.
template <int S>
__device__ __forceinline__ void transpose_level(float (&v)[kBwdMaxOut],
                                                int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// Sums v[i] over the warp's 32 lanes for every i at once; lane l returns
// the sum of v[l]. 31 shuffles where 32 warp_sums take 160.
__device__ __forceinline__ float warp_transpose_sum(float (&v)[kBwdMaxOut]) {
  static_assert(kBwdMaxOut == 32, "one sum a lane");
  const int lane = threadIdx.x & 31;
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

// Dynamic shared memory of a block, in floats: the columns [units][4H]; one
// region that holds the dgates chunk [chunk][4H] during the products and
// the warps' sums [warps][32] after them.
size_t bwd_shared_bytes(int hidden, int units, int chunk) {
  const size_t k = 4 * static_cast<size_t>(hidden);
  const size_t sums = (kSeqThreads / 32) * static_cast<size_t>(kBwdMaxOut);
  const size_t dg = chunk * k;
  return 4 * (units * k + (dg > sums ? dg : sums));
}

bool bwd_plan(int n_rows, int hidden, int sm_count, SeqPlan* p) {
  if (n_rows < 1 || hidden < 1 || sm_count < 1) return false;
  p->units = (hidden + sm_count - 1) / sm_count;
  if (p->units > kBwdMaxUnits) return false;
  p->blocks = (hidden + p->units - 1) / p->units;
  const int max_chunk = bwd_max_chunk(p->units);
  int chunk = 1;
  while (chunk < n_rows && chunk < max_chunk) chunk *= 2;
  while (chunk > 1 && bwd_shared_bytes(hidden, p->units, chunk) > kMaxSharedBytes) {
    chunk /= 2;
  }
  p->chunk = chunk;
  p->smem = bwd_shared_bytes(hidden, p->units, chunk);
  return p->smem <= kMaxSharedBytes;
}

template <typename T, int kUnits>
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_seq_bwd_kernel(const T* __restrict__ dout,
                        const T* __restrict__ dh_last,
                        const T* __restrict__ dc_last,
                        const float* __restrict__ gates,
                        const T* __restrict__ cs, const T* __restrict__ c0,
                        const T* __restrict__ w, float* dgates, T* dh0,
                        T* dc0, unsigned* counter, int steps, int n_rows,
                        int hidden, int chunk, int reverse) {
  constexpr int kMaxChunk = bwd_max_chunk(kUnits);
  constexpr int kWarpsSeq = kSeqThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int k4n = hidden;  // float4s in a row of 4H
  const size_t krow = 4 * static_cast<size_t>(hidden);
  float* w_s = smem;                   // [kUnits][4H]
  float* dg_s = smem + kUnits * krow;  // [chunk][4H], then the warps' sums
  float* sum_s = dg_s;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int j0 = blockIdx.x * kUnits;
  const int owned = min(kUnits, hidden - j0);

  // the block's columns, once, as fp32
  for (int idx = tid; idx < kUnits * static_cast<int>(krow); idx += kSeqThreads) {
    const int r = idx / kUnits, u = idx - r * kUnits;
    w_s[u * krow + r] =
        u < owned ? to_float(w[static_cast<size_t>(r) * hidden + j0 + u]) : 0.f;
  }

  const size_t step_elems = static_cast<size_t>(n_rows) * hidden;
  const size_t gate_elems = static_cast<size_t>(n_rows) * krow;
  for (int s = 0; s <= steps; ++s) {
    const int t = reverse ? s : steps - 1 - s;
    // the step done in the previous phase, whose dgates this phase reads
    const int t_done = reverse ? t - 1 : t + 1;
    for (int n0 = 0; n0 < n_rows; n0 += chunk) {
      const int nb = min(chunk, n_rows - n0);
      // the columns are staged, or the previous chunk's sums are read
      __syncthreads();
      if (s > 0) {
        const float4* src = reinterpret_cast<const float4*>(
            dgates + t_done * gate_elems + n0 * krow);
        float4* dst = reinterpret_cast<float4*>(dg_s);
#pragma unroll 4
        for (int idx = tid; idx < nb * k4n; idx += kSeqThreads) {
          dst[idx] = __ldcg(src + idx);
        }
        __syncthreads();
        float acc[kBwdMaxOut];
#pragma unroll
        for (int i = 0; i < kBwdMaxOut; ++i) acc[i] = 0.f;
        const float4* w4 = reinterpret_cast<const float4*>(w_s);
        const float4* d4 = reinterpret_cast<const float4*>(dg_s);
        for (int k4 = tid; k4 < k4n; k4 += kSeqThreads) {
          float4 wv[kUnits];
#pragma unroll
          for (int u = 0; u < kUnits; ++u) wv[u] = w4[u * k4n + k4];
#pragma unroll
          for (int b = 0; b < kMaxChunk; ++b) {
            if (b < nb) {
              const float4 d = d4[b * k4n + k4];
#pragma unroll
              for (int u = 0; u < kUnits; ++u) {
                float a = acc[b * kUnits + u];
                a = fmaf(d.x, wv[u].x, a);
                a = fmaf(d.y, wv[u].y, a);
                a = fmaf(d.z, wv[u].z, a);
                a = fmaf(d.w, wv[u].w, a);
                acc[b * kUnits + u] = a;
              }
            }
          }
        }
        __syncthreads();  // the sums overwrite the dgates chunk
        const float v = warp_transpose_sum(acc);
        if (lane < kMaxChunk * kUnits) sum_s[warp * kBwdMaxOut + lane] = v;
        __syncthreads();
      }
      if (tid < nb * kUnits) {
        const int b = tid / kUnits, u = tid - b * kUnits;
        if (u < owned) {
          float prod = 0.f;
          if (s > 0) {
            for (int g = 0; g < kWarpsSeq; ++g) prod += sum_s[g * kBwdMaxOut + tid];
          }
          const int n = n0 + b, j = j0 + u;
          const size_t at = static_cast<size_t>(n) * hidden + j;
          if (s == steps) {
            dh0[at] = from_float<T>(prod);
          } else {
            const float dh_carry =
                s == 0 ? to_float(dh_last[at]) : to_float(from_float<T>(prod));
            const float dc_in = to_float(s == 0 ? dc_last[at] : dc0[at]);
            const bool first = reverse ? t == steps - 1 : t == 0;
            const float c_prev = to_float(
                first ? c0[at]
                      : cs[static_cast<size_t>(reverse ? t + 1 : t - 1) * step_elems + at]);
            const size_t g_at = t * gate_elems + n * krow;
            cell_adjoint<T>(dh_carry, to_float(dout[t * step_elems + at]), dc_in,
                            gates + g_at, c_prev, hidden, j, dgates + g_at,
                            dc0 + at);
          }
        }
      }
    }
    if (s < steps) grid_barrier(counter, (s + 1) * gridDim.x);
  }
}

template <typename T, int kUnits>
int seq_bwd_launch(const SeqPlan& p, const void* dout, const void* dh_last,
                   const void* dc_last, const void* gates, const void* cs,
                   const void* c0, const void* w, void* dgates, void* dh0,
                   void* dc0, void* counter, int steps, int n_rows,
                   int hidden, int reverse, cudaStream_t stream) {
  const T* dout_t = static_cast<const T*>(dout);
  const T* dh_last_t = static_cast<const T*>(dh_last);
  const T* dc_last_t = static_cast<const T*>(dc_last);
  const float* gates_t = static_cast<const float*>(gates);
  const T* cs_t = static_cast<const T*>(cs);
  const T* c0_t = static_cast<const T*>(c0);
  const T* w_t = static_cast<const T*>(w);
  float* dgates_t = static_cast<float*>(dgates);
  T* dh0_t = static_cast<T*>(dh0);
  T* dc0_t = static_cast<T*>(dc0);
  unsigned* counter_t = static_cast<unsigned*>(counter);
  int chunk = p.chunk;
  void* args[] = {&dout_t,   &dh_last_t, &dc_last_t, &gates_t, &cs_t,
                  &c0_t,     &w_t,       &dgates_t,  &dh0_t,   &dc0_t,
                  &counter_t, &steps,    &n_rows,    &hidden,  &chunk,
                  &reverse};
  return cooperative_launch(lstm_seq_bwd_kernel<T, kUnits>, p, args, stream);
}

template <typename T>
int seq_bwd_dispatch(const SeqPlan& p, const void* dout, const void* dh_last,
                     const void* dc_last, const void* gates, const void* cs,
                     const void* c0, const void* w, void* dgates, void* dh0,
                     void* dc0, void* counter, int steps, int n_rows,
                     int hidden, int reverse, cudaStream_t stream) {
#define MXT_BWD_UNITS(U)                                                    \
  case U:                                                                   \
    return seq_bwd_launch<T, U>(p, dout, dh_last, dc_last, gates, cs, c0,   \
                                w, dgates, dh0, dc0, counter, steps,        \
                                n_rows, hidden, reverse, stream);
  switch (p.units) {
    MXT_BWD_UNITS(1)
    MXT_BWD_UNITS(2)
    MXT_BWD_UNITS(3)
    MXT_BWD_UNITS(4)
    MXT_BWD_UNITS(5)
    MXT_BWD_UNITS(6)
    MXT_BWD_UNITS(7)
    MXT_BWD_UNITS(8)
    MXT_BWD_UNITS(9)
    MXT_BWD_UNITS(10)
  }
#undef MXT_BWD_UNITS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
// gates_out: (N, 4H) fp32 for the activated gates, or null.
int lstm_cell_forward(const void* xproj, const void* h, const void* c,
                      const void* w, void* h_out, void* c_out,
                      void* gates_out, int n_rows, int hidden, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(xproj, h, c, w, h_out, c_out, gates_out, n_rows,
                         hidden, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(xproj, h, c, w, h_out, c_out, gates_out,
                                 n_rows, hidden, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared bytes a block of the sequence kernel takes for N rows
// of H units planned on sm_count SMs, or -1 when the weights do not fit.
int lstm_sequence_shared_bytes(int n_rows, int hidden, int sm_count) {
  SeqPlan p;
  return seq_plan(n_rows, hidden, sm_count, &p) ? static_cast<int>(p.smem)
                                                : -1;
}

// One layer and direction over T steps in one cooperative launch planned on
// sm_count SMs; counter is one zeroed uint32 for the grid barrier. In
// training gates_out (T, N, 4H) fp32 and c_all (T, N, H) keep what the
// backward reads; inference passes null for both. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch.
int lstm_sequence_forward(const void* xproj, const void* h0, const void* c0,
                          const void* w, void* out, void* h_last, void* c_last,
                          void* gates_out, void* c_all, void* counter,
                          int steps, int n_rows, int hidden, int dtype,
                          int reverse, int sm_count, void* stream) {
  SeqPlan p;
  if (steps < 1 || !seq_plan(n_rows, hidden, sm_count, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rev = reverse ? 1 : 0;
  if (dtype == 0) {
    return seq_dispatch<float>(p, xproj, h0, c0, w, out, h_last, c_last,
                               gates_out, c_all, counter, steps, n_rows,
                               hidden, rev, s);
  }
  if (dtype == 1) {
    return seq_dispatch<__nv_bfloat16>(p, xproj, h0, c0, w, out, h_last,
                                       c_last, gates_out, c_all, counter,
                                       steps, n_rows, hidden, rev, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// `steps` grid barriers on the grid the sequence kernel takes for (N, H),
// with no step body; counter is one zeroed uint32.
int lstm_sequence_barriers(void* counter, int steps, int n_rows, int hidden,
                           int sm_count, void* stream) {
  SeqPlan p;
  if (steps < 1 || !seq_plan(n_rows, hidden, sm_count, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned* counter_t = static_cast<unsigned*>(counter);
  void* args[] = {&counter_t, &steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cooperative_launch(lstm_barrier_kernel, p, args, s);
}

// One step of the backward (lstm_cell_bwd_kernel): dg_next (N, 4H) fp32 or
// null at the first step, w_t = w_h2h^T (H, 4H), gates (N, 4H) fp32 or null
// to write only dh_out, c_prev, dy, dh_in, dc_in, dc_out, dh_out (N, H),
// dg_out (N, 4H) fp32. dc_in and dc_out may be one buffer. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int lstm_cell_backward(const void* dg_next, const void* w_t, const void* gates,
                       const void* c_prev, const void* dy, const void* dh_in,
                       const void* dc_in, void* dg_out, void* dc_out,
                       void* dh_out, int n_rows, int hidden, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return cell_bwd_launch<float>(dg_next, w_t, gates, c_prev, dy, dh_in,
                                  dc_in, dg_out, dc_out, dh_out, n_rows,
                                  hidden, s);
  }
  if (dtype == 1) {
    return cell_bwd_launch<__nv_bfloat16>(dg_next, w_t, gates, c_prev, dy,
                                          dh_in, dc_in, dg_out, dc_out,
                                          dh_out, n_rows, hidden, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared bytes a block of the backward sequence kernel takes
// for N rows of H units on sm_count SMs, or -1 when the columns do not fit.
int lstm_sequence_backward_shared_bytes(int n_rows, int hidden, int sm_count) {
  SeqPlan p;
  return bwd_plan(n_rows, hidden, sm_count, &p) ? static_cast<int>(p.smem)
                                                : -1;
}

// The backward of one layer and direction over T steps in one cooperative
// launch: dout (T, N, H), dh_last, dc_last, c0 (N, H), gates (T, N, 4H) fp32
// and cs (T, N, H) from the training forward, w (4H, H); writes dgates
// (T, N, 4H) fp32, dh0 and dc0 (N, H). counter is one zeroed uint32. dtype:
// 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int lstm_sequence_backward(const void* dout, const void* dh_last,
                           const void* dc_last, const void* gates,
                           const void* cs, const void* c0, const void* w,
                           void* dgates, void* dh0, void* dc0, void* counter,
                           int steps, int n_rows, int hidden, int dtype,
                           int reverse, int sm_count, void* stream) {
  SeqPlan p;
  if (steps < 1 || !bwd_plan(n_rows, hidden, sm_count, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rev = reverse ? 1 : 0;
  if (dtype == 0) {
    return seq_bwd_dispatch<float>(p, dout, dh_last, dc_last, gates, cs, c0,
                                   w, dgates, dh0, dc0, counter, steps,
                                   n_rows, hidden, rev, s);
  }
  if (dtype == 1) {
    return seq_bwd_dispatch<__nv_bfloat16>(p, dout, dh_last, dc_last, gates,
                                           cs, c0, w, dgates, dh0, dc0,
                                           counter, steps, n_rows, hidden,
                                           rev, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
