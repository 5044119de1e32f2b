// LSTM forward for Hopper (sm_90a), with a plain C interface: two kernels.
//
// Both compute what the TPU kernel mxnet_tpu/ops/pallas/lstm.py:_lstm_kernel
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
// through lstm_sequence_shared_bytes.

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
                     T* __restrict__ h_out, T* __restrict__ c_out, int n_rows,
                     int hidden) {
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
    }
  }
}

template <typename T>
int launch(const void* xproj, const void* h, const void* c, const void* w,
           void* h_out, void* c_out, int n_rows, int hidden,
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
      static_cast<T*>(h_out), static_cast<T*>(c_out), n_rows, hidden);
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
// c_out (N, H), counter one zeroed word. c_out carries c between steps
// (each block reads back only its own units). out and c_out are written
// here and read again, by other blocks for out, so they are not
// const __restrict__: the compiler must not route their loads through the
// non-coherent path.
template <typename T, int kChunk>
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_seq_kernel(const T* __restrict__ xproj, const T* __restrict__ h0,
                    const T* __restrict__ c0, const T* __restrict__ w, T* out,
                    T* h_last, T* c_out, unsigned* counter, int steps,
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
        c_out[at] = from_float<T>(c_new);  // the carry keeps c's dtype
        h_t[at] = h_new;
        if (s == steps - 1) h_last[at] = h_new;
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
               void* c_out, void* counter, int steps, int n_rows, int hidden,
               int reverse, cudaStream_t stream) {
  const T* xproj_t = static_cast<const T*>(xproj);
  const T* h0_t = static_cast<const T*>(h0);
  const T* c0_t = static_cast<const T*>(c0);
  const T* w_t = static_cast<const T*>(w);
  T* out_t = static_cast<T*>(out);
  T* h_last_t = static_cast<T*>(h_last);
  T* c_out_t = static_cast<T*>(c_out);
  unsigned* counter_t = static_cast<unsigned*>(counter);
  int units = p.units;
  void* args[] = {&xproj_t, &h0_t,    &c0_t,      &w_t,   &out_t,
                  &h_last_t, &c_out_t, &counter_t, &steps, &n_rows,
                  &hidden,  &units,   &reverse};
  return cooperative_launch(lstm_seq_kernel<T, kChunk>, p, args, stream);
}

template <typename T>
int seq_dispatch(const SeqPlan& p, const void* xproj, const void* h0,
                 const void* c0, const void* w, void* out, void* h_last,
                 void* c_out, void* counter, int steps, int n_rows,
                 int hidden, int reverse, cudaStream_t stream) {
#define MXT_SEQ_CHUNK(C)                                                 \
  case C:                                                                \
    return seq_launch<T, C>(p, xproj, h0, c0, w, out, h_last, c_out,     \
                            counter, steps, n_rows, hidden, reverse,     \
                            stream);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int lstm_cell_forward(const void* xproj, const void* h, const void* c,
                      const void* w, void* h_out, void* c_out, int n_rows,
                      int hidden, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(xproj, h, c, w, h_out, c_out, n_rows, hidden, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(xproj, h, c, w, h_out, c_out, n_rows, hidden,
                                 s);
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
// sm_count SMs; counter is one zeroed uint32 for the grid barrier. dtype:
// 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int lstm_sequence_forward(const void* xproj, const void* h0, const void* c0,
                          const void* w, void* out, void* h_last, void* c_last,
                          void* counter, int steps, int n_rows, int hidden,
                          int dtype, int reverse, int sm_count, void* stream) {
  SeqPlan p;
  if (steps < 1 || !seq_plan(n_rows, hidden, sm_count, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rev = reverse ? 1 : 0;
  if (dtype == 0) {
    return seq_dispatch<float>(p, xproj, h0, c0, w, out, h_last, c_last,
                               counter, steps, n_rows, hidden, rev, s);
  }
  if (dtype == 1) {
    return seq_dispatch<__nv_bfloat16>(p, xproj, h0, c0, w, out, h_last,
                                       c_last, counter, steps, n_rows, hidden,
                                       rev, s);
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

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
