// Fused LSTM cell forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/lstm.py:_lstm_kernel
// (launched by _cell_pallas, once per time step of the RNN op). One launch
// computes one LSTM step, exactly as that kernel does:
//   gates = xproj + h . w_h2h^T, accumulated in fp32, gate order i, f, g, o
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with h' and c' cast to the types of h and c. The product is computed here,
// inside the kernel, as the TPU kernel computes it inside itself.
//
// Bound. A launch must read w_h2h (4H x H) once, read xproj, h and c once,
// and write h' and c'. At N = 16, H = 1024 in fp32 that is 16.8 MB of
// weights plus 0.4 MB of activations: 5.1 us at 3.35 TB/s, against 2.0 us
// for the 134 MFLOP at 67 TFLOP/s fp32. Device-memory bytes bound it at
// every row count the predictor serves; at N = 1 the bytes, and so the
// bound, are nearly the same. (Both layers' w_h2h, 33.6 MB, fit in the
// 50 MB L2, so along a sequence the weights can come from L2 instead.)
//
// Design. One block per hidden unit j. The block stages its four gate rows
// w_h2h[k*H + j, :] (k = 0..3) in shared memory as fp32 (16 KB at H = 1024),
// so each weight byte leaves device memory once per launch however many
// rows there are. Warps take the batch rows n in turn. Lanes stride along H,
// neighbouring lanes on neighbouring addresses so that loads coalesce, and
// keep four fp32 partial sums that a warp-shuffle reduction combines. Lane 0
// then adds xproj, applies the nonlinearities and writes h'[n, j] and
// c'[n, j]. The grid has H blocks (1024 at the served width), which fills the
// 132 SMs; h[n, :] is re-read by every block, from L2. Tensor cores (wgmma),
// TMA and a persistent kernel over the time loop are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
