// Runtime compilation of Rtc kernels with NVRTC, with a plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/rtc.py:Rtc._build, which wraps the
// user's body in pl.pallas_call (call at rtc.py:65) and jits it once. Here
// the body is translated to CUDA C by mxnet_tpu_torch/ops/cuda/rtc_codegen.py
// (the kernel template: index math, loads and stores, bf16/fp16 rounding),
// and this library compiles that source at the first push:
//   rtc_compile: NVRTC for sm_90a with --fmad=false and no fast math, so
//                that + - * / give the bits of the plain torch version;
//                takes the cubin (nvrtcGetCUBIN), loads it into the current
//                context (the primary context torch made current) and
//                returns the module and the kernel;
//   rtc_launch:  cuLaunchKernel on the caller's stream (torch's current
//                stream), returning the driver's error code so that a
//                refused launch raises at once.
// A failed compile returns NVRTC's log in the caller's buffer. No call
// synchronizes. Error codes: 0 is success, a positive code below
// kNvrtcBase a CUresult, kNvrtcBase + r an nvrtcResult r.
//
// The module of a body outside the elementwise subset holds one kernel a
// stage (map, reduce, product; rtc_codegen.py:emit_stages); the launcher
// takes each by name (rtc_module_function) and launches them in order on
// one stream, so this interface serves both.
//
// Bound of the elementwise kernels: device-memory bytes bound them:
// each input read once and each output written once (the SGD-momentum
// body on the transformer's 16,384,000-element embedding moves 327.7 MB:
// 97.8 us at 3.35 TB/s). To come near that rate an SM needs tens of KB of
// loads in flight. The scalar kernel (one 4-byte element per thread per
// iteration, the only one for bodies with a strided operand) keeps ~8 KB
// an operand in flight and measured 0.77 of the bound. So where every
// operand is contiguous or a single broadcast element, the generator also
// writes a vector kernel: each thread loads a 16-byte vector of every
// contiguous operand before it computes or stores any (4x the bytes an
// instruction), with the scalar loop as its tail, and its default launch
// covers n in one pass, so that an SM holds as many loads in flight as it
// holds threads (ops/cuda/rtc.py). The launcher takes it when every vector
// pointer of the push is aligned to its vector's width. Broadcast operands
// are re-read from L1/L2.

#include <cuda.h>
#include <nvrtc.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNvrtcBase = 100000;

CUresult ensure_context(int device) {
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return r;
  CUcontext cur = nullptr;
  r = cuCtxGetCurrent(&cur);
  if (r != CUDA_SUCCESS) return r;
  if (cur != nullptr) return CUDA_SUCCESS;
  // no context on this thread yet: use the device's primary context, the
  // one the CUDA runtime (and so torch) uses
  CUdevice dev;
  r = cuDeviceGet(&dev, device);
  if (r != CUDA_SUCCESS) return r;
  CUcontext primary;
  r = cuDevicePrimaryCtxRetain(&primary, dev);
  if (r != CUDA_SUCCESS) return r;
  return cuCtxSetCurrent(primary);
}

void copy_log(nvrtcProgram prog, char* log, size_t cap) {
  if (log == nullptr || cap == 0) return;
  log[0] = '\0';
  size_t size = 0;
  if (nvrtcGetProgramLogSize(prog, &size) != NVRTC_SUCCESS || size == 0) return;
  std::vector<char> buf(size + 1, '\0');
  if (nvrtcGetProgramLog(prog, buf.data()) != NVRTC_SUCCESS) return;
  std::strncpy(log, buf.data(), cap - 1);
  log[cap - 1] = '\0';
}

}  // namespace

extern "C" {

int rtc_nvrtc_version(int* major, int* minor) {
  nvrtcResult r = nvrtcVersion(major, minor);
  return r == NVRTC_SUCCESS ? 0 : kNvrtcBase + r;
}

int rtc_compile(const char* source, const char* kernel_name, const char* arch,
                int device, void** module_out, void** function_out, char* log,
                size_t log_cap) {
  nvrtcProgram prog;
  nvrtcResult nr = nvrtcCreateProgram(&prog, source, "rtc_kernel.cu", 0,
                                      nullptr, nullptr);
  if (nr != NVRTC_SUCCESS) return kNvrtcBase + nr;
  std::string arch_opt = std::string("--gpu-architecture=") + arch;
  const char* opts[] = {arch_opt.c_str(), "--fmad=false", "--std=c++17"};
  nr = nvrtcCompileProgram(prog, 3, opts);
  copy_log(prog, log, log_cap);
  if (nr != NVRTC_SUCCESS) {
    nvrtcDestroyProgram(&prog);
    return kNvrtcBase + nr;
  }
  size_t cubin_size = 0;
  nr = nvrtcGetCUBINSize(prog, &cubin_size);
  std::vector<char> cubin(cubin_size);
  if (nr == NVRTC_SUCCESS) nr = nvrtcGetCUBIN(prog, cubin.data());
  nvrtcDestroyProgram(&prog);
  if (nr != NVRTC_SUCCESS) return kNvrtcBase + nr;

  CUresult r = ensure_context(device);
  if (r != CUDA_SUCCESS) return r;
  CUmodule module;
  r = cuModuleLoadData(&module, cubin.data());
  if (r != CUDA_SUCCESS) return r;
  CUfunction function;
  r = cuModuleGetFunction(&function, module, kernel_name);
  if (r != CUDA_SUCCESS) {
    cuModuleUnload(module);
    return r;
  }
  *module_out = module;
  *function_out = function;
  return 0;
}

// Another kernel of a module rtc_compile loaded (the vector kernel the
// generator writes beside the scalar one).
int rtc_module_function(void* module, const char* kernel_name,
                        void** function_out) {
  CUfunction function;
  const CUresult r = cuModuleGetFunction(
      &function, static_cast<CUmodule>(module), kernel_name);
  if (r != CUDA_SUCCESS) return r;
  *function_out = function;
  return 0;
}

int rtc_launch(void* function, unsigned gx, unsigned gy, unsigned gz,
               unsigned bx, unsigned by, unsigned bz, void* stream,
               void** args) {
  return cuLaunchKernel(static_cast<CUfunction>(function), gx, gy, gz, bx, by,
                        bz, 0, static_cast<CUstream>(stream), args, nullptr);
}

const char* rtc_error_string(int code) {
  if (code >= kNvrtcBase)
    return nvrtcGetErrorString(static_cast<nvrtcResult>(code - kNvrtcBase));
  const char* msg = nullptr;
  if (cuGetErrorString(static_cast<CUresult>(code), &msg) != CUDA_SUCCESS ||
      msg == nullptr)
    return "unknown CUDA driver error";
  return msg;
}

}  // extern "C"
