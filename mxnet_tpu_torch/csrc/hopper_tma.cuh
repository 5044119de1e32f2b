// Hopper (sm_90a) building blocks shared by the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu): mbarriers,
// TMA tile and bulk loads, wgmma matrix descriptors and products, the 4-D
// tensor maps over (B, H, S, D) operands, and the per-64-position summary
// of packed segment ids that both use to skip tiles. Everything sits in an
// unnamed namespace: each source that includes this file gets its own copy
// (its own seg_ranges_kernel among them). The build hashes this file into
// the name of every library whose source includes it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kPanelBytes = 128;  // a row of one 64-column 16-bit panel

// Whether a 16-bit element type is fp16 (else bf16): it picks the .f16 or
// the .bf16 form of a tensor-core product. Tiles, swizzles and fragments
// are the same for both.
template <typename T>
constexpr bool kIsF16 = std::is_same<T, __half>::value;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box of `map` into shared memory at dst, completing on bar. The
// map's dims 1-3 hold S, H and B in the order `slots` gives (2 bits each:
// the map dim of S, of H, of B).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int slots, int col,
                                         int row, int h, int b) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[i] = (slots & 3) == i + 1 ? row : ((slots >> 2) & 3) == i + 1 ? h : b;
  }
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c[0]), "r"(c[1]),
      "r"(c[2]), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units) and the
// swizzle mode (1 = 128B) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's uses of an accumulator register after the wgmma
// wait (and its writes before the next wgmma): the register is an operand
// of an opaque statement that sits between them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma products below, each in two forms: .bf16 and, with F16, .f16
// inputs (TY), fp32 accumulation.
#define MXT_ACC64                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define MXT_ACC128                                                         \
  MXT_ACC64, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define MXT_REGS32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define MXT_REGS64                                                         \
  MXT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "   \
             "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
             "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (+)= A B for a 64 x 16 A and a 16 x 128 B, both read from shared memory
// through descriptors (K-major), into a 64 x 128 fp32 accumulator.
#define MXT_WGMMA_N128_SS(TY)                                              \
  asm volatile("{\n.reg .pred p;\n"                                        \
               "setp.ne.b32 p, %66, 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
               " {" MXT_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"          \
               : MXT_ACC128                                                \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  if constexpr (F16) {
    MXT_WGMMA_N128_SS("f16");
  } else {
    MXT_WGMMA_N128_SS("bf16");
  }
}

// d (+)= A B for a 64 x 16 A and a 16 x 64 B, both read from shared memory
// through descriptors, into a 64 x 64 fp32 accumulator. TRANS_A, TRANS_B:
// 0 reads the operand K-major (its 16-wide depth contiguous, as a row-major
// A or an N x K B is stored), 1 MN-major (the descriptor's transpose bit:
// rows or columns contiguous, as a K x N B is stored row-major).
#define MXT_WGMMA_N64_SS(TY)                                               \
  asm volatile("{\n.reg .pred p;\n"                                        \
               "setp.ne.b32 p, %34, 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " {" MXT_REGS32 "}, %32, %33, p, 1, 1, %35, %36;\n}\n"      \
               : MXT_ACC64                                                 \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),  \
                 "n"(TRANS_B))
template <int TRANS_A = 0, int TRANS_B = 0, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  if constexpr (F16) {
    MXT_WGMMA_N64_SS("f16");
  } else {
    MXT_WGMMA_N64_SS("bf16");
  }
}

// d += A B for a 64 x 16 A in registers (the mma.sync m16n8k16 A
// fragment of each warp's 16 rows) and a 16 x 64 B read from shared
// memory through a descriptor, MN-major (transposed), into 64 x 64 fp32.
#define MXT_WGMMA_N64_RS(TY)                                               \
  asm volatile("{\n.reg .pred p;\n"                                        \
               "setp.ne.b32 p, %37, 0;\n"                                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
               " {" MXT_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, "   \
               "1;\n}\n"                                                   \
               : MXT_ACC64                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),  \
                 "r"(1))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  if constexpr (F16) {
    MXT_WGMMA_N64_RS("f16");
  } else {
    MXT_WGMMA_N64_RS("bf16");
  }
}

#undef MXT_WGMMA_N64_RS
#undef MXT_WGMMA_N64_SS
#undef MXT_WGMMA_N128_SS
#undef MXT_REGS64
#undef MXT_REGS32
#undef MXT_ACC128
#undef MXT_ACC64

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Segment ids are summed up in chunks of this many positions (a Q tile of
// a consumer, half or all of a K tile).
constexpr int kSegChunk = 64;
constexpr int kSegPad = 128;  // the padded id rows' length is a multiple

// The segment ids of each row summed up in chunks of kSegChunk positions,
// for the Hopper kernels' tile skipping: per (b, chunk) the smallest and
// the largest positive id (INT_MAX and 0 where it holds none) and the one
// id that fills the whole chunk (0 where none does: two ids, a pad or a
// position past S). Also writes the ids into rows of s_pad, zeros past S,
// so that a producer can bulk-copy a tile's ids (16-byte aligned, in
// bounds). One warp per (chunk, b), two positions a lane.
__global__ void __launch_bounds__(32)
    seg_ranges_kernel(const int* __restrict__ seg, int S, int s_pad,
                      int* __restrict__ seg_pad, int4* __restrict__ range) {
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x;
  int lo = INT_MAX, hi = 0, mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int pos = chunk * kSegChunk + lane + 32 * j;
    const int id = pos < S ? seg[static_cast<size_t>(b) * S + pos] : 0;
    seg_pad[static_cast<size_t>(b) * s_pad + pos] = id;
    if (id > 0) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
    mn = min(mn, id);
    mx = max(mx, id);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    range[static_cast<size_t>(b) * (s_pad / kSegChunk) + chunk] =
        make_int4(lo, hi, mn == mx && mn > 0 ? mn : 0, 0);
  }
}

// Whether a query range (lo, hi) and a key range (lo, hi, ...) share a
// positive id: a necessary condition for any pair of the two to attend.
__device__ __forceinline__ bool ranges_meet(int2 q, int4 k) {
  return max(q.x, k.x) <= min(q.y, k.y);
}

// The padded length of a row of segment ids that the tile skipping reads.
inline int seg_pad_length(int S) { return (S + kSegPad - 1) / kSegPad * kSegPad; }

// Launches seg_ranges_kernel into seg_scratch (flash_attention_seg_scratch_ints
// of the forward: the padded ids (B, s_pad), then their chunk ranges
// (B, s_pad / kSegChunk, 4)) on `stream`; the cudaError_t of the launch.
inline int launch_seg_ranges(const int* seg, int B, int S, int* seg_scratch,
                             cudaStream_t stream) {
  const int s_pad = seg_pad_length(S);
  int4* range =
      reinterpret_cast<int4*>(seg_scratch + static_cast<size_t>(B) * s_pad);
  seg_ranges_kernel<<<dim3(s_pad / kSegChunk, B), 32, 0, stream>>>(
      seg, S, s_pad, seg_scratch, range);
  return static_cast<int>(cudaGetLastError());
}

// int32s of that scratch
inline size_t seg_scratch_ints(int B, int S) {
  const size_t s_pad = static_cast<size_t>(seg_pad_length(S));
  return static_cast<size_t>(B) * (s_pad + s_pad / kSegChunk * 4);
}

// CUresults of the tensor-map encoding come back offset by kCuBase, apart
// from cudaError_t's.
constexpr int kCuBase = 100000;

// A 4-D TMA map over one 16-bit operand (bf16 or fp16: a tile load copies
// the bits as they are, and the zeros of an out-of-range row are zeros in
// both) of (B, H, S, D) shape with element strides sb, sh, ss (the head dim
// contiguous), boxes of 64 columns (one 128-byte swizzled panel) by
// `box_rows` rows. The outer dims go to the
// map in increasing stride order, a dim of size 1 last with a stride of
// its own (its coordinate is always 0); `slots` records where S, H and B
// went. Out-of-range rows of a box read as zeros.
inline int encode_map(CUtensorMap* map, int* slots, const void* base, int D,
                      int S, int H, int B, long long ss, long long sh,
                      long long sb, int box_rows) {
  struct Dim {
    unsigned long long size, stride;
    int which;  // 0 = S, 1 = H, 2 = B
  };
  Dim dims[3] = {{static_cast<unsigned long long>(S), 2ull * ss, 0},
                 {static_cast<unsigned long long>(H), 2ull * sh, 1},
                 {static_cast<unsigned long long>(B), 2ull * sb, 2}};
  unsigned long long span = 2ull * D;
  for (const Dim& d : dims) {
    if (d.size > 1) span = d.size * d.stride > span ? d.size * d.stride : span;
  }
  for (Dim& d : dims) {
    if (d.size == 1) d.stride = (span + 15) & ~15ull;
  }
  for (int i = 1; i < 3; ++i) {  // insertion sort, stable
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  }
  cuuint64_t size[4] = {static_cast<cuuint64_t>(D), dims[0].size,
                        dims[1].size, dims[2].size};
  cuuint64_t stride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  *slots = 0;
  for (int i = 0; i < 3; ++i) {
    if (dims[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
    *slots |= (i + 1) << (2 * dims[i].which);
  }
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), size,
      stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kCuBase + static_cast<int>(r);
}

// TMA can describe a (B, H, S, D) 16-bit operand: a 16-byte aligned base and
// strides of whole 16-byte units (8 bf16) in every dim of more than one
// element, none of them 0 (a broadcast view).
inline bool tma_operand(const void* ptr, long long sb, long long sh,
                        long long ss, int B, int H, int S) {
  const auto unit = [](long long stride, int size) {
    return size == 1 || (stride > 0 && stride % 8 == 0);
  };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && unit(sb, B) &&
         unit(sh, H) && unit(ss, S);
}

// A decoded error string: kCuBase + a CUresult, or a cudaError_t.
inline const char* error_string(int err) {
  if (err >= kCuBase) {
    const char* msg = nullptr;
    if (cuGetErrorString(static_cast<CUresult>(err - kCuBase), &msg) !=
            CUDA_SUCCESS ||
        msg == nullptr) {
      return "unknown CUDA driver error (tensor map encoding)";
    }
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
