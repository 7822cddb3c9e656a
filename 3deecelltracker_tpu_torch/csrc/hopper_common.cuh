// Hopper building blocks shared by the tensor-core kernels
// (conv3x3x3_wgmma.cu, conv3x3x3_wgmma_bf16.cu, ladder.cu): mbarriers, TMA
// and bulk copies, the TF32 hi/lo split, wgmma m64nNk8 TF32 with A from
// registers and B from shared memory in the canonical K-major no-swizzle
// layout, the bf16 pair conversion, wgmma m64nNk16 bf16 with A and B from
// shared memory in the same layout, and the tensor-map encoder,
// cuTensorMapEncodeTiled.  Everything is inline in an anonymous
// namespace, so each kernel source compiles its own copy and its code is
// what it was when these lived in that source.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int N>
struct Acc {
  float r[N / 2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the 5-D tensor map's box at (c, x, y, z, b); out-of-bounds reads 0
__device__ __forceinline__ void tma_halo(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int x, int y,
                                         int z, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(z),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// B operand: K-major, no swizzle; a core matrix is 8 (n) rows of 16 bytes
// (4 k); the two core matrices of a k8 step lie 128 bytes apart (leading
// byte offset), successive 8-column groups of n 256 bytes apart (stride byte
// offset)
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
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

// keep the compiler from moving accumulator accesses across the wgmmas
template <int N>
__device__ __forceinline__ void fence_acc(Acc<N>& d) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d.r[i])::"memory");
}

// D = A (64 x 8, registers) * B (8 x N, shared memory) (+ D if accumulate),
// TF32 in, f32 out
__device__ __forceinline__ void wgmma_tf32(Acc<8>& d, const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(Acc<16>& d, const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(Acc<32>& d, const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(Acc<64>& d, const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]),
        "+f"(d.r[16]), "+f"(d.r[17]), "+f"(d.r[18]), "+f"(d.r[19]),
        "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]),
        "+f"(d.r[28]), "+f"(d.r[29]), "+f"(d.r[30]), "+f"(d.r[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(Acc<128>& d, const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]),
        "+f"(d.r[16]), "+f"(d.r[17]), "+f"(d.r[18]), "+f"(d.r[19]),
        "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]),
        "+f"(d.r[28]), "+f"(d.r[29]), "+f"(d.r[30]), "+f"(d.r[31]),
        "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]),
        "+f"(d.r[40]), "+f"(d.r[41]), "+f"(d.r[42]), "+f"(d.r[43]),
        "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]),
        "+f"(d.r[52]), "+f"(d.r[53]), "+f"(d.r[54]), "+f"(d.r[55]),
        "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// two f32 -> a bf16 pair, each rounded to nearest even: lo in bits 0-15,
// hi in bits 16-31 (cvt.rn.bf16x2.f32 puts its first source in the upper
// half)
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a shared-memory matrix descriptor, K-major, no swizzle: core matrices of
// 8 rows of 16 bytes, `lbo` bytes apart along K and `sbo` bytes apart along
// M (or N)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

// D = A (64 x 16, shared memory, descriptor a_desc) * B (16 x N, shared
// memory, b_desc) (+ D if accumulate), bf16 in, f32 out, both K-major (a
// core matrix being 8 rows of 16 bytes, 8 k)
__device__ __forceinline__ void wgmma_bf16_ss(Acc<8>& d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss(Acc<16>& d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss(Acc<32>& d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss(Acc<64>& d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]),
        "+f"(d.r[16]), "+f"(d.r[17]), "+f"(d.r[18]), "+f"(d.r[19]),
        "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]),
        "+f"(d.r[28]), "+f"(d.r[29]), "+f"(d.r[30]), "+f"(d.r[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_ss(Acc<128>& d, uint64_t a_desc,
                                              uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]),
        "+f"(d.r[4]), "+f"(d.r[5]), "+f"(d.r[6]), "+f"(d.r[7]),
        "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]),
        "+f"(d.r[16]), "+f"(d.r[17]), "+f"(d.r[18]), "+f"(d.r[19]),
        "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]),
        "+f"(d.r[28]), "+f"(d.r[29]), "+f"(d.r[30]), "+f"(d.r[31]),
        "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]),
        "+f"(d.r[40]), "+f"(d.r[41]), "+f"(d.r[42]), "+f"(d.r[43]),
        "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]),
        "+f"(d.r[52]), "+f"(d.r[53]), "+f"(d.r[54]), "+f"(d.r[55]),
        "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that nothing links
// libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 5-D tensor map over x (f32 unless `type` says otherwise): dims
// innermost first, the byte strides of dims 1-4, the box; no swizzle,
// out-of-bounds elements read 0.  False when cuTensorMapEncodeTiled is
// missing or refuses the map.
inline bool encode_map_5d(
    CUtensorMap* map, const void* x, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, type, 5, const_cast<void*>(x),
                dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
