// PTX wrappers and the packed trunk layout for Hopper (sm_90a), shared by
// fused_trunk.cu (trunk widths 128 and 256) and trunk_wide.cu (384 and up):
// wgmma on register or shared-memory operands with the 128-byte swizzle,
// mbarriers, TMA and bulk copies (a multicast to the blocks of a cluster
// included), and the tensor-map encoder reached through the runtime's driver
// entry point. Everything here is inline; a source that includes it compiles
// to the same code as with the definitions written out in it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DENS_PAD = 128;  // extra columns of the last layer (density in the first)

__host__ __device__ __forceinline__ int layer_in(int l, int skip, int H, int KIN) {
  return l == 0 ? KIN : (l == skip ? H + KIN : H);
}
__host__ __device__ __forceinline__ int layer_out(int l, int L, int H) {
  return l == L - 1 ? H + DENS_PAD : H;
}
__host__ __device__ __forceinline__ long w_offset(int l, int L, int skip, int H, int KIN) {
  long o = 0;
  for (int i = 0; i < l; ++i) o += (long)layer_in(i, skip, H, KIN) * layer_out(i, L, H);
  return o;
}
// hidden layer l is stored by a forward of activation-checkpoint stride `ckpt` (the reference's
// _stored_layers: k-1, 2k-1, ... up to L-2; none for ckpt <= 0), in slot l / ckpt of the stored
// [ckpt_count, n, H]
__host__ __device__ __forceinline__ bool ckpt_stored(int l, int ckpt) { return ckpt > 0 && (l + 1) % ckpt == 0; }
__host__ __device__ __forceinline__ int ckpt_count(int L, int ckpt) { return ckpt > 0 ? (L - 1) / ckpt : 0; }

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma (sm_90a). A comes from registers (the `_rs` forms) or from shared
// memory; B from shared memory, 128-byte swizzled. In the A register layout a
// thread holds rows r_lo = 16 wq + lane / 4 and r_hi = r_lo + 8 of the
// warpgroup's 64, columns 16 s + 8 h + 2 q (+1) of k16 slice s in A[4 s + 2 h]
// (r_lo) and A[4 s + 2 h + 1] (r_hi), q = lane % 4; accumulator chunk j = 2 s
// + h holds the same positions, so a product's accumulator, packed to bf16,
// is the A operand of the next layer's product.

__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the 64 f32 accumulators of an m64n128 product, operands %0..%63, and their list in the asm string
#define WG_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WG_D64                                                                      \
  "{"                                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
  "}"

// d (+)= A (registers) x B (shared memory, MN-major), m64n128
__device__ __forceinline__ void wgmma_m64n128_rs_t(float (&d)[64], const uint32_t* a, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// d (+)= A x B, m64n128, both from shared memory; TA / TB: operand MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_ACC64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// mbarrier, bulk copies, named barriers, register reallocation
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits for the completion of the phase of parity `parity`; traps (a launch
// error, not a hang) after 2^24 polls, which only a fault in the pipeline's
// bookkeeping can cause. One asm statement: a C++ loop around the poll would
// be a divergent path between wgmma batches, and ptxas then serializes them.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1, P2;\n.reg .u32 tries;\nmov.u32 tries, 0;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 tries, tries, 1;\n"
      "setp.gt.u32 P2, tries, 16777216;\n"
      "@P2 trap;\n"
      "bra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// a [64 rows x 64 bf16] box of a 2-D tensor map at (x, y), 128-byte swizzle
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// shared -> global, tracked by this thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the packed weights as the forward and the backward chain read them, in 64 x 64
// boxes with the 128-byte swizzle
struct WeightMaps {
  CUtensorMap hidden;  // layers 0..L-2 as one [rows, H] matrix: W_l[k] is row w_offset(l) / H + k
  CUtensorMap last;    // layer L-1, [K, H + DENS_PAD]
};

__device__ __forceinline__ uint32_t mask_pack(float v0, float v1, uint32_t m) {
  const float2 mf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&m));
  __nv_bfloat162 o = __floats2bfloat162_rn(mf.x > 0.f ? v0 : 0.f, mf.y > 0.f ? v1 : 0.f);
  return *reinterpret_cast<uint32_t*>(&o);
}
__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&o);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// The warp's column sums of a pass: v[2j + e] is this thread's partial (its
// two rows) of column c0 + 8j + 2q + e. A reduce-scatter over the warp's 8
// row groups: each exchange halves what a lane holds (16 + 8 + 4 shuffles,
// against 3 per column for a full butterfly), and each lane ends with the
// sums of 4 distinct columns in v[0..3]: v[t] is column c0 + 8 (i >> 1) + 2q +
// (i & 1), i = t + 16 (lane bit 2) + 8 (lane bit 3) + 4 (lane bit 4).
__device__ __forceinline__ void colsum32_scatter(float (&v)[32], int lane) {
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float keep = b2 ? v[i + 16] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, b2 ? v[i] : v[i + 16], 4);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = b3 ? v[i + 8] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, b3 ? v[i] : v[i + 8], 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
  }
}
// colsum32_scatter, the 4 sums of each lane added to s with shared atomics
__device__ __forceinline__ void colsum32_add(float* s, int c0, float (&v)[32], int lane) {
  colsum32_scatter(v, lane);
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  const int base = (b2 ? 16 : 0) + (b3 ? 8 : 0) + (b4 ? 4 : 0);  // v[t] is column index base + t
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int idx = base + t;
    atomicAdd(s + c0 + 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1), v[t]);
  }
}

// the 128 f32 accumulators of an m64n256 product, operands %0..%127
#define WG_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),\
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),\
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),\
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),\
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),\
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),\
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),\
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),\
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),\
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),\
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),\
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),\
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),\
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),\
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),\
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (+)= A x B, both from shared memory; TA / TB: operand MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_ACC128
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}
// d (+)= A (registers) x B (shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n256_rs_t(float (&d)[128], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// MN-major operand with the 128-byte swizzle: 64-element atoms along M/N
// `lbo` bytes apart, 8-deep groups along the reduction 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global through a tensor map, tracked by this thread's bulk groups
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int x, int y, const void* src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(x), "r"(y), "r"(smem_u32(src))
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int x, int y, int z, const void* src) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(x), "r"(y), "r"(z), "r"(smem_u32(src))
               : "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: nothing links libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)fn : nullptr;
}

// bf16 tensor of `rank` dims (innermost first, packed), boxes of `box`; out of range reads as zeros
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank, std::array<cuuint64_t, 3> dims,
             std::array<cuuint32_t, 3> box, bool swizzle) {
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims.data(),
                            strides, box.data(), elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int make_weight_maps(EncodeTiled encode, WeightMaps* maps, const void* w, int L, int skip, int H, int KIN) {
  const long last = w_offset(L - 1, L, skip, H, KIN);
  const int err = make_map(encode, &maps->hidden, w, 2, {(cuuint64_t)H, (cuuint64_t)(last / H), 1}, {64, 64, 1}, true);
  if (err) return err;
  return make_map(encode, &maps->last, (const bf16*)w + last, 2,
                  {(cuuint64_t)(H + DENS_PAD), (cuuint64_t)layer_in(L - 1, skip, H, KIN), 1}, {64, 64, 1}, true);
}

// d (+)= A x B, m64n64, both from shared memory; TA / TB: operand MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A x B on shared-memory operands, m64nN for N = 64, 128 or 256
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256)
    wgmma_m64n256_ss<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_m64n128_ss<TA, TB>(d, da, db, scale_d);
  else
    wgmma_m64n64_ss<TA, TB>(d, da, db, scale_d);
}

// a 2-D box at (x, y) into this block's `dst` and the same offset in every
// block of `mask` in the cluster, completion counted on each one's `bar`
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
// the same for a 3-D box at (x, y, z)
__device__ __forceinline__ void tma_load_3d_mc(void* dst, const CUtensorMap* map, int x, int y, int z, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}
// arrives, where `pred`, on the barrier at `bar`'s offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 ra;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace
