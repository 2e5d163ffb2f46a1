// Fused scene-NeRF trunk for Hopper (sm_90a): forward, backward chain, dW.
//
// Replaces the Pallas TPU kernels `_trunk_fwd_call` and `_trunk_bwd_call` of
// poseprobe_tpu/ops/pallas/fused_mlp.py. The Python side
// (poseprobe_tpu_torch/ops/fused_mlp.py) packs the weights, holds the plain
// PyTorch twin these kernels are tested against, and explains the design.
//
// Packed layout (all row-major, bf16): layer l is a [K_l, NO_l] block of `w`,
// K_l = 64 (l = 0), 256 + 64 (l = skip), 256 otherwise; NO_l = 256, or
// 256 + 128 for the last layer whose columns are [feat(256) | density | 0...].
// Biases are consecutive [NO_l] slices of `b`. Activations and the stored
// hidden layers are [N, 256]; enc and denc are [N, 64].
//
// The forward uses warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with fragments loaded by ldmatrix from shared memory whose rows are padded
// by 16 bytes, so the eight 16-byte rows an ldmatrix reads fall in different
// banks. The backward's two kernels use warpgroup wgmma fed through mbarrier
// rings: the chain by TMA (weights) and bulk copies (mask tiles; g in
// registers), dW by TMA (both operands in shared memory); each has its own
// section below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int H = 256;         // trunk width
constexpr int KIN = 64;        // padded encoding width
constexpr int DENS_PAD = 128;  // extra columns of the last layer (density in the first)
constexpr int T = 128;         // points per block (forward)
constexpr int NB = 128;        // output columns per pass
constexpr int KC = 32;         // reduction rows per streamed weight chunk
constexpr int THREADS = 256;   // 8 warps: 4 along the points x 2 along the columns
constexpr int LDA = H + 8;     // shared row stride (elements) of [T][H] tiles
constexpr int LDE = KIN + 8;   // of [T][KIN] tiles
constexpr int LDW = NB + 8;    // of the forward weight chunk [KC][NB]

constexpr size_t FWD_SMEM = sizeof(bf16) * (2 * T * LDA + T * LDE + 2 * KC * LDW);

__host__ __device__ __forceinline__ int layer_in(int l, int skip) {
  return l == 0 ? KIN : (l == skip ? H + KIN : H);
}
__host__ __device__ __forceinline__ int layer_out(int l, int L) {
  return l == L - 1 ? H + DENS_PAD : H;
}
__host__ __device__ __forceinline__ long w_offset(int l, int L, int skip) {
  long o = 0;
  for (int i = 0; i < l; ++i) o += (long)layer_in(i, skip) * layer_out(i, L);
  return o;
}

// ---------------------------------------------------------------- primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a * b for one 16x8x16 tile
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment (16x16) of a row-major [m][k] tile; p -> element (m0, k0)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* p, int ld, int lane) {
  ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}
// B fragments of two adjacent n-tiles from a row-major [k][n] tile; p -> (k0, n0).
// b[0], b[1] feed n-tile n0, b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* p, int ld, int lane) {
  const int j = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, p + (r + (j & 1) * 8) * ld + (j >> 1) * 8);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// forward weight chunk: rows k0..k0+KC-1, columns n0..n0+NB-1 of w_l [K][NO] -> [KC][LDW]
__device__ __forceinline__ void load_w_kn(bf16* dst, const bf16* wl, int NO, int k0, int n0,
                                          int tid) {
#pragma unroll
  for (int it = 0; it < KC * NB / 8 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / (NB / 8), c = (i % (NB / 8)) * 8;
    cp_async16(dst + r * LDW + c, wl + (long)(k0 + r) * NO + n0 + c, 16);
  }
}

// ------------------------------------------------------------------- forward

// One block per T points. The layer input (enc tile, or the previous
// activation) stays in shared memory; the output of each 128-column pass is
// bias + ReLU + bf16 in registers and written to the other activation buffer.
__global__ void __launch_bounds__(THREADS, 1)
    trunk_fwd_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, bf16* __restrict__ feat,
                     float* __restrict__ dens, bf16* __restrict__ acts, int n, int L, int skip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* act1 = act0 + T * LDA;
  bf16* enc_s = act1 + T * LDA;
  bf16* wbuf = enc_s + T * LDE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // rows wm*32.., columns wn*64.. of a pass
  const int g = lane >> 2, q = lane & 3;
  const long row0 = (long)blockIdx.x * T;
  const int rows = n - row0 < T ? (int)(n - row0) : T;

  for (int i = tid; i < T * (KIN / 8); i += THREADS) {
    const int r = i / (KIN / 8), c = (i % (KIN / 8)) * 8;
    cp_async16(enc_s + r * LDE + c, enc + (row0 + min(r, rows - 1)) * KIN + c,
               r < rows ? 16 : 0);
  }
  cp_async_commit();

  bf16* cur = act0;
  bf16* nxt = act1;
  long w_off = 0;
  for (int l = 0; l < L; ++l) {
    const int K = layer_in(l, skip), NO = layer_out(l, L);
    const bf16* wl = w + w_off;
    const bf16* bl = b + (long)l * H;
    for (int cb = 0; cb < NO / NB; ++cb) {
      const bool dens_pass = cb * NB >= H;  // last layer: only its first column is real
      const bool active = !dens_pass || wn == 0;
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

      const int nk = K / KC;
      load_w_kn(wbuf, wl, NO, 0, cb * NB, tid);
      cp_async_commit();
      for (int c = 0; c < nk; ++c) {
        if (c + 1 < nk) load_w_kn(wbuf + ((c + 1) & 1) * KC * LDW, wl, NO, (c + 1) * KC, cb * NB, tid);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* ws = wbuf + (c & 1) * KC * LDW;
        const int k0 = c * KC;
        const bf16* A;
        int lda;
        if (l == 0) {
          A = enc_s + k0;
          lda = LDE;
        } else if (k0 >= H) {  // skip layer: rows H.. of its weight multiply the encoding
          A = enc_s + (k0 - H);
          lda = LDE;
        } else {
          A = cur + k0;
          lda = LDA;
        }
        if (active) {
#pragma unroll
          for (int kk = 0; kk < KC; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              load_a(a[mt], A + (wm * 32 + mt * 16) * lda + kk, lda, lane);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (dens_pass && np > 0) continue;
              uint32_t bb[4];
              load_b_kn(bb, ws + kk * LDW + wn * 64 + np * 16, LDW, lane);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma16816(acc[mt][2 * np], a[mt], bb[0], bb[1]);
                mma16816(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
              }
            }
          }
        }
        __syncthreads();
      }

      if (!dens_pass) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = cb * NB + wn * 64 + nt * 8 + 2 * q;
          const float b0 = __bfloat162float(bl[col]), b1 = __bfloat162float(bl[col + 1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = wm * 32 + mt * 16 + g;
            store_bf16x2(nxt + r * LDA + col, fmaxf(acc[mt][nt][0] + b0, 0.f),
                         fmaxf(acc[mt][nt][1] + b1, 0.f));
            store_bf16x2(nxt + (r + 8) * LDA + col, fmaxf(acc[mt][nt][2] + b0, 0.f),
                         fmaxf(acc[mt][nt][3] + b1, 0.f));
          }
        }
      } else if (wn == 0 && q == 0) {
        const float bd = __bfloat162float(bl[H]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          if (r < rows) dens[row0 + r] = acc[mt][0][0] + bd;
          if (r + 8 < rows) dens[row0 + r + 8] = acc[mt][0][2] + bd;
        }
      }
    }
    __syncthreads();

    // hidden activation -> acts[l] (if stored); last layer's ReLU'd feat -> feat
    bf16* dst = l < L - 1 ? (acts ? acts + ((long)l * n + row0) * H : nullptr) : feat + row0 * H;
    if (dst) {
      for (int i = tid; i < T * (H / 8); i += THREADS) {
        const int r = i / (H / 8), c = (i % (H / 8)) * 8;
        if (r < rows)
          *reinterpret_cast<uint4*>(dst + (long)r * H + c) =
              *reinterpret_cast<const uint4*>(nxt + r * LDA + c);
      }
    }
    bf16* t = cur;
    cur = nxt;
    nxt = t;
    w_off += (long)K * NO;
  }
}

// ------------------------------------------------------------ backward chain

// wgmma (sm_90a) primitives. A comes from registers: the f32 accumulator of
// one product, masked and packed to bf16, is exactly the A fragment of the
// next layer's k16 slices, so g never returns to shared memory between layers.
// B is a K-major weight tile in shared memory with the 128-byte swizzle.

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

// Backward chain: one block per CH_T = 128 points, two consumer warpgroups of
// 64 points each and one producer warpgroup (warp 8 streams weight tiles,
// warp 9 the per-layer mask tiles; warps 10-11 leave at once).
//
// Layer l (from L-1 down) computes gx = g_l W_l^T over its K_l inputs in
// passes of 128 columns (64 for the encoding part of the skip layer and for
// layer 0) with wgmma m64nNk16, A = g_l in registers (64 x 32-bit per thread
// for the 256-wide reduction), B = weight tiles [N inputs x 64 outputs] from a
// RING-stage ring that the producer fills by TMA straight from the packed
// weights (64 x 64 boxes of two tensor maps, 128-byte swizzle: a row of the
// packed [K, NO] layer is K-major for this product). The epilogue adds the density column's term (last layer), masks with the stored
// activation a_{l-1} (bulk-copied a layer ahead into a padded mask slot: 528-
// byte rows, so the accumulator-layout reads have no bank conflicts), sums db
// in f32 by shuffles and shared atomics (one global atomic per column per
// warpgroup), and writes the bf16 g over the mask it has just read. The
// accumulator layout of one product is the A-fragment layout of the next, so
// each thread reloads its next A from the positions it wrote; one bulk store
// per row sends the slot to gsave, and the slot goes back to the producer once
// the stores have read it, during the next layer's first products.
// Rows past n are zero in g from the start and stay zero.
constexpr int CH_T = 128;
constexpr int CH_THREADS = 384;
constexpr int RING = 4;
constexpr int TILE_K = 64;                        // layer outputs per weight tile (128-byte rows)
constexpr int TILE_BYTES = 128 * TILE_K * 2;      // largest tile: 128 inputs x 64 outputs
constexpr int LDM = H + 8;                        // mask slot row stride (elements)
constexpr int SLOT_ELEMS = 64 * LDM;
constexpr size_t CHAIN_SMEM = 1024 + RING * TILE_BYTES + 4 * SLOT_ELEMS * sizeof(bf16) +
                              16 * 256 * sizeof(uint32_t) + (H + KIN + 4 * H) * sizeof(float) +
                              (2 * RING + 8) * sizeof(uint64_t);

struct ChainMaps {
  CUtensorMap hidden;  // layers 0..L-2 as one [rows, 256] matrix: W_l[k] is row w_offset(l) / 256 + k
  CUtensorMap last;    // layer L-1, [K, 256 + DENS_PAD]
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
// Adds the column sums of a pass to s: v[2j + e] is this thread's partial (its
// two rows) of column c0 + 8j + 2q + e. A reduce-scatter over the warp's 8
// row groups: each exchange halves what a lane holds (16 + 8 + 4 shuffles,
// against 3 per column for a full butterfly), and each lane ends with the
// sums of 4 distinct columns, added with 4 shared atomics.
__device__ __forceinline__ void colsum32_add(float* s, int c0, float (&v)[32], int lane) {
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
  const int base = (b2 ? 16 : 0) + (b3 ? 8 : 0) + (b4 ? 4 : 0);  // v[t] is column index base + t
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int idx = base + t;
    atomicAdd(s + c0 + 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1), v[t]);
  }
}

struct ChainCtx {
  uint32_t ring;         // shared address of the weight ring
  uint64_t* full;
  uint64_t* empty;
  int lane, wq;          // lane, warp in the warpgroup
};

// warp 0 of the warpgroup issued the bulk stores of a mask slot; once they
// have read it, the slot goes back to the producer
__device__ __forceinline__ void release_slot(uint64_t*& pending, const ChainCtx& cx) {
  if (pending == nullptr) return;
  if (cx.wq == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
    if (cx.lane == 0) mbar_arrive(pending);
  }
  pending = nullptr;
}

// acc = g (64 rows, 256-deep, registers) x the next 4 ring tiles (N columns)
template <int N>
__device__ __forceinline__ void chain_mma(float (&acc)[N / 2], const uint32_t (&A)[64], int& t,
                                          const ChainCtx& cx, uint64_t*& pending) {
  fence_operand(acc);
#pragma unroll
  for (int kt = 0; kt < H / TILE_K; ++kt) {
    const int s = t % RING;
    mbar_wait(cx.full + s, (t / RING) & 1);
    const uint32_t b = cx.ring + s * TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE_K / 16; ++kk) {
      if constexpr (N == 128)
        wgmma_m64n128_rs(acc, &A[16 * kt + 4 * kk], desc_sw128(b + 32 * kk), (kt | kk) != 0);
      else
        wgmma_m64n64_rs(acc, &A[16 * kt + 4 * kk], desc_sw128(b + 32 * kk), (kt | kk) != 0);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      mbar_arrive(cx.empty + (t - 1) % RING);
    }
    ++t;
  }
  wgmma_wait<0>();
  mbar_arrive(cx.empty + (t - 1) % RING);
  fence_operand(acc);
  release_slot(pending, cx);  // the previous layer's stores ran during these products
}

__global__ void __launch_bounds__(CH_THREADS, 1)
    trunk_bwd_chain_kernel(const bf16* __restrict__ gfeat, const bf16* __restrict__ gdens,
                           const bf16* __restrict__ feat, const bf16* __restrict__ acts,
                           const bf16* __restrict__ w, const __grid_constant__ ChainMaps maps,
                           bf16* __restrict__ denc, bf16* __restrict__ gsave, float* __restrict__ db,
                           int n, int L, int skip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* slots = reinterpret_cast<bf16*>(base + RING * TILE_BYTES);  // [wg][2][64][LDM]
  uint32_t* genc_s = reinterpret_cast<uint32_t*>(slots + 4 * SLOT_ELEMS);  // [16][256]
  float* wd_s = reinterpret_cast<float*>(genc_s + 16 * 256);           // [H + KIN]
  float* db_s = wd_s + H + KIN;                                          // [wg][2][H]
  uint64_t* full = reinterpret_cast<uint64_t*>(db_s + 4 * H);
  uint64_t* empty = full + RING;
  uint64_t* mfull = empty + RING;  // [wg * 2 + slot]
  uint64_t* mempty = mfull + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long row0 = (long)blockIdx.x * CH_T;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives: no divergent path among the products
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(mfull + i, 1);
      mbar_init(mempty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producers
    // 128 x 56 + 256 x 224 = 384 x 168, the registers the block was launched with;
    // the mask producer spills at 40
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 8 && lane == 0) {
      // weight tiles W_l[c0 .. c0 + rows, 64 kt .. 64 kt + 64] in the order the
      // consumers take them; a 128-row tile is two 64-row boxes one under the other
      int t = 0;
      for (int l = L - 1; l >= 0; --l) {
        const int K = layer_in(l, skip);
        const CUtensorMap* map = l == L - 1 ? &maps.last : &maps.hidden;
        const int row0 = l == L - 1 ? 0 : (int)(w_offset(l, L, skip) / H);
        for (int c0 = 0; c0 < K;) {
          const int rows = K - c0 >= 128 ? 128 : 64;
          for (int kt = 0; kt < H / TILE_K; ++kt, ++t) {
            const int s = t % RING;
            mbar_wait(empty + s, ((t / RING) & 1) ^ 1);
            mbar_expect_tx(full + s, rows * TILE_K * sizeof(bf16));
            for (int h = 0; h < rows / 64; ++h)
              tma_load_2d(ring + s * (TILE_BYTES / 2) + h * 64 * TILE_K, map, kt * TILE_K, row0 + c0 + 64 * h,
                          full + s);
          }
          c0 += rows;
        }
      }
    } else if (warp == 9) {
      // mask tiles: load 0 gfeat, 1 feat, m >= 2 the activation a_{L-m} of layer L+1-m
      for (int m = 0; m <= L; ++m) {
        const int s = m & 1;
        for (int wg = 0; wg < 2; ++wg) {
          const long r0 = row0 + wg * 64;
          const int rows = (int)max(0L, min(64L, (long)n - r0));
          mbar_wait(mempty + wg * 2 + s, ((m >> 1) & 1) ^ 1);
          if (lane == 0) mbar_expect_tx(mfull + wg * 2 + s, rows * H * sizeof(bf16));
          __syncwarp();
          const bf16* src = m == 0 ? gfeat : (m == 1 ? feat : acts + (long)(L - m) * n * H);
          bf16* dst = slots + (wg * 2 + s) * SLOT_ELEMS;
          for (int r = lane; r < rows; r += 32)
            bulk_load(dst + r * LDM, src + (r0 + r) * H, H * sizeof(bf16), mfull + wg * 2 + s);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int wg = warp >> 2, wq = warp & 3;
  const int q = lane & 3;
  const int r_lo = wq * 16 + (lane >> 2), r_hi = r_lo + 8;  // rows of this thread in the WG tile
  const long wrow0 = row0 + wg * 64;
  const int wg_rows = (int)max(0L, min(64L, (long)n - wrow0));
  const bool v_lo = r_lo < wg_rows, v_hi = r_hi < wg_rows;
  const ChainCtx cx{smem_u32(ring), full, empty, lane, wq};
  const float gd_lo = v_lo ? __bfloat162float(gdens[wrow0 + r_lo]) : 0.f;
  const float gd_hi = v_hi ? __bfloat162float(gdens[wrow0 + r_hi]) : 0.f;
  {
    const int K_last = layer_in(L - 1, skip);
    const bf16* w_last = w + w_offset(L - 1, L, skip);
    for (int k = tid; k < K_last; k += 256) wd_s[k] = __bfloat162float(w_last[(long)k * (H + DENS_PAD) + H]);
    for (int i = tid; i < 4 * H; i += 256) db_s[i] = 0.f;
  }
  named_bar(3, 256);

  float* db_w = db_s + wg * 2 * H;  // this warpgroup's column sums, by layer parity
  const int wtid = tid & 127;
  uint64_t* pending = nullptr;  // mask slot still read by its bulk stores
  // the WG's mask slot is stored to gsave rows [wrow0, wrow0 + wg_rows); `release`
  // goes back to the producer when the stores have read it (see release_slot)
  auto store_slot = [&](const bf16* slot, bf16* dst, uint64_t* release) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_bar(1 + wg, 128);
    if (wq == 0) {
      for (int r = lane; r < wg_rows; r += 32) bulk_store(dst + (long)r * H, slot + r * LDM, H * sizeof(bf16));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    pending = release;
  };
  // db of `layer` (the WG's column sums in db_w[layer & 1]) -> global
  auto flush_db = [&](int layer) {
    named_bar(1 + wg, 128);
    float* s = db_w + (layer & 1) * H;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      atomicAdd(db + (long)layer * H + wtid + 128 * i, s[wtid + 128 * i]);
      s[wtid + 128 * i] = 0.f;
    }
  };

  uint32_t A[64];
  // layer L-1: g = [feat > 0 ? gfeat : 0 | gdens] (bf16 exact), saved and summed
  {
    bf16* sg = slots + (wg * 2 + 0) * SLOT_ELEMS;
    const bf16* sf = slots + (wg * 2 + 1) * SLOT_ELEMS;
    mbar_wait(mfull + wg * 2 + 0, 0);
    mbar_wait(mfull + wg * 2 + 1, 0);
    float* dbl = db_w + ((L - 1) & 1) * H;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float cs[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // columns 128 p + 8 j + 2 q: half h of k16 slice s, rows r_lo and r_hi
        const int s = 8 * p + j / 2, h = j % 2, c = 128 * p + 8 * j + 2 * q;
        uint32_t* plo = reinterpret_cast<uint32_t*>(sg + r_lo * LDM + c);
        uint32_t* phi = reinterpret_cast<uint32_t*>(sg + r_hi * LDM + c);
        const uint32_t glo = v_lo ? *plo : 0u, ghi = v_hi ? *phi : 0u;
        const uint32_t flo = v_lo ? *reinterpret_cast<const uint32_t*>(sf + r_lo * LDM + c) : 0u;
        const uint32_t fhi = v_hi ? *reinterpret_cast<const uint32_t*>(sf + r_hi * LDM + c) : 0u;
        const float2 a = unpack_bf16(glo), b = unpack_bf16(ghi);
        A[4 * s + 2 * h] = mask_pack(a.x, a.y, flo);
        A[4 * s + 2 * h + 1] = mask_pack(b.x, b.y, fhi);
        *plo = A[4 * s + 2 * h];
        *phi = A[4 * s + 2 * h + 1];
        const float2 ma = unpack_bf16(A[4 * s + 2 * h]), mb = unpack_bf16(A[4 * s + 2 * h + 1]);
        cs[2 * j] = ma.x + mb.x;
        cs[2 * j + 1] = ma.y + mb.y;
      }
      colsum32_add(dbl, 128 * p, cs, lane);
    }
    float sd = q == 0 ? gd_lo + gd_hi : 0.f;  // each row once
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
    if (lane == 0) atomicAdd(db + (long)(L - 1) * H + H, sd);
    store_slot(sg, gsave + ((long)(L - 1) * n + wrow0) * H, mempty + wg * 2 + 0);
    release_slot(pending, cx);  // at once: this slot takes a_{L-2}, which layer L-1 needs
    if (wq == 0 && lane == 0) mbar_arrive(mempty + wg * 2 + 1);  // feat was read before store_slot's barrier
    flush_db(L - 1);
  }

  int t = 0, m = 2;
  for (int l = L - 1; l >= 0; --l) {
    const bool dens = l == L - 1;
    if (l > 0) {
      // passes over gx[:, 0:128] and gx[:, 128:256], masked by a_{l-1} into g_{l-1}
      bf16* slot = slots + (wg * 2 + (m & 1)) * SLOT_ELEMS;
      float* dbl = db_w + ((l - 1) & 1) * H;
      float acc[64];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        chain_mma<128>(acc, A, t, cx, pending);
        if (p == 0) mbar_wait(mfull + wg * 2 + (m & 1), (m >> 1) & 1);
        float cs[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 128 * p + 8 * j + 2 * q;
          float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
          if (dens) {
            const float w0 = wd_s[c], w1 = wd_s[c + 1];
            v0 += gd_lo * w0;
            v1 += gd_lo * w1;
            v2 += gd_hi * w0;
            v3 += gd_hi * w1;
          }
          uint32_t* plo = reinterpret_cast<uint32_t*>(slot + r_lo * LDM + c);
          uint32_t* phi = reinterpret_cast<uint32_t*>(slot + r_hi * LDM + c);
          const float2 mlo = unpack_bf16(*plo), mhi = unpack_bf16(*phi);
          v0 = mlo.x > 0.f ? v0 : 0.f;
          v1 = mlo.y > 0.f ? v1 : 0.f;
          v2 = mhi.x > 0.f ? v2 : 0.f;
          v3 = mhi.y > 0.f ? v3 : 0.f;
          // accumulator chunk j = 2s + h is half h of the next layer's k16 slice s: the
          // same thread holds the same positions of g as A fragment and as accumulator
          *plo = pack_bf16(v0, v1);
          *phi = pack_bf16(v2, v3);
          cs[2 * j] = v0 + v2;
          cs[2 * j + 1] = v1 + v3;
        }
        colsum32_add(dbl, 128 * p, cs, lane);
      }
      if (layer_in(l, skip) > H) {
        // the skip layer's encoding inputs: bf16 gx kept per thread for layer 0
        float acc2[32];
        chain_mma<64>(acc2, A, t, cx, pending);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc2[4 * j], v1 = acc2[4 * j + 1], v2 = acc2[4 * j + 2], v3 = acc2[4 * j + 3];
          if (dens) {
            const int c = H + 8 * j + 2 * q;
            const float w0 = wd_s[c], w1 = wd_s[c + 1];
            v0 += gd_lo * w0;
            v1 += gd_lo * w1;
            v2 += gd_hi * w0;
            v3 += gd_hi * w1;
          }
          genc_s[(2 * j) * 256 + tid] = pack_bf16(v0, v1);
          genc_s[(2 * j + 1) * 256 + tid] = pack_bf16(v2, v3);
        }
      }
      // the next A fragments: g as this thread just wrote it, k16 slice s, half h
      // (columns 16 s + 8 h + 2 q), rows r_lo / r_hi
#pragma unroll
      for (int s = 0; s < 16; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * s + 8 * h + 2 * q;
          A[4 * s + 2 * h] = *reinterpret_cast<const uint32_t*>(slot + r_lo * LDM + c);
          A[4 * s + 2 * h + 1] = *reinterpret_cast<const uint32_t*>(slot + r_hi * LDM + c);
        }
      store_slot(slot, gsave + ((long)(l - 1) * n + wrow0) * H, mempty + wg * 2 + (m & 1));
      ++m;
      flush_db(l - 1);
    } else {
      // layer 0: denc = bf16(gx) + bf16(the skip layer's encoding part), in bf16
      float acc2[32];
      chain_mma<64>(acc2, A, t, cx, pending);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 elo = unpack_bf16(genc_s[(2 * j) * 256 + tid]);
        const float2 ehi = unpack_bf16(genc_s[(2 * j + 1) * 256 + tid]);
        const float2 dlo = unpack_bf16(pack_bf16(acc2[4 * j], acc2[4 * j + 1]));
        const float2 dhi = unpack_bf16(pack_bf16(acc2[4 * j + 2], acc2[4 * j + 3]));
        if (v_lo)
          *reinterpret_cast<uint32_t*>(denc + (wrow0 + r_lo) * KIN + c) = pack_bf16(dlo.x + elo.x, dlo.y + elo.y);
        if (v_hi)
          *reinterpret_cast<uint32_t*>(denc + (wrow0 + r_hi) * KIN + c) = pack_bf16(dhi.x + ehi.x, dhi.y + ehi.y);
      }
    }
  }
  if (wq == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // gsave written
}

// ------------------------------------------------------------------------ dW

// dW_l = inp_l^T g_l over the points, inp_l the layer input (enc, a stored
// activation, or both for the skip layer) and g_l the chain kernel's gsave.
// A block takes one tile of dW_l, 128 input features (64 for layer 0 and the
// skip layer's encoding part) x all 256 outputs, over one slice of the points:
// two consumer warpgroups each run wgmma m64n256k16 with both operands in
// shared memory, MN-major (the point index is the reduction and neither
// operand has it contiguous: the descriptors' transpose bits), f32
// accumulators in registers (128 per thread). A producer warp feeds a
// DW_STAGES-stage ring of 64-point chunks by TMA (inp [64 points x 64
// features] per warpgroup, g [64 points x 256] as four 64-column boxes, all
// with the 128-byte swizzle; points past n arrive as zeros). Tiles run
// fastest in the grid, so the blocks of one point slice read g_l together
// and L2 serves the second read. The last layer's tiles also take its density
// column, dW[k, 256] = sum_p inp[p, k] g_dens[p], from the same A chunks.
// Each block adds its partial tile with f32 atomics.
constexpr int DW_PTS = 64;
constexpr int DW_STAGES = 4;
constexpr int DW_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int DW_A_BYTES = DW_PTS * 64 * 2;
constexpr int DW_B_BYTES = DW_PTS * H * 2;
constexpr int DW_STAGE = 2 * DW_A_BYTES + DW_B_BYTES + 1024;  // + g_dens chunk, 1024-aligned stages
constexpr size_t DW_SMEM = 1024 + DW_STAGES * DW_STAGE + 2 * DW_STAGES * sizeof(uint64_t);

__device__ __forceinline__ void wgmma_m64n256_ss_t(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
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
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
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

struct DwMaps {
  CUtensorMap acts;  // [L-1][n][256] bf16, box 64 x 64 points, 128-byte swizzle
  CUtensorMap enc;   // [1][n][64]
  CUtensorMap g;     // [L][n][256] (gsave)
  CUtensorMap gd;    // [n] g_dens, box 64 points, no swizzle
};

// (layer, first input feature, rows) of tile `tile` of the dW grid
__host__ __device__ __forceinline__ int dw_tiles_of(int K) { return (K + 127) / 128; }
__device__ __forceinline__ void dw_tile(int tile, int L, int skip, int& l, int& k0, int& rows) {
  for (l = 0; l < L; ++l) {
    const int K = layer_in(l, skip), nt = dw_tiles_of(K);
    if (tile < nt) break;
    tile -= nt;
  }
  k0 = tile * 128;
  rows = min(128, layer_in(l, skip) - k0);
}

__global__ void __launch_bounds__(DW_THREADS, 1)
    trunk_bwd_dw_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ dw, int n, int L, int skip,
                        int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DW_STAGES * DW_STAGE);
  uint64_t* empty = full + DW_STAGES;

  int l, k0, rows;
  dw_tile(blockIdx.x, L, skip, l, k0, rows);
  const int NO = layer_out(l, L);
  const bool dens = l == L - 1;
  const long p_begin = (long)blockIdx.y * rows_per_split;
  const long p_end = min((long)n, p_begin + rows_per_split);
  const int nch = p_end > p_begin ? (int)((p_end - p_begin + DW_PTS - 1) / DW_PTS) : 0;
  if (nch == 0) return;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer
    if (lane == 0) {
      const uint32_t bytes = (rows / 64) * DW_A_BYTES + DW_B_BYTES + (dens ? DW_PTS * 2 : 0);
      for (int c = 0; c < nch; ++c) {
        const int s = c % DW_STAGES;
        unsigned char* st = base + s * DW_STAGE;
        const int p = (int)(p_begin + (long)c * DW_PTS);
        mbar_wait(empty + s, ((c / DW_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, bytes);
        for (int h = 0; h < rows / 64; ++h) {
          const int k = k0 + 64 * h;
          if (l == 0 || k >= H)
            tma_load(st + h * DW_A_BYTES, &maps.enc, k - (l == 0 ? 0 : H), p, 0, full + s);
          else
            tma_load(st + h * DW_A_BYTES, &maps.acts, k, p, l - 1, full + s);
        }
        for (int i = 0; i < H / 64; ++i)
          tma_load(st + 2 * DW_A_BYTES + i * (DW_B_BYTES / 4), &maps.g, 64 * i, p, l, full + s);
        if (dens) tma_load_1d(st + 2 * DW_A_BYTES + DW_B_BYTES, &maps.gd, p, full + s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns input features k0 + 64 wg .. A warpgroup past
  // a 64-row tile's end multiplies whatever its A slot holds and drops the
  // result: no branch around the products, which ptxas would serialize.
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  float acc[128];
  float sd = 0.f;  // density column: feature wtid % 64, points (wtid / 64) * 32.. of each chunk
  auto products = [&](int c) {
    const int s = c % DW_STAGES;
    mbar_wait(full + s, (c / DW_STAGES) & 1);
    unsigned char* st = base + s * DW_STAGE;
    const uint32_t a = smem_u32(st + wg * DW_A_BYTES), b = smem_u32(st + 2 * DW_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_PTS / 16; ++kk)
      wgmma_m64n256_ss_t(acc, desc_mn_sw128(a + 2048 * kk, DW_A_BYTES),
                         desc_mn_sw128(b + 2048 * kk, DW_B_BYTES / 4), (c | kk) != 0);
    wgmma_commit();
  };
  auto density = [&](int c) {
    const unsigned char* st = base + (c % DW_STAGES) * DW_STAGE;
    const bf16* as = reinterpret_cast<const bf16*>(st + wg * DW_A_BYTES);
    const bf16* gds = reinterpret_cast<const bf16*>(st + 2 * DW_A_BYTES + DW_B_BYTES);
    const int k = wtid % 64;
#pragma unroll 8
    for (int i = 0; i < DW_PTS / 2; ++i) {
      const int p = (wtid / 64) * (DW_PTS / 2) + i;
      sd += __bfloat162float(as[p * 64 + (((k >> 3) ^ (p & 7)) << 3) + (k & 7)]) * __bfloat162float(gds[p]);
    }
  };
  fence_operand(acc);
  products(0);
  for (int c = 1; c < nch; ++c) {
    products(c);
    wgmma_wait<1>();  // chunk c - 1 is read
    if (dens) density(c - 1);
    mbar_arrive(empty + (c - 1) % DW_STAGES);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (dens) density(nch - 1);
  mbar_arrive(empty + (nch - 1) % DW_STAGES);
  if (64 * wg >= rows) return;

  float* dwl = dw + w_offset(l, L, skip) + (long)(k0 + 64 * wg) * NO;
  const int r_lo = wq * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * q;
    atomicAdd(dwl + (long)r_lo * NO + col, acc[4 * j]);
    atomicAdd(dwl + (long)r_lo * NO + col + 1, acc[4 * j + 1]);
    atomicAdd(dwl + (long)(r_lo + 8) * NO + col, acc[4 * j + 2]);
    atomicAdd(dwl + (long)(r_lo + 8) * NO + col + 1, acc[4 * j + 3]);
  }
  if (dens) atomicAdd(dwl + (long)(wtid % 64) * NO + H, sd);
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

}  // namespace

// ------------------------------------------------------------------ C interface
// Each function launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int trunk_fwd(const void* enc, const void* w, const void* b, void* feat, void* dens, void* acts,
              int n, int L, int skip, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(trunk_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = (n + T - 1) / T;
  trunk_fwd_kernel<<<blocks, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)enc, (const bf16*)w, (const bf16*)b, (bf16*)feat, (float*)dens, (bf16*)acts,
      n, L, skip);
  return cudaGetLastError();
}

int trunk_bwd_chain(const void* gfeat, const void* gdens, const void* feat, const void* acts,
                    const void* w, void* denc, void* gsave, void* db, int n, int L, int skip, void* stream) {
  static EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  ChainMaps maps;
  const long last = w_offset(L - 1, L, skip);
  int err = make_map(encode, &maps.hidden, w, 2, {(cuuint64_t)H, (cuuint64_t)(last / H), 1}, {TILE_K, 64, 1}, true);
  if (!err)
    err = make_map(encode, &maps.last, (const bf16*)w + last, 2,
                   {(cuuint64_t)(H + DENS_PAD), (cuuint64_t)layer_in(L - 1, skip), 1}, {TILE_K, 64, 1}, true);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)CHAIN_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + CH_T - 1) / CH_T;
  trunk_bwd_chain_kernel<<<blocks, CH_THREADS, CHAIN_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)gfeat, (const bf16*)gdens, (const bf16*)feat, (const bf16*)acts, (const bf16*)w, maps,
      (bf16*)denc, (bf16*)gsave, (float*)db, n, L, skip);
  return (int)cudaGetLastError();
}

int trunk_bwd_dw(const void* enc, const void* acts, const void* gsave, const void* gdens, void* dw, int n,
                 int L, int skip, void* stream) {
  static EncodeTiled encode = encode_tiled();
  static int sms = 0;
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  DwMaps maps;
  const cuuint64_t N = (cuuint64_t)n;
  int err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)H, N, (cuuint64_t)(L - 1)}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.enc, enc, 3, {(cuuint64_t)KIN, N, 1}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.g, gsave, 3, {(cuuint64_t)H, N, (cuuint64_t)L}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.gd, gdens, 1, {N, 1, 1}, {DW_PTS, 1, 1}, false);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)DW_SMEM);
  if (e != cudaSuccess) return (int)e;
  // about two waves of one block per SM, every slice a whole number of chunks
  int tiles = 0;
  for (int l = 0; l < L; ++l) tiles += dw_tiles_of(layer_in(l, skip));
  const int chunks = (n + DW_PTS - 1) / DW_PTS;
  const int splits = std::max(1, std::min(2 * sms / tiles, chunks));
  const int rows_per_split = (chunks + splits - 1) / splits * DW_PTS;
  trunk_bwd_dw_kernel<<<dim3(tiles, splits), DW_THREADS, DW_SMEM, (cudaStream_t)stream>>>(
      maps, (float*)dw, n, L, skip, rows_per_split);
  return (int)cudaGetLastError();
}

}  // extern "C"
