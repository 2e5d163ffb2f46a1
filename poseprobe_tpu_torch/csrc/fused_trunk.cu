// Fused scene-NeRF trunk for Hopper (sm_90a): forward, backward chain, dW,
// and the remat of the backward at an activation-checkpoint stride other than 1.
//
// Replaces the Pallas TPU kernels `_trunk_fwd_call` and `_trunk_bwd_call` of
// poseprobe_tpu/ops/pallas/fused_mlp.py. The Python side
// (poseprobe_tpu_torch/ops/fused_mlp.py) packs the weights, holds the plain
// PyTorch twin these kernels are tested against, and explains the design.
//
// Every kernel is a template on the trunk width H (128 or 256: wgmma's
// m64n128 / m64n256) and the encoding's padded width KIN (64 or 128: one or
// two 64-column boxes wherever the encoding is read); the launch functions
// take H and KIN and run the instantiation. H = 256 with KIN = 64 is the 8x256
// main path. The backward chain runs here at H = 256 only: at H = 128 it is
// trunk_narrow.cu's. Wider trunks go to trunk_wide.cu.
//
// Packed layout (all row-major, bf16): layer l is a [K_l, NO_l] block of `w`,
// K_l = KIN (l = 0), H + KIN (l = skip), H otherwise; NO_l = H, or H + 128 for
// the last layer whose columns are [feat(H) | density | 0...]. Biases are
// consecutive [NO_l] slices of `b`. Activations and the stored hidden layers
// are [N, H]; enc and denc are [N, KIN].
//
// All three kernels issue warpgroup wgmma (bf16 in, f32 accumulate) on tiles
// that TMA or bulk copies bring into shared memory through mbarrier rings,
// with a producer warp ahead of two consumer warpgroups of 64 points each.
// The forward and the backward chain read their weight tiles by TMA straight
// from the packed `w` through the same two tensor maps; the forward takes its
// activations as wgmma's A operand from registers (the accumulator layout of
// one layer is the A layout of the next) and sends them out by TMA stores;
// dW takes both operands from shared memory. Each has its own section below.
//
// Checkpoint strides (the reference's `ckpt`, `_stored_layers`): stride 1
// stores every hidden layer a_0 .. a_{L-2} as [L-1, N, H], 0 none, k >= 2 the
// layers k-1, 2k-1, ... as [n_stored, N, H] (layer l in slot l / k). Stride 1
// and "none" run trunk_fwd_kernel; k >= 2 runs trunk_fwd_ckpt_kernel, the
// same body storing only those layers. At a stride other than 1 the backward
// first runs trunk_remat_kernel, the same body again over layers 0 .. L-2: a
// stored layer is loaded and copied, the others recomputed, into a transient
// [L-1, N, H] that the chain and dW kernels read as they read the stored
// layers at stride 1 (see the forward's section).

#include <algorithm>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------ backward chain

// Backward chain at H = 256 (trunk_narrow.cu has H = 128's): one block per
// CH_T = 128 points, two consumer warpgroups of 64 points each and one
// producer warpgroup (warp 8 streams weight tiles, warp 9 the per-layer mask
// tiles; warps 10-11 leave at once).
//
// Layer l (from L-1 down) computes gx = g_l W_l^T over its K_l inputs in
// passes of 128 columns (KIN for the encoding part of the skip layer and for
// layer 0) with wgmma m64nNk16, A = g_l in registers (H / 4 x 32-bit per
// thread for the H-wide reduction), B = weight tiles [N inputs x 64 outputs] from a
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
// Rows past n are zero in g from the start and stay zero. KIN = 128 runs a
// 3-stage ring, KIN = 64 4: the wider encoding gradient (genc_s) takes the
// 16 KB of the fourth stage within the 227 KB a block may have.
constexpr int CH_T = 128;
constexpr int CH_THREADS = 384;
constexpr int TILE_K = 64;                        // layer outputs per weight tile (128-byte rows)
constexpr int TILE_BYTES = 128 * TILE_K * 2;      // largest tile: 128 inputs x 64 outputs
template <int H, int KIN>
struct Chain {
  static constexpr int RING = KIN == 128 ? 3 : 4;
  static constexpr int LDM = H + 8;               // mask slot row stride (elements)
  static constexpr int SLOT_ELEMS = 64 * LDM;
  static constexpr size_t SMEM = 1024 + RING * TILE_BYTES + 4 * SLOT_ELEMS * sizeof(bf16) +
                                 KIN / 4 * 256 * sizeof(uint32_t) + (H + KIN + 4 * H) * sizeof(float) +
                                 (2 * RING + 8) * sizeof(uint64_t);
};

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

// acc = g (64 rows, H-deep, registers) x the next H / 64 ring tiles (N columns)
template <int H, int RING, int N>
__device__ __forceinline__ void chain_mma(float (&acc)[N / 2], const uint32_t (&A)[H / 4], int& t,
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

template <int H, int KIN>
__global__ void __launch_bounds__(CH_THREADS, 1)
    trunk_bwd_chain_kernel(const bf16* __restrict__ gfeat, const bf16* __restrict__ gdens,
                           const bf16* __restrict__ feat, const bf16* __restrict__ acts,
                           const bf16* __restrict__ w, const __grid_constant__ WeightMaps maps,
                           bf16* __restrict__ denc, bf16* __restrict__ gsave, float* __restrict__ db,
                           int n, int L, int skip) {
  constexpr int RING = Chain<H, KIN>::RING, LDM = Chain<H, KIN>::LDM, SLOT_ELEMS = Chain<H, KIN>::SLOT_ELEMS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* slots = reinterpret_cast<bf16*>(base + RING * TILE_BYTES);  // [wg][2][64][LDM]
  uint32_t* genc_s = reinterpret_cast<uint32_t*>(slots + 4 * SLOT_ELEMS);  // [KIN / 4][256]
  float* wd_s = reinterpret_cast<float*>(genc_s + KIN / 4 * 256);      // [H + KIN]
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
        const int K = layer_in(l, skip, H, KIN);
        const CUtensorMap* map = l == L - 1 ? &maps.last : &maps.hidden;
        const int row0 = l == L - 1 ? 0 : (int)(w_offset(l, L, skip, H, KIN) / H);
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
    const int K_last = layer_in(L - 1, skip, H, KIN);
    const bf16* w_last = w + w_offset(L - 1, L, skip, H, KIN);
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
    for (int i = 0; i < H / 128; ++i) {
      atomicAdd(db + (long)layer * H + wtid + 128 * i, s[wtid + 128 * i]);
      s[wtid + 128 * i] = 0.f;
    }
  };

  uint32_t A[H / 4];
  // layer L-1: g = [feat > 0 ? gfeat : 0 | gdens] (bf16 exact), saved and summed
  {
    bf16* sg = slots + (wg * 2 + 0) * SLOT_ELEMS;
    const bf16* sf = slots + (wg * 2 + 1) * SLOT_ELEMS;
    mbar_wait(mfull + wg * 2 + 0, 0);
    mbar_wait(mfull + wg * 2 + 1, 0);
    float* dbl = db_w + ((L - 1) & 1) * H;
#pragma unroll
    for (int p = 0; p < H / 128; ++p) {
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
      // passes over gx[:, 128 p:128 p + 128], masked by a_{l-1} into g_{l-1}
      bf16* slot = slots + (wg * 2 + (m & 1)) * SLOT_ELEMS;
      float* dbl = db_w + ((l - 1) & 1) * H;
      float acc[64];
#pragma unroll
      for (int p = 0; p < H / 128; ++p) {
        chain_mma<H, RING, 128>(acc, A, t, cx, pending);
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
      if (layer_in(l, skip, H, KIN) > H) {
        // the skip layer's encoding inputs: bf16 gx kept per thread for layer 0
        float acc2[KIN / 2];
        chain_mma<H, RING, KIN>(acc2, A, t, cx, pending);
#pragma unroll
        for (int j = 0; j < KIN / 8; ++j) {
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
      for (int s = 0; s < H / 16; ++s)
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
      float acc2[KIN / 2];
      chain_mma<H, RING, KIN>(acc2, A, t, cx, pending);
#pragma unroll
      for (int j = 0; j < KIN / 8; ++j) {
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
// A block takes one tile of dW_l, 128 input features (64 for the encoding
// part when KIN = 64) x all H outputs, over one slice of the points: two
// consumer warpgroups each run wgmma m64nHk16 with both operands in shared
// memory, MN-major (the point index is the reduction and neither operand has
// it contiguous: the descriptors' transpose bits), f32 accumulators in
// registers (H / 2 per thread). A producer warp feeds a DW_STAGES-stage ring
// of 64-point chunks by TMA (inp [64 points x 64 features] per warpgroup, g
// [64 points x H] as H / 64 64-column boxes, all with the 128-byte swizzle;
// points past n arrive as zeros). Tiles run fastest in the grid, so the
// blocks of one point slice read g_l together and L2 serves the second read.
// The last layer's tiles also take its density column, dW[k, H] = sum_p
// inp[p, k] g_dens[p], from the same A chunks. Each block adds its partial
// tile with f32 atomics.
constexpr int DW_PTS = 64;
constexpr int DW_STAGES = 4;
constexpr int DW_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int DW_A_BYTES = DW_PTS * 64 * 2;  // one [64 points x 64] box
template <int H>
struct Dw {
  static constexpr int B_BYTES = DW_PTS * H * 2;
  static constexpr int STAGE = 2 * DW_A_BYTES + B_BYTES + 1024;  // + g_dens chunk, 1024-aligned stages
  static constexpr size_t SMEM = 1024 + DW_STAGES * STAGE + 2 * DW_STAGES * sizeof(uint64_t);
};

struct DwMaps {
  CUtensorMap acts;  // [L-1][n][H] bf16, box 64 x 64 points, 128-byte swizzle
  CUtensorMap enc;   // [1][n][KIN]
  CUtensorMap g;     // [L][n][H] (gsave)
  CUtensorMap gd;    // [n] g_dens, box 64 points, no swizzle
};

// (layer, first input feature, rows) of tile `tile` of the dW grid
__host__ __device__ __forceinline__ int dw_tiles_of(int K) { return (K + 127) / 128; }
template <int H, int KIN>
__device__ __forceinline__ void dw_tile(int tile, int L, int skip, int& l, int& k0, int& rows) {
  for (l = 0; l < L; ++l) {
    const int K = layer_in(l, skip, H, KIN), nt = dw_tiles_of(K);
    if (tile < nt) break;
    tile -= nt;
  }
  k0 = tile * 128;
  rows = min(128, layer_in(l, skip, H, KIN) - k0);
}

template <int H, int KIN>
__global__ void __launch_bounds__(DW_THREADS, 1)
    trunk_bwd_dw_kernel(const __grid_constant__ DwMaps maps, float* __restrict__ dw, int n, int L, int skip,
                        int rows_per_split) {
  constexpr int DW_B_BYTES = Dw<H>::B_BYTES, DW_STAGE = Dw<H>::STAGE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DW_STAGES * DW_STAGE);
  uint64_t* empty = full + DW_STAGES;

  int l, k0, rows;
  dw_tile<H, KIN>(blockIdx.x, L, skip, l, k0, rows);
  const int NO = layer_out(l, L, H);
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
          tma_load(st + 2 * DW_A_BYTES + i * DW_A_BYTES, &maps.g, 64 * i, p, l, full + s);
        if (dens) tma_load_1d(st + 2 * DW_A_BYTES + DW_B_BYTES, &maps.gd, p, full + s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns input features k0 + 64 wg .. A warpgroup past
  // a 64-row tile's end multiplies whatever its A slot holds and drops the
  // result: no branch around the products, which ptxas would serialize.
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  float acc[H / 2];
  float sd = 0.f;  // density column: feature wtid % 64, points (wtid / 64) * 32.. of each chunk
  auto products = [&](int c) {
    const int s = c % DW_STAGES;
    mbar_wait(full + s, (c / DW_STAGES) & 1);
    unsigned char* st = base + s * DW_STAGE;
    const uint32_t a = smem_u32(st + wg * DW_A_BYTES), b = smem_u32(st + 2 * DW_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_PTS / 16; ++kk) {
      // the g boxes lie DW_A_BYTES apart (one 64-column box of 64 points each)
      if constexpr (H == 256)
        wgmma_m64n256_ss<1, 1>(acc, desc_mn_sw128(a + 2048 * kk, DW_A_BYTES),
                               desc_mn_sw128(b + 2048 * kk, DW_A_BYTES), (c | kk) != 0);
      else
        wgmma_m64n128_ss<1, 1>(acc, desc_mn_sw128(a + 2048 * kk, DW_A_BYTES),
                               desc_mn_sw128(b + 2048 * kk, DW_A_BYTES), (c | kk) != 0);
    }
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

  float* dwl = dw + w_offset(l, L, skip, H, KIN) + (long)(k0 + 64 * wg) * NO;
  const int r_lo = wq * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const int col = 8 * j + 2 * q;
    atomicAdd(dwl + (long)r_lo * NO + col, acc[4 * j]);
    atomicAdd(dwl + (long)r_lo * NO + col + 1, acc[4 * j + 1]);
    atomicAdd(dwl + (long)(r_lo + 8) * NO + col, acc[4 * j + 2]);
    atomicAdd(dwl + (long)(r_lo + 8) * NO + col + 1, acc[4 * j + 3]);
  }
  if (dens) atomicAdd(dwl + (long)(wtid % 64) * NO + H, sd);
}

// ------------------------------------------------------------------- forward

// Forward: one block per FW_T = 128 points, two consumer warpgroups of 64
// points each and one producer warp (warp 8; warps 9-11 leave at once).
//
// Layer l computes relu(a_{l-1} W_l + b_l) for its H feature columns with
// wgmma m64nHk16 (f32 accumulators, H / 2 per thread), in k64 steps: B is a
// [64 inputs x H outputs] stage of a FW_RING-stage ring that the producer
// fills by TMA from the packed weights, H / 64 64 x 64 boxes of the chain's
// two tensor maps (a row of a packed layer is N-contiguous for a W: the
// descriptors' transpose bit, 8 KB between the 64-column boxes). The producer
// walks the layers without a break, so every layer's first stages are in
// flight while the previous one finishes. A is the activation in registers
// (H / 4 x 32 bits per thread): the epilogue adds the bias in f32, applies ReLU
// and packs to bf16 straight into the next layer's A. Layer 0 and the skip
// layer's encoding rows take A from the encoding tile (KIN / 64 boxes) that
// TMA brought into shared memory (rows past n as zeros). The same epilogue writes the bf16
// tile into a swizzled staging tile, and one thread sends it to acts[l] (or
// feat) by TMA stores, which clip rows past n; they read the staging tile
// while the next layer's products run and are waited for before the next
// epilogue writes it again. The density column is an H-wide dot of the last
// layer's A (and of the encoding, when the skip layer is the last) with
// W_last[:, H] in the epilogue: no product pass for one column.
constexpr int FW_T = 128;
constexpr int FW_THREADS = 384;
constexpr int FW_RING = 4;
constexpr int FW_BOX = 64 * 64 * 2;       // one 64 x 64 bf16 box
template <int H, int KIN>
struct Fwd {
  static constexpr int STAGE = H / 64 * FW_BOX;  // 64 inputs x H outputs
  static constexpr int TILE = H / 64 * FW_BOX;   // a warpgroup's [64 points x H] staging tile
  static constexpr int ENC = KIN / 64 * FW_BOX;  // a warpgroup's [64 points x KIN] encoding tile
  static constexpr size_t SMEM = 1024 + FW_RING * STAGE + 2 * TILE + 2 * ENC + (H + KIN) * sizeof(float) +
                                 (2 * FW_RING + 1) * sizeof(uint64_t);
};

struct FwdMaps {
  WeightMaps w;
  CUtensorMap enc;   // [n, KIN], box 64 x 64, 128-byte swizzle (loads; rows past n read as zeros)
  CUtensorMap feat;  // [n, H], box 64 x 64 (stores; rows past n are clipped)
  CUtensorMap acts;  // [L-1, n, H], box 64 x 64 x 1; not encoded without stored activations
};

struct FwdRing {
  uint32_t ring;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
};

// acc (+)= A (registers, 64 rows x H) x the next H / 64 ring stages
template <int H>
__device__ __forceinline__ void fwd_mma_regs(float (&acc)[H / 2], const uint32_t (&A)[H / 4], int& t,
                                             const FwdRing& r) {
  fence_operand(acc);
#pragma unroll
  for (int kt = 0; kt < H / 64; ++kt) {
    const int s = t % FW_RING;
    mbar_wait(r.full + s, (t / FW_RING) & 1);
    const uint32_t b = r.ring + s * (H / 64 * FW_BOX);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (H == 256)
        wgmma_m64n256_rs_t(acc, &A[16 * kt + 4 * kk], desc_mn_sw128(b + 2048 * kk, FW_BOX), (kt | kk) != 0);
      else
        wgmma_m64n128_rs_t(acc, &A[16 * kt + 4 * kk], desc_mn_sw128(b + 2048 * kk, FW_BOX), (kt | kk) != 0);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      mbar_arrive(r.empty + (t - 1) % FW_RING);
    }
    ++t;
  }
  wgmma_wait<0>();
  mbar_arrive(r.empty + (t - 1) % FW_RING);
  fence_operand(acc);
}

// acc (+)= one 64-column box of the encoding tile (shared, [64 x 64],
// K-major) x the next ring stage; accumulate 0 starts the sum
template <int H>
__device__ __forceinline__ void fwd_mma_enc(float (&acc)[H / 2], uint32_t enc, int accumulate, int& t,
                                            const FwdRing& r) {
  fence_operand(acc);
  const int s = t % FW_RING;
  mbar_wait(r.full + s, (t / FW_RING) & 1);
  const uint32_t b = r.ring + s * (H / 64 * FW_BOX);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (H == 256)
      wgmma_m64n256_ss<0, 1>(acc, desc_sw128(enc + 32 * kk), desc_mn_sw128(b + 2048 * kk, FW_BOX),
                             accumulate | (kk != 0));
    else
      wgmma_m64n128_ss<0, 1>(acc, desc_sw128(enc + 32 * kk), desc_mn_sw128(b + 2048 * kk, FW_BOX),
                             accumulate | (kk != 0));
  }
  wgmma_commit();
  wgmma_wait<0>();
  mbar_arrive(r.empty + s);
  ++t;
  fence_operand(acc);
}

// byte offset of element (r, c) in a [64 x H] staging tile of H / 64 64 x 64
// boxes with the 128-byte swizzle, the layout in which TMA moves a 64 x 64
// box (for c < KIN also the offset in the encoding tile)
__device__ __forceinline__ uint32_t stage_offset(int r, int c) {
  return (c >> 6) * FW_BOX + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

template <int H, int KIN>
__global__ void __launch_bounds__(FW_THREADS, 1)
    trunk_fwd_kernel(const __grid_constant__ FwdMaps maps, const bf16* __restrict__ w, const bf16* __restrict__ b,
                     float* __restrict__ dens, int n, int L, int skip, int store_acts) {
  constexpr int FW_STAGE = Fwd<H, KIN>::STAGE, FW_TILE = Fwd<H, KIN>::TILE, FW_ENC = Fwd<H, KIN>::ENC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* stg = ring + FW_RING * FW_STAGE;  // [wg] staging tiles
  unsigned char* enc_s = stg + 2 * FW_TILE;        // [wg] encoding tiles
  float* wd_s = reinterpret_cast<float*>(enc_s + 2 * FW_ENC);  // W_last[:, H]
  uint64_t* full = reinterpret_cast<uint64_t*>(wd_s + H + KIN);
  uint64_t* empty = full + FW_RING;
  uint64_t* efull = empty + FW_RING;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long row0 = (long)blockIdx.x * FW_T;
  if (tid == 0) {
    for (int s = 0; s < FW_RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives
    }
    mbar_init(efull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    // 128 x 40 + 256 x 232 = 384 x 168, the registers the block was launched with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      const int tiles = n - row0 > 64 ? 2 : 1;  // the second warpgroup's tile only if it has rows
      mbar_expect_tx(efull, tiles * FW_ENC);
      for (int h = 0; h < tiles; ++h)
        for (int kb = 0; kb < KIN / 64; ++kb)
          tma_load_2d(enc_s + h * FW_ENC + kb * FW_BOX, &maps.enc, 64 * kb, (int)row0 + 64 * h, efull);
      // stage t: rows y .. y + 64 of a layer, its H / 64 64-column boxes
      int t = 0, y0 = 0;
      for (int l = 0; l < L; ++l) {
        const int K = layer_in(l, skip, H, KIN);
        const bool last = l == L - 1;
        for (int k0 = 0; k0 < K; k0 += 64, ++t) {
          const int s = t % FW_RING;
          mbar_wait(empty + s, ((t / FW_RING) & 1) ^ 1);
          mbar_expect_tx(full + s, FW_STAGE);
          for (int i = 0; i < H / 64; ++i)
            tma_load_2d(ring + s * FW_STAGE + i * FW_BOX, last ? &maps.w.last : &maps.w.hidden, 64 * i,
                        (last ? 0 : y0) + k0, full + s);
        }
        y0 += K;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  const int q = lane & 3, g = lane >> 2;
  const int r_lo = wq * 16 + g, r_hi = r_lo + 8;  // rows of this thread in the WG tile
  const long wrow0 = row0 + wg * 64;
  const int wg_rows = (int)max(0L, min(64L, (long)n - wrow0));
  {
    const int K_last = layer_in(L - 1, skip, H, KIN);
    const bf16* w_last = w + w_offset(L - 1, L, skip, H, KIN);
    for (int k = tid; k < K_last; k += 256) wd_s[k] = __bfloat162float(w_last[(long)k * (H + DENS_PAD) + H]);
  }
  named_bar(3, 256);

  const FwdRing rg{smem_u32(ring), full, empty};
  const uint32_t enc_u = smem_u32(enc_s + wg * FW_ENC);
  unsigned char* tile = stg + wg * FW_TILE;
  mbar_wait(efull, 0);

  uint32_t A[H / 4];
  float acc[H / 2];
  int t = 0;
  for (int l = 0; l < L; ++l) {
    if (l == 0) {
#pragma unroll
      for (int kb = 0; kb < KIN / 64; ++kb) fwd_mma_enc<H>(acc, enc_u + kb * FW_BOX, kb != 0, t, rg);
    } else {
      fwd_mma_regs<H>(acc, A, t, rg);
      if (l == skip) {
#pragma unroll
        for (int kb = 0; kb < KIN / 64; ++kb) fwd_mma_enc<H>(acc, enc_u + kb * FW_BOX, 1, t, rg);
      }
    }
    const bool last = l == L - 1;
    if (last) {
      // density: the last layer's input (A, and the encoding if it is the skip layer) . W_last[:, H]
      float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 lo = unpack_bf16(A[2 * j]), hi = unpack_bf16(A[2 * j + 1]);
        d_lo += lo.x * wd_s[c] + lo.y * wd_s[c + 1];
        d_hi += hi.x * wd_s[c] + hi.y * wd_s[c + 1];
      }
      if (skip == L - 1) {
        const unsigned char* e = enc_s + wg * FW_ENC;
#pragma unroll
        for (int j = 0; j < KIN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(e + stage_offset(r_lo, c)));
          const float2 hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(e + stage_offset(r_hi, c)));
          d_lo += lo.x * wd_s[H + c] + lo.y * wd_s[H + c + 1];
          d_hi += hi.x * wd_s[H + c] + hi.y * wd_s[H + c + 1];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
      }
      const float bd = __bfloat162float(b[(long)(L - 1) * H + H]);
      if (q == 0 && r_lo < wg_rows) dens[wrow0 + r_lo] = d_lo + bd;
      if (q == 0 && r_hi < wg_rows) dens[wrow0 + r_hi] = d_hi + bd;
    }

    // bias + ReLU + bf16 -> the next layer's A, and into the staging tile for acts[l] / feat
    const bool store = (last || store_acts) && wg_rows > 0;
    if (store) {
      if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the last stores read it
      named_bar(1 + wg, 128);
    }
    const __nv_bfloat162* bl = reinterpret_cast<const __nv_bfloat162*>(b + (long)l * H);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 bb = __bfloat1622float2(bl[c >> 1]);
      A[2 * j] = pack_bf16(fmaxf(acc[4 * j] + bb.x, 0.f), fmaxf(acc[4 * j + 1] + bb.y, 0.f));
      A[2 * j + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bb.x, 0.f), fmaxf(acc[4 * j + 3] + bb.y, 0.f));
      if (store) {
        *reinterpret_cast<uint32_t*>(tile + stage_offset(r_lo, c)) = A[2 * j];
        *reinterpret_cast<uint32_t*>(tile + stage_offset(r_hi, c)) = A[2 * j + 1];
      }
    }
    if (store) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(1 + wg, 128);
      if (wtid == 0) {
        for (int i = 0; i < H / 64; ++i) {
          if (last)
            tma_store_2d(&maps.feat, 64 * i, (int)wrow0, tile + i * FW_BOX);
          else
            tma_store_3d(&maps.acts, 64 * i, (int)wrow0, l, tile + i * FW_BOX);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // feat and acts written
}

// The kernels of the checkpoint strides other than 1 share `fwd_body<MODE>`,
// trunk_fwd_kernel's body with these changes (trunk_fwd_kernel, which runs
// stride 1 and the forward that stores nothing, keeps a text of its own:
// written as a third mode of this body it compiled to other machine code):
// * FWD_CKPT (trunk_fwd_ckpt_kernel, stride k >= 2): every layer, feat and
//   the density; a_l into acts[l / k] for the stored layers l = k-1, 2k-1,
//   ... < L-1 only;
// * REMAT (trunk_remat_kernel, the backward at a stride other than 1): layers
//   0 .. L-2 into the full [L-1, n, H] buffer. A stored layer is loaded, not
//   computed: its tile comes by TMA from the forward's [n_stored, n, H] into
//   the staging tile, becomes the next layer's A there (the inverse of the
//   epilogue's write) and goes out again by the same TMA stores; the producer
//   streams no weights for it, nor for the last layer. A layer that is not
//   stored is computed from the one before (or the encoding) as the forward
//   computes it, so each is bit for bit the forward's. No feat, no density.
enum { FWD_CKPT = 1, REMAT = 2 };

struct RematMaps {
  WeightMaps w;
  CUtensorMap enc;     // as FwdMaps
  CUtensorMap stored;  // [n_stored, n, H], box 64 x 64 x 1 (loads); not encoded without stored layers
  CUtensorMap acts;    // [L-1, n, H], box 64 x 64 x 1 (stores)
};

template <int H, int KIN, int MODE, class Maps>
__device__ __forceinline__ void fwd_body(const Maps& maps, const bf16* __restrict__ w, const bf16* __restrict__ b,
                                         float* __restrict__ dens, int n, int L, int skip, int arg) {
  constexpr int FW_STAGE = Fwd<H, KIN>::STAGE, FW_TILE = Fwd<H, KIN>::TILE, FW_ENC = Fwd<H, KIN>::ENC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* stg = ring + FW_RING * FW_STAGE;  // [wg] staging tiles
  unsigned char* enc_s = stg + 2 * FW_TILE;        // [wg] encoding tiles
  float* wd_s = reinterpret_cast<float*>(enc_s + 2 * FW_ENC);  // W_last[:, H]
  uint64_t* full = reinterpret_cast<uint64_t*>(wd_s + H + KIN);
  uint64_t* empty = full + FW_RING;
  uint64_t* efull = empty + FW_RING;
  uint64_t* lfull = efull + 1;  // REMAT: [wg] a stored layer's tile has arrived

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long row0 = (long)blockIdx.x * FW_T;
  if (tid == 0) {
    for (int s = 0; s < FW_RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives
    }
    mbar_init(efull, 1);
    if constexpr (MODE == REMAT) {
      mbar_init(lfull, 1);
      mbar_init(lfull + 1, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    // 128 x 40 + 256 x 232 = 384 x 168, the registers the block was launched with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      const int tiles = n - row0 > 64 ? 2 : 1;  // the second warpgroup's tile only if it has rows
      mbar_expect_tx(efull, tiles * FW_ENC);
      for (int h = 0; h < tiles; ++h)
        for (int kb = 0; kb < KIN / 64; ++kb)
          tma_load_2d(enc_s + h * FW_ENC + kb * FW_BOX, &maps.enc, 64 * kb, (int)row0 + 64 * h, efull);
      // stage t: rows y .. y + 64 of a layer, its H / 64 64-column boxes
      int t = 0, y0 = 0;
      for (int l = 0; l < L; ++l) {
        const int K = layer_in(l, skip, H, KIN);
        const bool last = l == L - 1;
        if constexpr (MODE == REMAT) {
          if (last || ckpt_stored(l, arg)) {  // not computed: no weights
            y0 += K;
            continue;
          }
        }
        for (int k0 = 0; k0 < K; k0 += 64, ++t) {
          const int s = t % FW_RING;
          mbar_wait(empty + s, ((t / FW_RING) & 1) ^ 1);
          mbar_expect_tx(full + s, FW_STAGE);
          for (int i = 0; i < H / 64; ++i)
            tma_load_2d(ring + s * FW_STAGE + i * FW_BOX, last ? &maps.w.last : &maps.w.hidden, 64 * i,
                        (last ? 0 : y0) + k0, full + s);
        }
        y0 += K;
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127;
  const int q = lane & 3, g = lane >> 2;
  const int r_lo = wq * 16 + g, r_hi = r_lo + 8;  // rows of this thread in the WG tile
  const long wrow0 = row0 + wg * 64;
  const int wg_rows = (int)max(0L, min(64L, (long)n - wrow0));
  if constexpr (MODE != REMAT) {
    const int K_last = layer_in(L - 1, skip, H, KIN);
    const bf16* w_last = w + w_offset(L - 1, L, skip, H, KIN);
    for (int k = tid; k < K_last; k += 256) wd_s[k] = __bfloat162float(w_last[(long)k * (H + DENS_PAD) + H]);
  }
  named_bar(3, 256);

  const FwdRing rg{smem_u32(ring), full, empty};
  const uint32_t enc_u = smem_u32(enc_s + wg * FW_ENC);
  unsigned char* tile = stg + wg * FW_TILE;
  mbar_wait(efull, 0);

  uint32_t A[H / 4];
  float acc[H / 2];
  int t = 0;
  int loads = 0;  // REMAT: stored tiles loaded so far (lfull's phase)
  for (int l = 0; l < (MODE == REMAT ? L - 1 : L); ++l) {
    if constexpr (MODE == REMAT) {
      if (ckpt_stored(l, arg)) {
        // the stored tile by TMA into the staging tile (rows past n as zeros), once the last
        // stores have read it and every thread has read its A from it; A from it, and out again
        if (wg_rows > 0) {
          if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          named_bar(1 + wg, 128);
          if (wtid == 0) {
            mbar_expect_tx(lfull + wg, FW_TILE);
            for (int i = 0; i < H / 64; ++i)
              tma_load(tile + i * FW_BOX, &maps.stored, 64 * i, (int)wrow0, l / arg, lfull + wg);
          }
          mbar_wait(lfull + wg, loads & 1);
          ++loads;
#pragma unroll
          for (int j = 0; j < H / 8; ++j) {
            const int c = 8 * j + 2 * q;
            A[2 * j] = *reinterpret_cast<const uint32_t*>(tile + stage_offset(r_lo, c));
            A[2 * j + 1] = *reinterpret_cast<const uint32_t*>(tile + stage_offset(r_hi, c));
          }
          if (wtid == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            for (int i = 0; i < H / 64; ++i) tma_store_3d(&maps.acts, 64 * i, (int)wrow0, l, tile + i * FW_BOX);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
        }
        continue;
      }
    }
    if (l == 0) {
#pragma unroll
      for (int kb = 0; kb < KIN / 64; ++kb) fwd_mma_enc<H>(acc, enc_u + kb * FW_BOX, kb != 0, t, rg);
    } else {
      fwd_mma_regs<H>(acc, A, t, rg);
      if (l == skip) {
#pragma unroll
        for (int kb = 0; kb < KIN / 64; ++kb) fwd_mma_enc<H>(acc, enc_u + kb * FW_BOX, 1, t, rg);
      }
    }
    const bool last = MODE != REMAT && l == L - 1;
    if (last) {
      // density: the last layer's input (A, and the encoding if it is the skip layer) . W_last[:, H]
      float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 lo = unpack_bf16(A[2 * j]), hi = unpack_bf16(A[2 * j + 1]);
        d_lo += lo.x * wd_s[c] + lo.y * wd_s[c + 1];
        d_hi += hi.x * wd_s[c] + hi.y * wd_s[c + 1];
      }
      if (skip == L - 1) {
        const unsigned char* e = enc_s + wg * FW_ENC;
#pragma unroll
        for (int j = 0; j < KIN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(e + stage_offset(r_lo, c)));
          const float2 hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(e + stage_offset(r_hi, c)));
          d_lo += lo.x * wd_s[H + c] + lo.y * wd_s[H + c + 1];
          d_hi += hi.x * wd_s[H + c] + hi.y * wd_s[H + c + 1];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
      }
      const float bd = __bfloat162float(b[(long)(L - 1) * H + H]);
      if (q == 0 && r_lo < wg_rows) dens[wrow0 + r_lo] = d_lo + bd;
      if (q == 0 && r_hi < wg_rows) dens[wrow0 + r_hi] = d_hi + bd;
    }

    // bias + ReLU + bf16 -> the next layer's A, and into the staging tile for acts[l] / feat
    const bool store = (last || MODE == REMAT || ckpt_stored(l, arg)) && wg_rows > 0;
    if (store) {
      if (wtid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the last stores read it
      named_bar(1 + wg, 128);
    }
    const __nv_bfloat162* bl = reinterpret_cast<const __nv_bfloat162*>(b + (long)l * H);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 bb = __bfloat1622float2(bl[c >> 1]);
      A[2 * j] = pack_bf16(fmaxf(acc[4 * j] + bb.x, 0.f), fmaxf(acc[4 * j + 1] + bb.y, 0.f));
      A[2 * j + 1] = pack_bf16(fmaxf(acc[4 * j + 2] + bb.x, 0.f), fmaxf(acc[4 * j + 3] + bb.y, 0.f));
      if (store) {
        *reinterpret_cast<uint32_t*>(tile + stage_offset(r_lo, c)) = A[2 * j];
        *reinterpret_cast<uint32_t*>(tile + stage_offset(r_hi, c)) = A[2 * j + 1];
      }
    }
    if (store) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(1 + wg, 128);
      if (wtid == 0) {
        for (int i = 0; i < H / 64; ++i) {
          if constexpr (MODE == REMAT)
            tma_store_3d(&maps.acts, 64 * i, (int)wrow0, l, tile + i * FW_BOX);
          else if (last)
            tma_store_2d(&maps.feat, 64 * i, (int)wrow0, tile + i * FW_BOX);
          else
            tma_store_3d(&maps.acts, 64 * i, (int)wrow0, l / arg, tile + i * FW_BOX);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // feat and acts written
}


template <int H, int KIN>
__global__ void __launch_bounds__(FW_THREADS, 1)
    trunk_fwd_ckpt_kernel(const __grid_constant__ FwdMaps maps, const bf16* __restrict__ w,
                          const bf16* __restrict__ b, float* __restrict__ dens, int n, int L, int skip, int ckpt) {
  fwd_body<H, KIN, FWD_CKPT>(maps, w, b, dens, n, L, skip, ckpt);
}

template <int H, int KIN>
__global__ void __launch_bounds__(FW_THREADS, 1)
    trunk_remat_kernel(const __grid_constant__ RematMaps maps, const bf16* __restrict__ w,
                       const bf16* __restrict__ b, int n, int L, int skip, int ckpt) {
  fwd_body<H, KIN, REMAT>(maps, w, b, nullptr, n, L, skip, ckpt);
}

// acts: the stored layers of checkpoint stride `ckpt`, [n_stored, n, H] (all L-1 at stride 1),
// or null when none are stored; stride 1 and no stored layer run trunk_fwd_kernel, the others
// trunk_fwd_ckpt_kernel
template <int H, int KIN>
int fwd_launch(EncodeTiled encode, const void* enc, const void* w, const void* b, void* feat, void* dens, void* acts,
               int n, int L, int skip, int ckpt, cudaStream_t stream) {
  FwdMaps maps = {};
  const cuuint64_t N = (cuuint64_t)n;
  const int n_acts = ckpt_count(L, ckpt);
  if ((acts != nullptr) != (n_acts > 0)) return (int)cudaErrorInvalidValue;
  int err = make_weight_maps(encode, &maps.w, w, L, skip, H, KIN);
  if (!err) err = make_map(encode, &maps.enc, enc, 2, {(cuuint64_t)KIN, N, 1}, {64, 64, 1}, true);
  if (!err) err = make_map(encode, &maps.feat, feat, 2, {(cuuint64_t)H, N, 1}, {64, 64, 1}, true);
  if (!err && acts) err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)H, N, (cuuint64_t)n_acts}, {64, 64, 1}, true);
  if (err) return err;
  constexpr size_t smem = Fwd<H, KIN>::SMEM;
  const int blocks = (n + FW_T - 1) / FW_T;
  if (ckpt == 1 || acts == nullptr) {
    cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel<H, KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    trunk_fwd_kernel<H, KIN><<<blocks, FW_THREADS, smem, stream>>>(maps, (const bf16*)w, (const bf16*)b, (float*)dens, n,
                                                                    L, skip, acts != nullptr);
  } else {
    cudaError_t e =
        cudaFuncSetAttribute(trunk_fwd_ckpt_kernel<H, KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    trunk_fwd_ckpt_kernel<H, KIN><<<blocks, FW_THREADS, smem, stream>>>(maps, (const bf16*)w, (const bf16*)b,
                                                                         (float*)dens, n, L, skip, ckpt);
  }
  return (int)cudaGetLastError();
}

// stored: the forward's [n_stored, n, H] of stride `ckpt` (null when it stored none); acts: the
// [L-1, n, H] every hidden layer is written into
template <int H, int KIN>
int remat_launch(EncodeTiled encode, const void* enc, const void* w, const void* b, const void* stored, void* acts,
                 int n, int L, int skip, int ckpt, cudaStream_t stream) {
  RematMaps maps = {};
  const cuuint64_t N = (cuuint64_t)n;
  const int n_stored = ckpt_count(L, ckpt);
  if ((stored != nullptr) != (n_stored > 0) || acts == nullptr) return (int)cudaErrorInvalidValue;
  int err = make_weight_maps(encode, &maps.w, w, L, skip, H, KIN);
  if (!err) err = make_map(encode, &maps.enc, enc, 2, {(cuuint64_t)KIN, N, 1}, {64, 64, 1}, true);
  if (!err && stored)
    err = make_map(encode, &maps.stored, stored, 3, {(cuuint64_t)H, N, (cuuint64_t)n_stored}, {64, 64, 1}, true);
  if (!err) err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)H, N, (cuuint64_t)(L - 1)}, {64, 64, 1}, true);
  if (err) return err;
  constexpr size_t smem = Fwd<H, KIN>::SMEM + 2 * sizeof(uint64_t);  // + lfull
  cudaError_t e = cudaFuncSetAttribute(trunk_remat_kernel<H, KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + FW_T - 1) / FW_T;
  trunk_remat_kernel<H, KIN><<<blocks, FW_THREADS, smem, stream>>>(maps, (const bf16*)w, (const bf16*)b, n, L, skip,
                                                                    ckpt);
  return (int)cudaGetLastError();
}

template <int H, int KIN>
int chain_launch(EncodeTiled encode, const void* gfeat, const void* gdens, const void* feat, const void* acts,
                 const void* w, void* denc, void* gsave, void* db, int n, int L, int skip, cudaStream_t stream) {
  WeightMaps maps;
  const int err = make_weight_maps(encode, &maps, w, L, skip, H, KIN);
  if (err) return err;
  constexpr size_t smem = Chain<H, KIN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_chain_kernel<H, KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + CH_T - 1) / CH_T;
  trunk_bwd_chain_kernel<H, KIN><<<blocks, CH_THREADS, smem, stream>>>(
      (const bf16*)gfeat, (const bf16*)gdens, (const bf16*)feat, (const bf16*)acts, (const bf16*)w, maps,
      (bf16*)denc, (bf16*)gsave, (float*)db, n, L, skip);
  return (int)cudaGetLastError();
}

template <int H, int KIN>
int dw_launch(EncodeTiled encode, int sms, const void* enc, const void* acts, const void* gsave, const void* gdens,
              void* dw, int n, int L, int skip, cudaStream_t stream) {
  DwMaps maps;
  const cuuint64_t N = (cuuint64_t)n;
  int err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)H, N, (cuuint64_t)(L - 1)}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.enc, enc, 3, {(cuuint64_t)KIN, N, 1}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.g, gsave, 3, {(cuuint64_t)H, N, (cuuint64_t)L}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.gd, gdens, 1, {N, 1, 1}, {DW_PTS, 1, 1}, false);
  if (err) return err;
  constexpr size_t smem = Dw<H>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_dw_kernel<H, KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // about two waves of one block per SM, every slice a whole number of chunks
  int tiles = 0;
  for (int l = 0; l < L; ++l) tiles += dw_tiles_of(layer_in(l, skip, H, KIN));
  const int chunks = (n + DW_PTS - 1) / DW_PTS;
  const int splits = std::max(1, std::min(2 * sms / tiles, chunks));
  const int rows_per_split = (chunks + splits - 1) / splits * DW_PTS;
  trunk_bwd_dw_kernel<H, KIN><<<dim3(tiles, splits), DW_THREADS, smem, stream>>>(maps, (float*)dw, n, L, skip,
                                                                                  rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ C interface
// Each function launches on `stream`, does not synchronise, and returns the
// cudaError_t of the launch (0 on success): cudaErrorInvalidValue for an H
// other than 128 or 256 (the chain: 256) or a KIN other than 64 or 128.

// the instantiation of `fn` for (H, KIN); the backward chain's for H = 256 only
#define CHAIN_DISPATCH(fn, H, KIN, ...)                                          \
  ((H) == 256 && (KIN) == 64    ? fn<256, 64>(__VA_ARGS__)                        \
   : (H) == 256 && (KIN) == 128 ? fn<256, 128>(__VA_ARGS__)                       \
                                : (int)cudaErrorInvalidValue)
#define TRUNK_DISPATCH(fn, H, KIN, ...)                                          \
  ((H) == 256 && (KIN) == 64    ? fn<256, 64>(__VA_ARGS__)                        \
   : (H) == 256 && (KIN) == 128 ? fn<256, 128>(__VA_ARGS__)                       \
   : (H) == 128 && (KIN) == 64  ? fn<128, 64>(__VA_ARGS__)                        \
   : (H) == 128 && (KIN) == 128 ? fn<128, 128>(__VA_ARGS__)                       \
                                : (int)cudaErrorInvalidValue)

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// acts: [n_stored, n, H], the hidden layers that checkpoint stride `ckpt` stores (fwd_launch)
int trunk_fwd(const void* enc, const void* w, const void* b, void* feat, void* dens, void* acts,
              int n, int L, int skip, int H, int kin, int ckpt, void* stream) {
  static EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  return TRUNK_DISPATCH(fwd_launch, H, kin, encode, enc, w, b, feat, dens, acts, n, L, skip, ckpt,
                        (cudaStream_t)stream);
}

// every hidden layer into acts [L-1, n, H]: the stored ones of stride `ckpt` copied from
// `stored`, the others recomputed from the nearest one before (remat_launch)
int trunk_remat(const void* enc, const void* w, const void* b, const void* stored, void* acts, int n, int L, int skip,
                int H, int kin, int ckpt, void* stream) {
  static EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  return TRUNK_DISPATCH(remat_launch, H, kin, encode, enc, w, b, stored, acts, n, L, skip, ckpt,
                        (cudaStream_t)stream);
}

int trunk_bwd_chain(const void* gfeat, const void* gdens, const void* feat, const void* acts,
                    const void* w, void* denc, void* gsave, void* db, int n, int L, int skip, int H, int kin,
                    void* stream) {
  static EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  return CHAIN_DISPATCH(chain_launch, H, kin, encode, gfeat, gdens, feat, acts, w, denc, gsave, db, n, L, skip,
                        (cudaStream_t)stream);
}

int trunk_bwd_dw(const void* enc, const void* acts, const void* gsave, const void* gdens, void* dw, int n,
                 int L, int skip, int H, int kin, void* stream) {
  static EncodeTiled encode = encode_tiled();
  static int sms = 0;
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  return TRUNK_DISPATCH(dw_launch, H, kin, encode, sms, enc, acts, gsave, gdens, dw, n, L, skip,
                        (cudaStream_t)stream);
}

}  // extern "C"
