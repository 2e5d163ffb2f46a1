// Backward chain of the scene-NeRF trunk at width H = 128 for Hopper (sm_90a).
//
// Replaces, at H = 128, the chain half of the Pallas TPU kernel
// `_trunk_bwd_call` (poseprobe_tpu/ops/pallas/fused_mlp.py): layer l = L-1 ..
// 0 of the trunk's VJP for every point, gx = g_l W_l^T and g_{l-1} = (a_{l-1}
// > 0) ? gx : 0, with g saved for the dW kernel (fused_trunk.cu's
// `trunk_bwd_dw_kernel<128, KIN>`), db summed and denc written. The packed
// layout and the numerics are fused_trunk.cu's (poseprobe_tpu_torch/ops/
// fused_mlp.py holds the plain twin): the last layer's mask from the bf16
// feat, g in f32 rounded to bf16 for the products, db from the f32 g, denc =
// bf16(bf16(gx_0) + bf16(the skip layer's encoding part)), the density
// column's term in the last layer.
//
// What bounds it: per point and layer it reads a 256-byte activation row
// (the mask) and writes a 256-byte row of g against 64 K multiply-adds, so
// device memory: ~1.8 GB at 8 x 128 and 393,216 points, ~0.54 ms. At this
// width a block's fixed costs per tile and per layer set the pace unless many
// independent chains are in flight, the masks are requested well ahead and
// nothing waits on a sum.
//
// Design. Persistent blocks (the grid is the wrapper's `narrow_plan`: one per
// multiprocessor, at most one per tile) walk 256-point tiles. Four consumer
// warpgroups each run one 64-point sub-tile of a tile through all L layers:
// four independent chains per multiprocessor, which the warp schedulers
// interleave, so one chain's epilogue runs beside another's products and
// waits. One producer warp streams the weights by TMA into a RING-stage ring
// of [128 inputs x 64 outputs] stages (two 64 x 64 boxes, 128-byte swizzle,
// K-major for g W^T) straight from the packed weights; each stage serves all
// four sub-tiles, so the weights stream from L2 once per 256 points, and the
// producer runs on across layers and tiles. Two stages, one layer, are enough:
// the shared memory goes to the slots.
// Each warpgroup owns NSLOT slots of [64 points x 128] bf16 (two 64 x 64
// boxes, 128-byte swizzle, the layout TMA moves). Its first thread loads
// them by TMA, in the order the chain reads them: per tile gfeat, feat, then
// the stored activations a_{L-2} .. a_0 (rows past n arrive as zeros; a
// sub-tile wholly past n loads nothing). The epilogue of layer l reads the
// mask a_{l-1} from its slot, writes bf16 g_{l-1} over it, and the same
// thread stores the slot to gsave[l-1] by TMA (rows past n are clipped). The
// slot is then layer l-1's A operand: wgmma reads A and B from shared memory,
// so no operand goes through registers. Once layer l-1's products have read
// it and its store has, the slot takes the next load: with three slots, each
// mask is requested two layers before its epilogue.
// db: each thread adds its two rows of the f32 g per column, a reduce-scatter
// over the warp's row groups leaves each lane the sums of 4 columns, and each
// consumer warp adds those to its own f32 copy of db in device memory (plain
// loads, issued two layers before their use, and stores: no atomics; under an
// L2 evict-last policy, so the 16 copies a block keeps stay in L2 while the
// masks and g stream past). At its end the block adds its 16 copies into the
// first in a fixed order, and trunk_narrow_db_sum_kernel adds the blocks'
// copies into db in a fixed order: db does not depend on the blocks' timing
// and is the same from run to run.
// denc: the skip layer writes bf16 of its encoding part into denc (evict
// last), and layer 0 adds bf16(gx_0) to what the same thread wrote there, in
// bf16; it loads that part before its products, which it runs in halves of
// 64 columns so the loaded part fits in registers beside them. There is no
// shared memory left to keep it on chip.
//
// Registers: an m64n128 accumulator is 64 f32 a thread and A is in shared
// memory, so a consumer thread holds ~64 accumulators, the column sums that
// replace them as the epilogue walks the columns, and ~30 scalars. The block
// is 640 threads, launched with 96 registers each: the producer warpgroup
// gives its own back down to 24 and the consumers take 112 (128 x 24 + 512 x
// 112 <= 640 x 96).
// Shared memory at KIN = 128: 1 KB alignment + ring 2 x 16 KB + slots 4 x 3 x
// 16 KB + W_last's density column (H + KIN) x 4 B + 16 mbarriers = 231,552 of
// the 232,448 bytes a block may have (KIN = 64: 231,296).

#include "hopper.cuh"

namespace {

constexpr int NH = 128;                 // the trunk width this kernel takes
constexpr int SUB = 64;                 // points of a sub-tile: one warpgroup's wgmma rows
constexpr int NWG = 4;                  // consumer warpgroups: independent 64-point chains per block
constexpr int TILE = NWG * SUB;         // points of a block's tile
constexpr int THREADS = NWG * 128 + 128;  // the consumers and a producer warpgroup (one warp loads)
constexpr int NSLOT = 3;                // mask / g slots per warpgroup
constexpr int RING = 2;                 // weight stages
constexpr int BOX = 64 * 64 * 2;        // one 64 x 64 bf16 box
constexpr int SLOT = 2 * BOX;           // a warpgroup's [64 points x 128] tile
constexpr int STAGE = 2 * BOX;          // [128 inputs x 64 outputs] of a layer's weights
constexpr int DB_WARPS = NWG * 4;       // db copies per block: one per consumer warp
constexpr int DB_SUM_COLS = 32;         // columns of a block of the db sum kernel

template <int KIN>
struct Narrow {
  static constexpr size_t SMEM = 1024 + RING * STAGE + NWG * NSLOT * SLOT + (NH + KIN) * sizeof(float) +
                                 (2 * RING + NWG * NSLOT) * sizeof(uint64_t);
};

// floats of a db copy: the first L * H + 1 of db (every layer's H columns, the density column)
__host__ __device__ __forceinline__ long db_stride(int L) { return (long)L * NH + 1; }

struct NarrowMaps {
  WeightMaps w;       // the packed weights (hopper.cuh)
  CUtensorMap gfeat;  // [n, H], 64 x 64 boxes, 128-byte swizzle
  CUtensorMap feat;   // [n, H]
  CUtensorMap acts;   // [L-1, n, H], 64 x 64 x 1 boxes
  CUtensorMap gsave;  // [L, n, H], the same boxes (TMA stores)
};

// acc = A (a slot: 64 points x H, K-major) x the next H / 64 ring stages (N x 64 each, K-major)
template <int N>
__device__ __forceinline__ void chain_products(float (&acc)[N / 2], uint32_t a, int& t, uint32_t ring,
                                               uint64_t* full, uint64_t* empty) {
  fence_operand(acc);
#pragma unroll
  for (int kt = 0; kt < NH / 64; ++kt) {
    const int s = t % RING;
    mbar_wait(full + s, (t / RING) & 1);
    const uint32_t b = ring + s * STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (N == 128)
        wgmma_m64n128_ss<0, 0>(acc, desc_sw128(a + kt * BOX + 32 * kk), desc_sw128(b + 32 * kk), (kt | kk) != 0);
      else
        wgmma_m64n64_ss<0, 0>(acc, desc_sw128(a + kt * BOX + 32 * kk), desc_sw128(b + 32 * kk), (kt | kk) != 0);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      mbar_arrive(empty + (t - 1) % RING);
    }
    ++t;
  }
  wgmma_wait<0>();
  mbar_arrive(empty + (t - 1) % RING);
  fence_operand(acc);
}

// acc = A (a slot) x box `h` (inputs 64 h .. 64 h + 63) of the next two ring stages (N = 64):
// a half of an N = 128 pass, or all of an N = 64 one. WAIT: the first half waits for the
// stages; RELEASE: the last half hands them back and moves t past them
template <bool WAIT, bool RELEASE>
__device__ __forceinline__ void half_products(float (&acc)[32], uint32_t a, int h, int& t, uint32_t ring,
                                              uint64_t* full, uint64_t* empty) {
  fence_operand(acc);
#pragma unroll
  for (int kt = 0; kt < NH / 64; ++kt) {
    const int s = (t + kt) % RING;
    if constexpr (WAIT) mbar_wait(full + s, ((t + kt) / RING) & 1);
    const uint32_t b = ring + s * STAGE + h * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_ss<0, 0>(acc, desc_sw128(a + kt * BOX + 32 * kk), desc_sw128(b + 32 * kk), (kt | kk) != 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
  if constexpr (RELEASE) {
#pragma unroll
    for (int kt = 0; kt < NH / 64; ++kt) mbar_arrive(empty + (t + kt) % RING);
    t += NH / 64;
  }
  fence_operand(acc);
}

// L2 policies: the db copies and the skip layer's part of denc are read again by
// the same thread soon (evict last); layer 0's denc is not (evict first)
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint32_t ld_hint(const void* a, uint64_t pol) {
  uint32_t v;
  asm volatile("ld.global.L2::cache_hint.b32 %0, [%1], %2;\n" : "=r"(v) : "l"(a), "l"(pol) : "memory");
  return v;
}
__device__ __forceinline__ void st_hint(void* a, uint32_t v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;\n" ::"l"(a), "r"(v), "l"(pol) : "memory");
}
// column c(t) of the 4 sums a lane holds after colsum32_scatter over 128 columns
__device__ __forceinline__ int scatter_col(int lane, int t) {
  const int idx = ((lane & 4) ? 16 : 0) + ((lane & 8) ? 8 : 0) + ((lane & 16) ? 4 : 0) + t;
  return 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1);
}

template <int KIN>
__global__ void __launch_bounds__(THREADS, 1)
    trunk_narrow_chain_kernel(const __grid_constant__ NarrowMaps maps, const bf16* __restrict__ gdens,
                              const bf16* __restrict__ w, bf16* __restrict__ denc, float* __restrict__ part, int n,
                              int L, int skip, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  unsigned char* slots_all = ring + RING * STAGE;                          // [wg][NSLOT] slots
  float* wd_s = reinterpret_cast<float*>(slots_all + NWG * NSLOT * SLOT);  // W_last[:, H]
  uint64_t* full = reinterpret_cast<uint64_t*>(wd_s + NH + KIN);
  uint64_t* empty = full + RING;
  uint64_t* sfull_all = empty + RING;  // [wg][NSLOT]: a slot's load has landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 128);  // every consumer thread arrives: no divergent path among the products
    }
    for (int s = 0; s < NWG * NSLOT; ++s) mbar_init(sfull_all + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ------------------------------------------------------------ producer
    // weight stages W_l[c0 .. c0 + rows, 64 kt .. 64 kt + 64] in the order the
    // consumers take them, tile after tile; a 128-row stage is two 64-row boxes.
    // 128 x 24 + 512 x 112 <= 640 x 96, the registers the block was launched with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NWG * 4 && lane == 0) {
      int t = 0;
      for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
        for (int l = L - 1; l >= 0; --l) {
          const int K = layer_in(l, skip, NH, KIN);
          const CUtensorMap* map = l == L - 1 ? &maps.w.last : &maps.w.hidden;
          const int y0 = l == L - 1 ? 0 : (int)(w_offset(l, L, skip, NH, KIN) / NH);
          for (int c0 = 0; c0 < K;) {
            const int rows = K - c0 >= 128 ? 128 : 64;
            for (int kt = 0; kt < NH / 64; ++kt, ++t) {
              const int s = t % RING;
              mbar_wait(empty + s, ((t / RING) & 1) ^ 1);
              mbar_expect_tx(full + s, rows * 64 * sizeof(bf16));
              for (int h = 0; h < rows / 64; ++h)
                tma_load_2d(ring + s * STAGE + h * BOX, map, kt * 64, y0 + c0 + 64 * h, full + s);
            }
            c0 += rows;
          }
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
  const int wg = warp >> 2, wq = warp & 3, wtid = tid & 127, q = lane & 3;
  const int r_lo = wq * 16 + (lane >> 2), r_hi = r_lo + 8;  // rows of this thread in the sub-tile
  // byte offset of (r_lo, 8 j + 2 q) in a slot, two 64 x 64 boxes with the 128-byte swizzle:
  // element (r, c) at (c / 64) BOX + 128 r + 16 ((c % 64 / 8) ^ (r % 8)) + 2 (c % 8); (r_hi, ...)
  // is 1024 bytes on
  const auto at = [&](int j) -> uint32_t {
    return (j >> 3) * BOX + r_lo * 128 + (((j & 7) ^ (lane >> 2)) << 4) + 4 * q;
  };
  unsigned char* slots = slots_all + wg * NSLOT * SLOT;
  uint64_t* sfull = sfull_all + wg * NSLOT;
  const uint32_t slots_u = smem_u32(slots), ring_u = smem_u32(ring);
  float* dbw = part + (long)(blockIdx.x * DB_WARPS + warp) * db_stride(L);  // this warp's db copy
  {
    const int K_last = layer_in(L - 1, skip, NH, KIN);
    const bf16* w_last = w + w_offset(L - 1, L, skip, NH, KIN);
    for (int k = tid; k < K_last; k += NWG * 128) wd_s[k] = __bfloat162float(w_last[(long)k * (NH + DENS_PAD) + NH]);
  }

  // the warpgroup's loads, issued by its first thread: the next is step ld_step of tile
  // ld_it (0 gfeat, 1 feat, 2 + i the activation a_{L-2-i})
  int ld_it = blockIdx.x, ld_step = 0;
  auto load_next = [&](int s) {
    if (ld_it >= tiles) return;  // past the block's last tile: never waited on
    const int row = ld_it * TILE + wg * SUB;
    unsigned char* dst = slots + s * SLOT;
    if (row < n) {
      mbar_expect_tx(sfull + s, SLOT);
      for (int i = 0; i < 2; ++i) {
        if (ld_step == 0)
          tma_load_2d(dst + i * BOX, &maps.gfeat, 64 * i, row, sfull + s);
        else if (ld_step == 1)
          tma_load_2d(dst + i * BOX, &maps.feat, 64 * i, row, sfull + s);
        else
          tma_load(dst + i * BOX, &maps.acts, 64 * i, row, L - ld_step, sfull + s);
      }
    } else {
      mbar_arrive(sfull + s);  // a sub-tile wholly past n: the phase completes without data
    }
    if (++ld_step == L + 1) {
      ld_step = 0;
      ld_it += gridDim.x;
    }
  };
  if (wtid == 0)
    for (int s = 0; s < NSLOT; ++s) load_next(s);
  named_bar(1 + NWG, NWG * 128);  // wd_s written

  // the slots' roles: cur holds g_l (the products' A), q1 the next mask, q2 the one after
  int cur = 0, q1 = 1, q2 = 2;
  uint32_t phase = 0;  // parity of each slot's next load
  auto wait_slot = [&](int s) {
    mbar_wait(sfull + s, (phase >> s) & 1);
    phase ^= 1u << s;
  };
  // the slot's g of `layer` to gsave; the generic writes before it are fenced and the
  // warpgroup has passed its barrier
  auto store_slot = [&](int s, int layer, int row0) {
    if (row0 < n) {
      for (int i = 0; i < 2; ++i) tma_store_3d(&maps.gsave, 64 * i, row0, layer, slots + s * SLOT + i * BOX);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  };
  // this warp's column sums of one layer's g (v: the thread's two rows, columns 8 j + 2 q + e
  // at 2 j + e) added to its db copy; `pre` its earlier sums (the block's first tile: zeros)
  auto add_db = [&](float (&v)[32], int layer, const float (&pre)[4]) {
    colsum32_scatter(v, lane);
    float* d = dbw + (long)layer * NH;
    const uint64_t pol = l2_evict_last();
#pragma unroll
    for (int i = 0; i < 4; ++i) st_hint(d + scatter_col(lane, i), __float_as_uint(pre[i] + v[i]), pol);
  };
  // the earlier sums of the db layers of the next two steps (a tile's step s sums layer L-1-s),
  // loaded two steps ahead of their use: pre_a for this step, pre_b for the next
  float pre_a[4] = {0.f, 0.f, 0.f, 0.f}, pre_b[4] = {0.f, 0.f, 0.f, 0.f};
  float sd_pre = 0.f;  // lane 0: the density column's, for the next tile
  auto advance_db = [&](int step, bool first) {
    const int s2 = step + 2, layer = L - 1 - s2 % L;  // past the tile's L steps: the next tile's
    const float* d = dbw + (long)layer * NH;
    const uint64_t pol = l2_evict_last();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pre_a[i] = pre_b[i];
      pre_b[i] = s2 < L && first ? 0.f : __uint_as_float(ld_hint(d + scatter_col(lane, i), pol));
    }
  };

  int t = 0;
  for (int it = blockIdx.x; it < tiles; it += gridDim.x) {
    const bool first = it == blockIdx.x;
    const int row0 = it * TILE + wg * SUB;
    const int rows = max(0, min(SUB, n - row0));
    const bool v_lo = r_lo < rows, v_hi = r_hi < rows;
    const float gd_lo = v_lo ? __bfloat162float(gdens[row0 + r_lo]) : 0.f;
    const float gd_hi = v_hi ? __bfloat162float(gdens[row0 + r_hi]) : 0.f;

    // layer L-1: g = [feat > 0 ? gfeat : 0 | gdens] (bf16 exact) in place of gfeat
    {
      unsigned char* gs = slots + cur * SLOT;
      const unsigned char* fs = slots + q1 * SLOT;
      wait_slot(cur);
      wait_slot(q1);
      float cs[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t* plo = reinterpret_cast<uint32_t*>(gs + at(j));
        uint32_t* phi = reinterpret_cast<uint32_t*>(gs + at(j) + 1024);
        const float2 glo = unpack_bf16(v_lo ? *plo : 0u), ghi = unpack_bf16(v_hi ? *phi : 0u);
        const uint32_t flo = v_lo ? *reinterpret_cast<const uint32_t*>(fs + at(j)) : 0u;
        const uint32_t fhi = v_hi ? *reinterpret_cast<const uint32_t*>(fs + at(j) + 1024) : 0u;
        const uint32_t a = mask_pack(glo.x, glo.y, flo), b = mask_pack(ghi.x, ghi.y, fhi);
        *plo = a;
        *phi = b;
        const float2 ma = unpack_bf16(a), mb = unpack_bf16(b);
        cs[2 * j] = ma.x + mb.x;
        cs[2 * j + 1] = ma.y + mb.y;
      }
      add_db(cs, L - 1, pre_a);
      advance_db(0, first);
      float sd = q == 0 ? gd_lo + gd_hi : 0.f;  // each row once
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
      if (lane == 0) {
        float* d = dbw + (long)L * NH;
        st_hint(d, __float_as_uint(sd_pre + sd), l2_evict_last());
        sd_pre = __uint_as_float(ld_hint(d, l2_evict_last()));  // the next tile's
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(1 + wg, 128);
      if (wtid == 0) {
        load_next(q1);  // feat was read before the barrier
        store_slot(cur, L - 1, row0);
      }
      const int f = q1;
      q1 = q2;
      q2 = f;
    }

    for (int l = L - 1; l > 0; --l) {
      const bool dens = l == L - 1;
      const uint32_t a = slots_u + cur * SLOT;
      float acc[64];
      chain_products<128>(acc, a, t, ring_u, full, empty);
      // g_{l-1} = a_{l-1} > 0 ? gx : 0 over the mask, summed per column in f32
      unsigned char* ys = slots + q1 * SLOT;
      wait_slot(q1);
      float cs[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * q;
        float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
        if (dens) {
          const float w0 = wd_s[c], w1 = wd_s[c + 1];
          v0 += gd_lo * w0;
          v1 += gd_lo * w1;
          v2 += gd_hi * w0;
          v3 += gd_hi * w1;
        }
        uint32_t* plo = reinterpret_cast<uint32_t*>(ys + at(j));
        uint32_t* phi = reinterpret_cast<uint32_t*>(ys + at(j) + 1024);
        const float2 mlo = unpack_bf16(v_lo ? *plo : 0u), mhi = unpack_bf16(v_hi ? *phi : 0u);
        v0 = mlo.x > 0.f ? v0 : 0.f;
        v1 = mlo.y > 0.f ? v1 : 0.f;
        v2 = mhi.x > 0.f ? v2 : 0.f;
        v3 = mhi.y > 0.f ? v3 : 0.f;
        *plo = pack_bf16(v0, v1);
        *phi = pack_bf16(v2, v3);
        cs[2 * j] = v0 + v2;
        cs[2 * j + 1] = v1 + v3;
      }
      add_db(cs, l - 1, pre_a);
      advance_db(L - l, first);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(1 + wg, 128);
      if (l == skip) {
        // the encoding inputs of the skip layer: bf16 gx into denc, for layer 0 to add to
        if (wtid == 0) store_slot(q1, l - 1, row0);
        float acc2[KIN / 2];
        chain_products<KIN>(acc2, a, t, ring_u, full, empty);
#pragma unroll
        for (int j = 0; j < KIN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          float v0 = acc2[4 * j], v1 = acc2[4 * j + 1], v2 = acc2[4 * j + 2], v3 = acc2[4 * j + 3];
          if (dens) {
            const float w0 = wd_s[NH + c], w1 = wd_s[NH + c + 1];
            v0 += gd_lo * w0;
            v1 += gd_lo * w1;
            v2 += gd_hi * w0;
            v3 += gd_hi * w1;
          }
          const uint64_t pol = l2_evict_last();  // layer 0 reads it back
          if (v_lo) st_hint(denc + (long)(row0 + r_lo) * KIN + c, pack_bf16(v0, v1), pol);
          if (v_hi) st_hint(denc + (long)(row0 + r_hi) * KIN + c, pack_bf16(v2, v3), pol);
        }
        named_bar(1 + wg, 128);  // every product has read g_l
        if (wtid == 0) {
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");  // g_l's store, not g_{l-1}'s
          load_next(cur);
        }
      } else if (wtid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // g_l's store has read the slot
        load_next(cur);
        store_slot(q1, l - 1, row0);
      }
      const int r = cur;
      cur = q1;
      q1 = q2;
      q2 = r;
    }

    // layer 0: denc = bf16(gx) + the skip layer's part, in bf16. The skip layer's part is
    // loaded before the products, which hide its latency; they run in halves of 64 columns
    // (two accumulator registers in four), so the loaded part fits beside them
    {
      uint32_t e[KIN / 4];  // denc's bf16 pairs (row lo, row hi) of columns 8 j + 2 q, j < KIN / 8
      const uint64_t pol = l2_evict_first();
#pragma unroll
      for (int j = 0; j < KIN / 8; ++j) {
        const int c = 8 * j + 2 * q;
        e[2 * j] = v_lo ? ld_hint(denc + (long)(row0 + r_lo) * KIN + c, pol) : 0u;
        e[2 * j + 1] = v_hi ? ld_hint(denc + (long)(row0 + r_hi) * KIN + c, pol) : 0u;
      }
      // columns 64 h .. 64 h + 63 of denc from the half's accumulators
      const auto finish = [&](const float (&acc2)[32], int h) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * h + jj, c = 8 * j + 2 * q;
          const float2 xlo = unpack_bf16(pack_bf16(acc2[4 * jj], acc2[4 * jj + 1]));
          const float2 xhi = unpack_bf16(pack_bf16(acc2[4 * jj + 2], acc2[4 * jj + 3]));
          const float2 elo = unpack_bf16(e[2 * j]), ehi = unpack_bf16(e[2 * j + 1]);
          if (v_lo) st_hint(denc + (long)(row0 + r_lo) * KIN + c, pack_bf16(xlo.x + elo.x, xlo.y + elo.y), pol);
          if (v_hi) st_hint(denc + (long)(row0 + r_hi) * KIN + c, pack_bf16(xhi.x + ehi.x, xhi.y + ehi.y), pol);
        }
      };
      const uint32_t a = slots_u + cur * SLOT;
      if constexpr (KIN == 64) {
        float acc2[32];
        half_products<true, true>(acc2, a, 0, t, ring_u, full, empty);
        finish(acc2, 0);
      } else {
        float acc2[32];
        half_products<true, false>(acc2, a, 0, t, ring_u, full, empty);
        finish(acc2, 0);
        half_products<false, true>(acc2, a, 1, t, ring_u, full, empty);
        finish(acc2, 1);
      }
      named_bar(1 + wg, 128);  // every product has read g_0
      if (wtid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load_next(cur);
      }
      const int r = cur;
      cur = q1;
      q1 = q2;
      q2 = r;
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // gsave written

  // the block's 16 db copies into its first, in warp order
  named_bar(1 + NWG, NWG * 128);
  float* blk = part + (long)blockIdx.x * DB_WARPS * db_stride(L);
  for (long c = tid; c < db_stride(L); c += NWG * 128) {
    float s = 0.f;
    for (int i = 0; i < DB_WARPS; ++i) s += blk[i * db_stride(L) + c];
    blk[c] = s;
  }
}

// db[c] += the blocks' copies of column c (part[b * DB_WARPS * stride + c]), in block order
__global__ void __launch_bounds__(256) trunk_narrow_db_sum_kernel(const float* __restrict__ part,
                                                                  float* __restrict__ db, int blocks, int L) {
  __shared__ float red[8][DB_SUM_COLS];
  const int tx = threadIdx.x % DB_SUM_COLS, ty = threadIdx.x / DB_SUM_COLS;
  const long c = (long)blockIdx.x * DB_SUM_COLS + tx, stride = db_stride(L);
  float s = 0.f;
  if (c < stride)
    for (int b = ty; b < blocks; b += 8) s += part[(long)b * DB_WARPS * stride + c];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < stride) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += red[i][tx];
    db[c] += t;
  }
}

template <int KIN>
int narrow_launch(EncodeTiled encode, const void* gfeat, const void* gdens, const void* feat, const void* acts,
                  const void* w, void* denc, void* gsave, void* db, void* part, int n, int L, int skip, int blocks,
                  long long part_floats, int smem, cudaStream_t stream) {
  const int tiles = (n + TILE - 1) / TILE;
  if (n < 1 || blocks < 1 || blocks > tiles || part_floats != (long long)blocks * DB_WARPS * db_stride(L) ||
      smem != (int)Narrow<KIN>::SMEM)
    return (int)cudaErrorInvalidValue;
  NarrowMaps maps;
  const cuuint64_t N = (cuuint64_t)n;
  int err = make_weight_maps(encode, &maps.w, w, L, skip, NH, KIN);
  if (!err) err = make_map(encode, &maps.gfeat, gfeat, 2, {(cuuint64_t)NH, N, 1}, {64, 64, 1}, true);
  if (!err) err = make_map(encode, &maps.feat, feat, 2, {(cuuint64_t)NH, N, 1}, {64, 64, 1}, true);
  if (!err) err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)NH, N, (cuuint64_t)(L - 1)}, {64, 64, 1}, true);
  if (!err) err = make_map(encode, &maps.gsave, gsave, 3, {(cuuint64_t)NH, N, (cuuint64_t)L}, {64, 64, 1}, true);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(trunk_narrow_chain_kernel<KIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  trunk_narrow_chain_kernel<KIN><<<blocks, THREADS, smem, stream>>>(maps, (const bf16*)gdens, (const bf16*)w,
                                                                   (bf16*)denc, (float*)part, n, L, skip, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  trunk_narrow_db_sum_kernel<<<(unsigned)((db_stride(L) + DB_SUM_COLS - 1) / DB_SUM_COLS), 256, 0, stream>>>(
      (const float*)part, (float*)db, blocks, L);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ C interface
// Launches on `stream`, does not synchronise, and returns the cudaError_t of
// its launches (0 on success): cudaErrorInvalidValue for a KIN other than 64
// or 128, no points, or a plan other than `fused_mlp.narrow_plan`'s (blocks
// from 1 to the 256-point tiles, `part` of blocks x 16 x (L x 128 + 1) f32,
// the kernel's shared-memory bytes).

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the chain of an H = 128 trunk: denc, gsave ([L, n, 128]: every layer's g, for dW) and db
// (added to); `part` is f32 scratch for the blocks' db copies
int trunk_narrow_bwd_chain(const void* gfeat, const void* gdens, const void* feat, const void* acts, const void* w,
                           void* denc, void* gsave, void* db, void* part, int n, int L, int skip, int kin,
                           int blocks, long long part_floats, int smem, void* stream) {
  static EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (kin == 64)
    return narrow_launch<64>(encode, gfeat, gdens, feat, acts, w, denc, gsave, db, part, n, L, skip, blocks,
                             part_floats, smem, (cudaStream_t)stream);
  if (kin == 128)
    return narrow_launch<128>(encode, gfeat, gdens, feat, acts, w, denc, gsave, db, part, n, L, skip, blocks,
                              part_floats, smem, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
