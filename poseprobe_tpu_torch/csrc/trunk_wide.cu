// Fused scene-NeRF trunk for Hopper (sm_90a), widths H >= 384: forward,
// backward chain and dW.
//
// Replaces the Pallas TPU kernels `_trunk_fwd_call` and `_trunk_bwd_call` of
// poseprobe_tpu/ops/pallas/fused_mlp.py for the trunk widths that
// fused_trunk.cu does not take: the reference takes any uniform width that
// is a multiple of 128, and one m64nH wgmma accumulator of H / 2 registers a
// thread does not fit beside a register-resident activation from H = 384 on.
// The Python side (poseprobe_tpu_torch/ops/fused_mlp.py) packs the weights
// in the layout hopper.cuh describes (K_l = KIN, H + KIN or H; NO_l = H, or
// H + 128 for the last layer, columns [feat | density | 0...]), computes the
// launch plan these functions check (`wide_plan`) and holds the plain twin
// these kernels are tested against.
//
// What bounds it: at 8 x 512 with a 64-wide input the trunk is 1.90 M
// multiply-adds a point, 1.51 ms of the bf16 tensor-core peak at 393,216
// points for the forward and twice that for the backward: operations. The
// activation of a 128-point tile is 128 KB at H = 512 and 256 KB at 1024, too
// much to keep in shared memory beside a weight ring at every width, so each
// layer is one launch of a GEMM and the activations and g go through device
// memory between layers (~6 GB a forward, ~16 GB a backward at 8 x 512:
// 1.8 / 4.9 ms of HBM time, the floors of this design). No width is too large.
//
// The forward and the chain run one kernel, `trunk_wide_gemm_kernel<MODE>`,
// per layer: out[points x cols] = A[points x K] B[K x cols] with the layer's
// epilogue fused. Persistent clusters of two blocks walk the tiles; a tile is
// 128 points (two consumer warpgroups of 64, wgmma m64nNk16 with both
// operands in shared memory) by 256 columns (a 128 tail where H is an odd
// multiple of 128; 64 for the density column and 64 or 128 for the encoding
// inputs), 64-deep slices of both operands on a W_RING-stage ring that a
// producer warp fills by TMA (64 x 64 boxes, 128-byte swizzle, points past n
// read as zeros). A is the activation or g (K-major), B the packed weights:
// N-major for the forward (the descriptor's transpose bit), K-major for the
// chain's g W^T; no operand is transposed in software. The two blocks of a
// cluster take neighbouring 128-point tiles of the same columns, and each
// loads half of every weight stage and multicasts it to both, so the weights
// stream from L2 once per 256 points. A stage goes back to the producers
// once the consumers of both blocks have read it (16 arrivals, one per
// consumer warp of the cluster). Both epilogues write bf16 into a staging
// tile per warpgroup (64 x 64 boxes, 128-byte swizzle: conflict-free) and
// send it out by TMA stores, which clip rows past n and run on while the next
// tile's products do; the staging tiles take the room of a fourth stage.
// * forward, layer l: pre = inp W_l + b_l, inp = a_{l-1} (columns below H of
//   the reduction; slot (l-1) % slots of `acts`) and the encoding (the rest,
//   for the skip layer and all of layer 0). Epilogue: bias + ReLU -> bf16 into
//   a_l (or feat); the last layer's density tile (columns H .. H + 63) gives
//   the raw density, column H + its bias, in f32.
// * chain: a seed kernel writes the last layer's g = [feat > 0 ? g_feat : 0 |
//   g_dens | 0...] (bf16, [N, H + 128]) and its column sums (db); then layer
//   l = L-1 .. 0: gx = g_l W_l^T over the K_l inputs (the last layer's
//   reduction runs over H + 64 columns: its g holds g_dens in column H).
//   Epilogue: the a_{l-1} columns masked by a_{l-1} > 0 into g_{l-1} (bf16):
//   the producer brings the mask tile by TMA into the staging tiles while
//   the tile's products run (once the ring is primed and the last g has left
//   them), and g goes out from there, written over it. Each thread sums its
//   f32 g per column in registers over all its tiles (a launch keeps each
//   cluster on one column tile) and the block adds them to db_{l-1} once, at
//   its end. The skip layer's encoding columns are rounded to bf16 into denc;
//   layer 0's become bf16(gx) + denc, in bf16 (the twin's roundings).
// * dW: fused_trunk.cu's dW design in 256-column tiles (the last layer's 128
//   columns from H, the density column's, in one): a block per (layer, 128
//   input features, column tile, slice of the points), two consumer
//   warpgroups of 64 features running wgmma m64nNk16 with both operands
//   MN-major in shared memory (the point index is the reduction and neither
//   operand has it contiguous: the descriptors' transpose bits), fed by TMA
//   on a DW_RING-stage ring of 64-point chunks. The two blocks of a cluster
//   take neighbouring feature tiles and share each chunk of g by multicast.
//   Each slice of the points writes its own copy of dW, and
//   trunk_wide_dw_sum_kernel adds the copies into dw: no atomics.
// db is summed with f32 atomics in a run-dependent order, as in
// fused_trunk.cu.
// * checkpoint strides (fused_trunk.cu's header): the forward writes the
//   layers stride k stores into `acts` ([n_stored, N, H], layer l in slot
//   l / k) and the others into two scratch slots; at a stride other than 1 the
//   backward first refills every hidden layer into a transient [L-1, N, H]
//   (trunk_wide_remat): the stored ones copied, the others recomputed in
//   order by the forward's GEMM launches, so that the chain and dW read what
//   they read at stride 1.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BOX = 64 * 64 * 2;        // one 64 x 64 bf16 box, 128-byte swizzle
constexpr int TILE_N = 256;             // output columns of a full tile
constexpr int W_T = 128;                // points of a GEMM tile: two warpgroups of 64
constexpr int CLUSTER = 2;              // blocks of a cluster: neighbouring tiles, one weight stream
constexpr int W_THREADS = 384;          // two consumer warpgroups + a producer warpgroup (warp 8 loads)
constexpr int W_RING = 3;
constexpr int W_STAGE = 6 * BOX;        // A: a box per warpgroup; B: up to four 64-column boxes
constexpr int SLOT = TILE_N / 64 * BOX; // a warpgroup's [64 points x 256] staging tile
constexpr size_t W_SMEM =
    1024 + W_RING * W_STAGE + 2 * SLOT + 2 * TILE_N * sizeof(float) + (2 * W_RING + 2) * sizeof(uint64_t);
constexpr int SEED_ROWS = 256;          // rows of the seed kernel's block
constexpr int DW_PTS = 64;              // points of a dW chunk
constexpr int DW_RING = 4;
constexpr int DW_THREADS = 288;         // two consumer warpgroups + a producer warp
constexpr int DW_CLUSTER = 2;           // blocks of a dW cluster: two 128-feature tiles, one stream of g
constexpr int DW_STAGE = 6 * BOX;       // A: a [64 points x 64 features] box per warpgroup; B: up to four of g
constexpr size_t DW_SMEM = 1024 + DW_RING * DW_STAGE + 2 * DW_RING * sizeof(uint64_t);

enum { FWD = 0, CHAIN = 1 };

// the column tiles of [0, cm) in 256s with a 128 tail, then one tile of xw
// columns at cm (none when xw is 0)
__host__ __device__ __forceinline__ int col_tiles(int cm, int xw) { return (cm + TILE_N - 1) / TILE_N + (xw > 0); }
__host__ __device__ __forceinline__ void col_tile(int c, int cm, int xw, int& c0, int& nw) {
  c0 = TILE_N * c;
  if (c0 < cm) {
    nw = min(TILE_N, cm - c0);
  } else {
    c0 = cm;
    nw = xw;
  }
}

// byte offset of element (r, c) in a [64 x N] tile of 64 x 64 boxes with the
// 128-byte swizzle, the layout in which TMA moves a box
__device__ __forceinline__ uint32_t box_offset(int r, int c) {
  return (c >> 6) * BOX + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

struct GemmMaps {
  CUtensorMap a0;    // A below reduction index ka: [n, width] (the activation, or g)
  CUtensorMap a1;    // A from ka on: the encoding [n, KIN] (the forward)
  CUtensorMap b;     // the layer's weights: the hidden map or the last layer's (WeightMaps)
  CUtensorMap out;   // [n, H]: a_l or feat (the forward), g_{l-1} (the chain); TMA stores
  CUtensorMap mask;  // the chain: a_{l-1} [n, H], the ReLU' mask
};

// one layer's GEMM and its epilogue
struct GemmLayer {
  int n, K, ka;     // points; reduction depth (a multiple of 64); A from map a1 from ka on
  int kb0;          // the layer's first row in map b
  int cm, xw;       // column tiles (col_tiles): [0, cm) go to `out`, the one at cm elsewhere
  int H, kin;
  const bf16* bias;  // forward: b_l; dens: [n] (the density tile)
  float* dens;
  float* db;         // chain: db_{l-1}; denc [n, KIN] (the encoding tile)
  bf16* denc;
};

struct GemmRing {
  uint32_t ring;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int wg, wq, lane;
};

// acc = the warpgroup's 64 rows x NW columns of this tile over K, stages from the ring.
// `pending`: the chain's staging tiles, still read by the last tile's g stores; once the
// first products are issued, the warpgroup's storing thread waits for that read and hands
// the tiles back to the producer (mempty)
template <int MODE, int NW>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[NW / 2], int nks, int& t, const GemmRing& r,
                                              uint64_t*& pending) {
  auto products = [&](int scale) {
    const int s = t % W_RING;
    mbar_wait(r.full + s, (t / W_RING) & 1);
    const uint32_t st = r.ring + s * W_STAGE, a = st + r.wg * BOX, b = st + 2 * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (MODE == FWD)
        wgmma_ss<NW, 0, 1>(acc, desc_sw128(a + 32 * kk), desc_mn_sw128(b + 2048 * kk, BOX), scale | (kk != 0));
      else
        wgmma_ss<NW, 0, 0>(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), scale | (kk != 0));
    }
    wgmma_commit();
    ++t;
  };
  // lanes 0 and 1 of each consumer warp release a read stage in blocks 0 and 1 of the cluster
  auto release = [&](int u) { mbar_arrive_cluster(r.empty + u % W_RING, r.lane, r.lane < CLUSTER); };
  fence_operand(acc);
  products(0);
  if (pending != nullptr) {
    if (r.wq == 0 && r.lane == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(pending);
    }
    pending = nullptr;
  }
  for (int ks = 1; ks < nks; ++ks) {
    products(1);
    wgmma_wait<1>();
    release(t - 2);
  }
  wgmma_wait<0>();
  release(t - 1);
  fence_operand(acc);
}

// this warpgroup's part of the epilogue: rows row0 .. row0 + 64 of the tile
struct Epi {
  long row0;
  int c0;
  unsigned char* slot;  // the warpgroup's staging tile
  float* dbs;           // the chain: TILE_N column sums, zero but while flush_db adds them
  int wg, wq, lane;
};

// the staging tile's boxes to `map` at (c0, row0) by TMA stores (rows past n are clipped)
template <int NW>
__device__ __forceinline__ void store_slot(const CUtensorMap* map, const Epi& e, int n) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar(1 + e.wg, 128);
  if (e.wq == 0 && e.lane == 0 && e.row0 < n) {
#pragma unroll
    for (int i = 0; i < NW / 64; ++i) tma_store_2d(map, e.c0 + 64 * i, (int)e.row0, e.slot + i * BOX);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// forward: bias + ReLU -> bf16 through the staging tile to a_l / feat; the density tile's column H
template <int NW>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[NW / 2], const GemmMaps& maps, const GemmLayer& g,
                                             const Epi& e) {
  const int q = e.lane & 3, r_lo = e.wq * 16 + (e.lane >> 2), r_hi = r_lo + 8;
  if (e.c0 >= g.H) {  // the last layer's density tile: column H, no ReLU
    const float bd = __bfloat162float(g.bias[g.H]);
    if (q == 0 && e.row0 + r_lo < g.n) g.dens[e.row0 + r_lo] = acc[0] + bd;
    if (q == 0 && e.row0 + r_hi < g.n) g.dens[e.row0 + r_hi] = acc[2] + bd;
    return;
  }
  if (e.wq == 0 && e.lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the last stores
  named_bar(1 + e.wg, 128);
  const __nv_bfloat162* bl = reinterpret_cast<const __nv_bfloat162*>(g.bias + e.c0);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 bb = __bfloat1622float2(bl[c >> 1]);
    *reinterpret_cast<uint32_t*>(e.slot + box_offset(r_lo, c)) =
        pack_bf16(fmaxf(acc[4 * j] + bb.x, 0.f), fmaxf(acc[4 * j + 1] + bb.y, 0.f));
    *reinterpret_cast<uint32_t*>(e.slot + box_offset(r_hi, c)) =
        pack_bf16(fmaxf(acc[4 * j + 2] + bb.x, 0.f), fmaxf(acc[4 * j + 3] + bb.y, 0.f));
  }
  store_slot<NW>(&maps.out, e, g.n);
}

// chain: the encoding tile straight to denc; an a_{l-1} tile masked by the
// activation the producer brought into the staging tile (`mfull`, load `m`), g
// written over it and stored by TMA, its f32 column sums added to dbr; the tile
// goes back to the producer (`mempty`) once the stores have read it
template <int NW>
__device__ __forceinline__ void chain_epilogue(const float (&acc)[NW / 2], const GemmMaps& maps, const GemmLayer& g,
                                               const Epi& e, uint64_t* mfull, uint64_t* mempty, int& m,
                                               float (&dbr)[TILE_N / 4], uint64_t*& pending) {
  const int q = e.lane & 3, r_lo = e.wq * 16 + (e.lane >> 2), r_hi = r_lo + 8;
  const bool v_lo = e.row0 + r_lo < g.n, v_hi = e.row0 + r_hi < g.n;
  if (e.c0 >= g.cm) {
    // encoding inputs: denc = bf16(gx) (the skip layer), or bf16(gx) + denc in bf16 (layer 0)
    uint32_t* d_lo = reinterpret_cast<uint32_t*>(g.denc + (e.row0 + r_lo) * g.kin + (e.c0 - g.cm));
    uint32_t* d_hi = reinterpret_cast<uint32_t*>(g.denc + (e.row0 + r_hi) * g.kin + (e.c0 - g.cm));
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = (8 * j + 2 * q) >> 1;
      uint32_t lo = pack_bf16(acc[4 * j], acc[4 * j + 1]), hi = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      if (g.cm == 0) {  // layer 0: its inputs are the encoding alone
        const float2 xl = unpack_bf16(lo), xh = unpack_bf16(hi);
        const float2 el = unpack_bf16(v_lo ? d_lo[c] : 0u), eh = unpack_bf16(v_hi ? d_hi[c] : 0u);
        lo = pack_bf16(xl.x + el.x, xl.y + el.y);
        hi = pack_bf16(xh.x + eh.x, xh.y + eh.y);
      }
      if (v_lo) d_lo[c] = lo;
      if (v_hi) d_hi[c] = hi;
    }
    return;
  }
  if constexpr (NW >= 128) {
    // g_{l-1} = a_{l-1} > 0 ? gx : 0, in place over the mask (rows past n: a zero mask); the
    // thread's two rows summed per column into dbr[2 j + e], column 8 j + 2 q + e of the tile
    mbar_wait(mfull, m & 1);
    ++m;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = 8 * j + 2 * q;
      uint32_t* p_lo = reinterpret_cast<uint32_t*>(e.slot + box_offset(r_lo, c));
      uint32_t* p_hi = reinterpret_cast<uint32_t*>(e.slot + box_offset(r_hi, c));
      const float2 ml = unpack_bf16(v_lo ? *p_lo : 0u), mh = unpack_bf16(v_hi ? *p_hi : 0u);
      const float v0 = ml.x > 0.f ? acc[4 * j] : 0.f, v1 = ml.y > 0.f ? acc[4 * j + 1] : 0.f;
      const float v2 = mh.x > 0.f ? acc[4 * j + 2] : 0.f, v3 = mh.y > 0.f ? acc[4 * j + 3] : 0.f;
      *p_lo = pack_bf16(v0, v1);
      *p_hi = pack_bf16(v2, v3);
      dbr[2 * j] += v0 + v2;
      dbr[2 * j + 1] += v1 + v3;
    }
    store_slot<NW>(&maps.out, e, g.n);
    pending = mempty;  // handed back during the next tile's first products
  }
}

// the warpgroup's column sums of its tiles of columns c0 .. c0 + nw (each thread's in dbr)
// into db, one atomic per column; dbr is zero again after
__device__ __forceinline__ void flush_db(float (&dbr)[TILE_N / 4], float* dbs, float* db, int c0, int nw, int wg,
                                         int wq, int lane) {
#pragma unroll
  for (int h = 0; h < TILE_N / 128; ++h) {
    if (128 * h >= nw) break;
    float cs[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      cs[i] = dbr[32 * h + i];
      dbr[32 * h + i] = 0.f;
    }
    colsum32_add(dbs, 128 * h, cs, lane);
  }
  named_bar(1 + wg, 128);
  for (int i = wq * 32 + lane; i < nw; i += 128) {
    atomicAdd(db + c0 + i, dbs[i]);
    dbs[i] = 0.f;
  }
  named_bar(1 + wg, 128);
}

template <int MODE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(W_THREADS, 1)
    trunk_wide_gemm_kernel(const __grid_constant__ GemmMaps maps, const GemmLayer g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* slots = base + W_RING * W_STAGE;                   // [wg] staging tiles
  float* dbs = reinterpret_cast<float*>(slots + 2 * SLOT);          // [wg][TILE_N]
  uint64_t* full = reinterpret_cast<uint64_t*>(dbs + 2 * TILE_N);
  uint64_t* empty = full + W_RING;
  uint64_t* mfull = empty + W_RING;   // the chain: the mask tiles are in the staging tiles
  uint64_t* mempty = mfull + 1;       // ... and the staging tiles are free again

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank(), cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  const int ctiles = col_tiles(g.cm, g.xw);
  const int items = (g.n + CLUSTER * W_T - 1) / (CLUSTER * W_T) * ctiles;  // (point pair, column tile)
  const int nks = g.K / 64;
  if (tid == 0) {
    for (int s = 0; s < W_RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CLUSTER * 8);  // one arrival per consumer warp of the cluster
    }
    mbar_init(mfull, 1);
    mbar_init(mempty, 2);  // one per consumer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * TILE_N; i += W_THREADS) dbs[i] = 0.f;
  cluster_sync();  // the peer's barriers are initialised before any multicast or remote arrival

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    // 128 x 40 + 256 x 232 = 384 x 168, the registers the block was launched with
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int t = 0, m = 0;
      for (int it = cluster; it < items; it += clusters) {
        int c0, nw;
        col_tile(it % ctiles, g.cm, g.xw, c0, nw);
        const int m0 = (CLUSTER * (it / ctiles) + rank) * W_T;
        const int a_boxes = m0 + 64 < g.n ? 2 : (m0 < g.n ? 1 : 0);  // no box wholly past n
        const uint32_t bytes = (a_boxes + nw / 64) * BOX;  // this block's A, and all of B (half from the peer)
        const bool masked = MODE == CHAIN && c0 < g.cm;
        for (int ks = 0; ks < nks; ++ks, ++t) {
          const int s = t % W_RING, k = 64 * ks;
          unsigned char* st = base + s * W_STAGE;
          mbar_wait(empty + s, ((t / W_RING) & 1) ^ 1);
          mbar_expect_tx(full + s, bytes);
          const CUtensorMap* am = k < g.ka ? &maps.a0 : &maps.a1;
          const int ax = k < g.ka ? k : k - g.ka;
          for (int h = 0; h < a_boxes; ++h) tma_load_2d(st + h * BOX, am, ax, m0 + 64 * h, full + s);
          for (int i = rank; i < nw / 64; i += CLUSTER) {
            if (MODE == FWD)  // [64 inputs x 64 outputs]: rows k of the layer, columns c0 + 64 i
              tma_load_2d_mc(st + (2 + i) * BOX, &maps.b, c0 + 64 * i, g.kb0 + k, full + s, (1 << CLUSTER) - 1);
            else  // [64 inputs x 64 outputs]: rows c0 + 64 i of the layer, columns k
              tma_load_2d_mc(st + (2 + i) * BOX, &maps.b, k, g.kb0 + c0 + 64 * i, full + s, (1 << CLUSTER) - 1);
          }
          if (masked && ks == min(nks, W_RING) - 1) {
            // the chain's mask tile, once the ring is primed and the last tile's g has left the staging tiles
            mbar_wait(mempty, (m & 1) ^ 1);
            mbar_expect_tx(mfull, a_boxes * nw / 64 * BOX);
            for (int h = 0; h < a_boxes; ++h)
              for (int i = 0; i < nw / 64; ++i)
                tma_load_2d(slots + h * SLOT + i * BOX, &maps.mask, c0 + 64 * i, m0 + 64 * h, mfull);
            ++m;
          }
        }
      }
      // the block leaves only after every release of its stages, its peer's included, has arrived
      for (int i = 0; i < W_RING; ++i, ++t) mbar_wait(empty + t % W_RING, ((t / W_RING) & 1) ^ 1);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wq = warp & 3;
  const GemmRing r{smem_u32(base), full, empty, wg, wq, lane};
  int t = 0, m = 0;
  int db_c0 = -1, db_nw = 0;  // the chain: the columns whose sums dbr holds (the launch keeps them one tile)
  float dbr[TILE_N / 4];
#pragma unroll
  for (int i = 0; i < TILE_N / 4; ++i) dbr[i] = 0.f;
  uint64_t* pending = nullptr;
  for (int it = cluster; it < items; it += clusters) {
    int c0, nw;
    col_tile(it % ctiles, g.cm, g.xw, c0, nw);
    const Epi e{(long)(CLUSTER * (it / ctiles) + rank) * W_T + 64 * wg, c0, slots + wg * SLOT, dbs + wg * TILE_N,
                wg, wq, lane};
    if (MODE == CHAIN && c0 < g.cm && c0 != db_c0) {
      if (db_c0 >= 0) flush_db(dbr, e.dbs, g.db, db_c0, db_nw, wg, wq, lane);
      db_c0 = c0;
      db_nw = nw;
    }
    // a branch between whole tiles: no product is in flight across it
    if (nw == TILE_N) {
      float acc[TILE_N / 2];
      gemm_mainloop<MODE, TILE_N>(acc, nks, t, r, pending);
      if constexpr (MODE == FWD)
        fwd_epilogue<TILE_N>(acc, maps, g, e);
      else
        chain_epilogue<TILE_N>(acc, maps, g, e, mfull, mempty, m, dbr, pending);
    } else if (nw == 128) {
      float acc[64];
      gemm_mainloop<MODE, 128>(acc, nks, t, r, pending);
      if constexpr (MODE == FWD)
        fwd_epilogue<128>(acc, maps, g, e);
      else
        chain_epilogue<128>(acc, maps, g, e, mfull, mempty, m, dbr, pending);
    } else {
      float acc[32];
      gemm_mainloop<MODE, 64>(acc, nks, t, r, pending);
      if constexpr (MODE == FWD)
        fwd_epilogue<64>(acc, maps, g, e);
      else
        chain_epilogue<64>(acc, maps, g, e, mfull, mempty, m, dbr, pending);
    }
  }
  if (db_c0 >= 0) flush_db(dbr, dbs + wg * TILE_N, g.db, db_c0, db_nw, wg, wq, lane);
  if (wq == 0 && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the stores are written
}

// the last layer's g [n, H + 128] = [feat > 0 ? g_feat : 0 | g_dens | 0...] and
// its column sums into db_last. A block takes 256 columns (32 vectors of 8, one
// 16-byte access each) of SEED_ROWS rows, a warp a row at a time
__global__ void __launch_bounds__(256) trunk_wide_seed_kernel(const bf16* __restrict__ gfeat,
                                                              const bf16* __restrict__ gdens,
                                                              const bf16* __restrict__ feat, bf16* __restrict__ glast,
                                                              float* __restrict__ db_last, int n, int H) {
  __shared__ float part[8][256];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int NO = H + DENS_PAD, v = blockIdx.x * 32 + tx;  // columns 8 v .. 8 v + 7
  const int r0 = blockIdx.y * SEED_ROWS, r1 = min(n, r0 + SEED_ROWS);
  float sum[8] = {};
  if (8 * v < NO) {
    for (int r = r0 + ty; r < r1; r += 8) {
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (8 * v < H) {
        const uint4 g = *reinterpret_cast<const uint4*>(gfeat + (long)r * H + 8 * v);
        const uint4 f = *reinterpret_cast<const uint4*>(feat + (long)r * H + 8 * v);
        float2 x = unpack_bf16(g.x), y = unpack_bf16(g.y), z = unpack_bf16(g.z), w = unpack_bf16(g.w);
        o = make_uint4(mask_pack(x.x, x.y, f.x), mask_pack(y.x, y.y, f.y), mask_pack(z.x, z.y, f.z),
                       mask_pack(w.x, w.y, f.w));
      } else if (8 * v == H) {
        o.x = *reinterpret_cast<const uint16_t*>(gdens + r);
      }
      *reinterpret_cast<uint4*>(glast + (long)r * NO + 8 * v) = o;
      const uint32_t words[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 e = unpack_bf16(words[i]);
        sum[2 * i] += e.x;
        sum[2 * i + 1] += e.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[ty][8 * tx + i] = sum[i];
  __syncthreads();
  const int col = blockIdx.x * 256 + threadIdx.x;
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) t += part[i][threadIdx.x];
  if (col <= H) atomicAdd(db_last + col, t);
}

// ------------------------------------------------------------------------ dW

struct WideDwMaps {
  CUtensorMap acts;   // [L-1][n][H], boxes of 64 features x 64 points
  CUtensorMap enc;    // [1][n][KIN]
  CUtensorMap g;      // [L-1][n][H]: gsave's g_0 .. g_{L-2}
  CUtensorMap glast;  // [1][n][H + 128]: the last layer's g
};

// a layer's dW column tiles (the last layer's 128 columns past H in one tile:
// the density column and zeros) and its pairs of 128-feature tiles
__host__ __device__ __forceinline__ int dw_col_tiles(int l, int L, int H) {
  return col_tiles(H, l == L - 1 ? DENS_PAD : 0);
}
__host__ __device__ __forceinline__ int dw_layer_pairs(int l, int L, int skip, int H, int KIN) {
  return ((layer_in(l, skip, H, KIN) + 127) / 128 + DW_CLUSTER - 1) / DW_CLUSTER * dw_col_tiles(l, L, H);
}

// warpgroup wg's 64 features x NW columns of the block's tile over its chunks,
// into `part` (row stride NO; null: past the tile's features)
template <int NW>
__device__ __forceinline__ void dw_tile(unsigned char* base, uint64_t* full, uint64_t* empty, int nch, int wg,
                                        float* part, int NO, int c0, int wq, int lane) {
  float acc[NW / 2];
  auto products = [&](int c) {
    const int s = c % DW_RING;
    mbar_wait(full + s, (c / DW_RING) & 1);
    const uint32_t st = smem_u32(base + s * DW_STAGE), a = st + wg * BOX, b = st + 2 * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_PTS / 16; ++kk)
      wgmma_ss<NW, 1, 1>(acc, desc_mn_sw128(a + 2048 * kk, BOX), desc_mn_sw128(b + 2048 * kk, BOX), (c | kk) != 0);
    wgmma_commit();
  };
  // lanes 0 and 1 of each consumer warp release a read chunk in blocks 0 and 1 of the cluster
  auto release = [&](int c) { mbar_arrive_cluster(empty + c % DW_RING, lane, lane < DW_CLUSTER); };
  fence_operand(acc);
  products(0);
  for (int c = 1; c < nch; ++c) {
    products(c);
    wgmma_wait<1>();  // chunk c - 1 is read
    release(c - 1);
  }
  wgmma_wait<0>();
  fence_operand(acc);
  release(nch - 1);
  if (part == nullptr) return;
  const int r_lo = wq * 16 + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = c0 + 8 * j + 2 * q;
    *reinterpret_cast<float2*>(part + (long)r_lo * NO + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (long)(r_lo + 8) * NO + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// the blocks of a cluster take two neighbouring 128-feature tiles of one column
// tile and slice of the points: each loads its own features and half of each
// chunk of g, multicast to both. A block writes its dW tile over the slice into
// `part` (slice blockIdx.y's copy of the packed dW); trunk_wide_dw_sum_kernel
// adds the slices
__global__ void __cluster_dims__(DW_CLUSTER, 1, 1) __launch_bounds__(DW_THREADS, 1)
    trunk_wide_dw_kernel(const __grid_constant__ WideDwMaps maps, float* __restrict__ part, long wsize, int n, int L,
                         int skip, int H, int KIN, int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + DW_RING * DW_STAGE);
  uint64_t* empty = full + DW_RING;

  int pair = blockIdx.x / DW_CLUSTER, l = 0;
  for (; l < L; ++l) {
    const int np = dw_layer_pairs(l, L, skip, H, KIN);
    if (pair < np) break;
    pair -= np;
  }
  const long p_begin = (long)blockIdx.y * rows_per_split;
  const long p_end = min((long)n, p_begin + rows_per_split);
  const int nch = p_end > p_begin ? (int)((p_end - p_begin + DW_PTS - 1) / DW_PTS) : 0;
  if (l == L || nch == 0) return;  // the same for both blocks of the cluster
  const int rank = (int)cluster_rank();
  const bool last = l == L - 1;
  const int K = layer_in(l, skip, H, KIN), NO = layer_out(l, L, H), ct = dw_col_tiles(l, L, H);
  const int k0 = (pair / ct * DW_CLUSTER + rank) * 128, rows = max(0, min(128, K - k0));  // 0: a tile past K
  int c0, nw;
  col_tile(pair % ct, H, last ? DENS_PAD : 0, c0, nw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < DW_RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, DW_CLUSTER * 8);  // one arrival per consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (warp == 8) {
    // producer: chunk c is the layer input's [64 points x 64 features] box of each
    // warpgroup (enc, or a stored activation) and nw / 64 64-column boxes of g_l
    if (lane == 0) {
      const uint32_t bytes = (rows / 64 + nw / 64) * BOX;
      int c = 0;
      for (; c < nch; ++c) {
        const int s = c % DW_RING;
        unsigned char* st = base + s * DW_STAGE;
        const int p = (int)(p_begin + (long)c * DW_PTS);
        mbar_wait(empty + s, ((c / DW_RING) & 1) ^ 1);
        mbar_expect_tx(full + s, bytes);
        for (int h = 0; h < rows / 64; ++h) {
          const int k = k0 + 64 * h;
          if (l == 0 || k >= H)
            tma_load(st + h * BOX, &maps.enc, k - (l == 0 ? 0 : H), p, 0, full + s);
          else
            tma_load(st + h * BOX, &maps.acts, k, p, l - 1, full + s);
        }
        for (int i = rank; i < nw / 64; i += DW_CLUSTER) {
          if (last)
            tma_load_3d_mc(st + (2 + i) * BOX, &maps.glast, c0 + 64 * i, p, 0, full + s, (1 << DW_CLUSTER) - 1);
          else
            tma_load_3d_mc(st + (2 + i) * BOX, &maps.g, c0 + 64 * i, p, l, full + s, (1 << DW_CLUSTER) - 1);
        }
      }
      // the block leaves only after every release of its chunks, its peer's included, has arrived
      for (int i = 0; i < DW_RING; ++i, ++c) mbar_wait(empty + c % DW_RING, ((c / DW_RING) & 1) ^ 1);
    }
    return;
  }

  // consumers: warpgroup wg owns input features k0 + 64 wg .. A warpgroup past
  // its tile's features multiplies whatever its A slot holds and drops the
  // result: no branch around the products, which ptxas would serialize.
  const int wg = warp >> 2, wq = warp & 3;
  float* out = 64 * wg < rows ? part + blockIdx.y * wsize + w_offset(l, L, skip, H, KIN) + (long)(k0 + 64 * wg) * NO
                              : nullptr;
  if (nw == TILE_N)
    dw_tile<TILE_N>(base, full, empty, nch, wg, out, NO, c0, wq, lane);
  else if (nw == 128)
    dw_tile<128>(base, full, empty, nch, wg, out, NO, c0, wq, lane);
  else
    dw_tile<64>(base, full, empty, nch, wg, out, NO, c0, wq, lane);
}

// dw[i] += the sum of the slices' part[s][i], four at a time
__global__ void __launch_bounds__(256) trunk_wide_dw_sum_kernel(const float4* __restrict__ part,
                                                                float4* __restrict__ dw, long n4, int splits) {
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n4; i += (long)gridDim.x * 256) {
    float4 a = dw[i];
    for (int s = 0; s < splits; ++s) {
      const float4 b = part[s * n4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    dw[i] = a;
  }
}

bool wide_ok(int H, int KIN) { return H >= 384 && H % 128 == 0 && (KIN == 64 || KIN == 128); }


template <int MODE>
int gemm_launch(const GemmMaps& maps, const GemmLayer& g, int clusters, cudaStream_t stream) {
  const int ctiles = col_tiles(g.cm, g.xw), items = (g.n + CLUSTER * W_T - 1) / (CLUSTER * W_T) * ctiles;
  cudaError_t e = cudaFuncSetAttribute(trunk_wide_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)W_SMEM);
  if (e != cudaSuccess) return (int)e;
  // the chain's clusters, a multiple of the column tiles where there are enough, each keep one
  // column tile and so add their column sums to db once
  int grid = std::min(items, clusters);
  if (MODE == CHAIN && grid > ctiles) grid -= grid % ctiles;
  trunk_wide_gemm_kernel<MODE><<<CLUSTER * grid, W_THREADS, W_SMEM, stream>>>(maps, g);
  return (int)cudaGetLastError();
}

EncodeTiled encoder() {
  static EncodeTiled encode = encode_tiled();
  return encode;
}

}  // namespace

// ------------------------------------------------------------------ C interface
// Each function launches on `stream`, does not synchronise, and returns the
// cudaError_t of its launches (0 on success): cudaErrorInvalidValue for an H
// that is not a multiple of 128 from 384, a KIN other than 64 or 128, no
// points, or a dW plan (cluster pairs, point slices) other than the one
// `fused_mlp.wide_plan` gives.

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// acts: the hidden layers that checkpoint stride `ckpt` stores ([n_stored, n, H]: all L-1 at
// stride 1, null when none are stored); the others go to `scratch`, two [n, H] slots (layer l to
// slot l % 2; null at stride 1). `clusters`: the most clusters of two blocks a layer's persistent
// launch takes
int trunk_wide_fwd(const void* enc, const void* w, const void* b, void* feat, void* dens, void* acts, void* scratch,
                   int n, int L, int skip, int H, int kin, int ckpt, int clusters, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (!wide_ok(H, kin) || clusters < 1 || n < 1 || (acts != nullptr) != (ckpt_count(L, ckpt) > 0) ||
      (scratch == nullptr && ckpt_count(L, ckpt) < L - 1))
    return (int)cudaErrorInvalidValue;
  // where hidden layer l goes
  auto act = [&](int l) {
    return ckpt_stored(l, ckpt) ? (bf16*)acts + (long)(l / ckpt) * n * H : (bf16*)scratch + (long)(l % 2) * n * H;
  };
  WeightMaps wm;
  GemmMaps maps;
  int err = make_weight_maps(encode, &wm, w, L, skip, H, kin);
  if (!err) err = make_map(encode, &maps.a1, enc, 2, {(cuuint64_t)kin, (cuuint64_t)n, 1}, {64, 64, 1}, true);
  if (err) return err;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const void* prev = l == 0 ? enc : act(l - 1);
    err = make_map(encode, &maps.a0, prev, 2, {(cuuint64_t)(l == 0 ? kin : H), (cuuint64_t)n, 1}, {64, 64, 1}, true);
    if (err) return err;
    maps.b = last ? wm.last : wm.hidden;
    err = make_map(encode, &maps.out, last ? feat : act(l), 2, {(cuuint64_t)H, (cuuint64_t)n, 1}, {64, 64, 1}, true);
    if (err) return err;
    maps.mask = maps.out;  // not read by the forward
    GemmLayer g = {};
    g.n = n;
    g.K = layer_in(l, skip, H, kin);
    g.ka = l == 0 ? 0 : H;
    g.kb0 = last ? 0 : (int)(w_offset(l, L, skip, H, kin) / H);
    g.cm = H;
    g.xw = last ? 64 : 0;
    g.H = H;
    g.kin = kin;
    g.bias = (const bf16*)b + (long)l * H;
    g.dens = (float*)dens;
    err = gemm_launch<FWD>(maps, g, clusters, (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}

// every hidden layer into acts [L-1, n, H] (the backward's buffer at a stride other than 1): a
// layer that stride `ckpt` stored is copied from `stored_acts` ([n_stored, n, H], null when
// none are), the others recomputed in order, each by the forward's GEMM launch from the layer before
// it in `acts` (or the encoding), so bit for bit the forward's
int trunk_wide_remat(const void* enc, const void* w, const void* b, const void* stored_acts, void* acts, int n, int L,
                     int skip, int H, int kin, int ckpt, int clusters, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (!wide_ok(H, kin) || clusters < 1 || n < 1 || acts == nullptr ||
      (stored_acts != nullptr) != (ckpt_count(L, ckpt) > 0))
    return (int)cudaErrorInvalidValue;
  bf16* act = (bf16*)acts;
  const size_t layer_bytes = (size_t)n * H * sizeof(bf16);
  WeightMaps wm;
  GemmMaps maps;
  int err = make_weight_maps(encode, &wm, w, L, skip, H, kin);
  if (!err) err = make_map(encode, &maps.a1, enc, 2, {(cuuint64_t)kin, (cuuint64_t)n, 1}, {64, 64, 1}, true);
  if (err) return err;
  maps.b = wm.hidden;
  for (int l = 0; l < L - 1; ++l) {
    if (ckpt_stored(l, ckpt)) {
      err = (int)cudaMemcpyAsync(act + (long)l * n * H, (const bf16*)stored_acts + (long)(l / ckpt) * n * H,
                                 layer_bytes, cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
      if (err) return err;
      continue;
    }
    const void* prev = l == 0 ? enc : act + (long)(l - 1) * n * H;
    err = make_map(encode, &maps.a0, prev, 2, {(cuuint64_t)(l == 0 ? kin : H), (cuuint64_t)n, 1}, {64, 64, 1}, true);
    if (!err)
      err = make_map(encode, &maps.out, act + (long)l * n * H, 2, {(cuuint64_t)H, (cuuint64_t)n, 1}, {64, 64, 1}, true);
    if (err) return err;
    maps.mask = maps.out;  // not read by the forward
    GemmLayer g = {};
    g.n = n;
    g.K = layer_in(l, skip, H, kin);
    g.ka = l == 0 ? 0 : H;
    g.kb0 = (int)(w_offset(l, L, skip, H, kin) / H);
    g.cm = H;
    g.H = H;
    g.kin = kin;
    g.bias = (const bf16*)b + (long)l * H;
    err = gemm_launch<FWD>(maps, g, clusters, (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}

// gsave: g_0 .. g_{L-2} as [n, H] each, then the last layer's g [n, H + 128]
int trunk_wide_bwd_chain(const void* gfeat, const void* gdens, const void* feat, const void* acts, const void* w,
                         void* denc, void* gsave, void* db, int n, int L, int skip, int H, int kin, int clusters,
                         void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (!wide_ok(H, kin) || clusters < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const bf16* act = (const bf16*)acts;
  bf16* G = (bf16*)gsave;
  float* db_ = (float*)db;
  bf16* glast = G + (long)(L - 1) * n * H;
  WeightMaps wm;
  int err = make_weight_maps(encode, &wm, w, L, skip, H, kin);
  if (err) return err;
  trunk_wide_seed_kernel<<<dim3((H + DENS_PAD + 255) / 256, (n + SEED_ROWS - 1) / SEED_ROWS), 256, 0,
                           (cudaStream_t)stream>>>(
      (const bf16*)gfeat, (const bf16*)gdens, (const bf16*)feat, glast, db_ + (long)(L - 1) * H, n, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  GemmMaps maps;
  for (int l = L - 1; l >= 0; --l) {
    const bool last = l == L - 1;
    err = last ? make_map(encode, &maps.a0, glast, 2, {(cuuint64_t)(H + DENS_PAD), (cuuint64_t)n, 1}, {64, 64, 1}, true)
               : make_map(encode, &maps.a0, G + (long)l * n * H, 2, {(cuuint64_t)H, (cuuint64_t)n, 1}, {64, 64, 1},
                          true);
    if (err) return err;
    maps.a1 = maps.a0;  // g is all of A
    maps.b = last ? wm.last : wm.hidden;
    maps.out = maps.mask = maps.a0;  // layer 0: neither is read
    if (l > 0) {
      err = make_map(encode, &maps.out, G + (long)(l - 1) * n * H, 2, {(cuuint64_t)H, (cuuint64_t)n, 1}, {64, 64, 1},
                     true);
      if (!err)
        err = make_map(encode, &maps.mask, act + (long)(l - 1) * n * H, 2, {(cuuint64_t)H, (cuuint64_t)n, 1},
                       {64, 64, 1}, true);
      if (err) return err;
    }
    GemmLayer g = {};
    g.n = n;
    g.K = last ? H + 64 : H;  // the last layer's g: columns H + 1 .. are zero
    g.ka = g.K;
    g.kb0 = last ? 0 : (int)(w_offset(l, L, skip, H, kin) / H);
    g.cm = l > 0 ? H : 0;
    g.xw = l == 0 || l == skip ? kin : 0;
    g.H = H;
    g.kin = kin;
    if (l > 0) g.db = db_ + (long)(l - 1) * H;
    g.denc = (bf16*)denc;
    err = gemm_launch<CHAIN>(maps, g, clusters, (cudaStream_t)stream);
    if (err) return err;
  }
  return 0;
}

// `pairs`: the dW clusters along x, every layer's pairs of 128-feature tiles times its column
// tiles; `splits` slices of `rows_per_split` points along y, each written to its copy of dW in
// `part` ([splits][w.numel()] f32 scratch), then added to dw
int trunk_wide_bwd_dw(const void* enc, const void* acts, const void* gsave, void* part, void* dw, int n, int L,
                      int skip, int H, int kin, int pairs, int splits, int rows_per_split, void* stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (!wide_ok(H, kin) || n < 1) return (int)cudaErrorInvalidValue;
  int total = 0;
  for (int l = 0; l < L; ++l) total += dw_layer_pairs(l, L, skip, H, kin);
  if (pairs != total || splits < 1 || rows_per_split % DW_PTS != 0 || (long)splits * rows_per_split < n ||
      (long)(splits - 1) * rows_per_split >= n)
    return (int)cudaErrorInvalidValue;
  const bf16* G = (const bf16*)gsave;
  const cuuint64_t N = (cuuint64_t)n;
  WideDwMaps maps;
  int err = make_map(encode, &maps.acts, acts, 3, {(cuuint64_t)H, N, (cuuint64_t)(L - 1)}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.enc, enc, 3, {(cuuint64_t)kin, N, 1}, {64, DW_PTS, 1}, true);
  if (!err) err = make_map(encode, &maps.g, G, 3, {(cuuint64_t)H, N, (cuuint64_t)(L - 1)}, {64, DW_PTS, 1}, true);
  if (!err)
    err = make_map(encode, &maps.glast, G + (long)(L - 1) * n * H, 3, {(cuuint64_t)(H + DENS_PAD), N, 1},
                   {64, DW_PTS, 1}, true);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(trunk_wide_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long wsize = w_offset(L, L, skip, H, kin);  // the packed weights' elements, a multiple of 4
  trunk_wide_dw_kernel<<<dim3(DW_CLUSTER * pairs, splits), DW_THREADS, DW_SMEM, (cudaStream_t)stream>>>(
      maps, (float*)part, wsize, n, L, skip, H, kin, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long n4 = wsize / 4;
  trunk_wide_dw_sum_kernel<<<(unsigned)std::min(4096L, (n4 + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float4*)part, (float4*)dw, n4, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
