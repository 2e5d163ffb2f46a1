// Fused scene-NeRF trunk for Hopper (sm_90a), widths H >= 384: forward,
// backward chain and dW.
//
// Replaces the Pallas TPU kernels `_trunk_fwd_call` and `_trunk_bwd_call` of
// poseprobe_tpu/ops/pallas/fused_mlp.py for the trunk widths that
// fused_trunk.cu does not take: the reference takes any uniform width that
// is a multiple of 128, and one m64nH wgmma accumulator of H / 2 registers a
// thread does not fit beside a register-resident activation from H = 384 on.
// The Python side (poseprobe_tpu_torch/ops/fused_mlp.py) packs the weights
// in the layout fused_trunk.cu describes (K_l = KIN, H + KIN or H; NO_l = H,
// or H + 128 for the last layer, columns [feat | density | 0...]) and holds
// the plain twin these kernels are tested against.
//
// What bounds it: at 8 x 512 with a 64-wide input the trunk is 1.90 M
// multiply-adds a point, 1.5 ms of the bf16 tensor-core peak at 393,216
// points for the forward and twice that for the backward: operations, not
// bytes. This family is the simple one: each layer is one launch of a tiled
// GEMM with mma.sync m16n8k16 (bf16 in, f32 accumulate), 128 x 128 output
// tiles over 8 warps of 64 x 32, 32-deep slices of both operands staged in
// shared memory (double-buffered through registers; an operand whose
// reduction index is not contiguous in memory is transposed on its way in),
// and the layer's epilogue fused into the GEMM's. The activations go through
// device memory between layers (the stored activations, or two scratch slots
// when none are stored), so no width is too large.
// * forward, layer l: pre = inp W_l + b_l over [points x NO_l], inp = the
//   activation a_{l-1} and, for the skip layer (and all of layer 0), the
//   encoding; epilogue ReLU -> bf16 into a_l, or, for the last layer, feat
//   and the raw density (column H, no ReLU). The last layer runs H + 1 of its
//   columns.
// * chain: a seed kernel writes the last layer's g = [feat > 0 ? g_feat : 0 |
//   g_dens | 0...] (bf16, [N, H + 128]) and its column sums (db); then layer
//   l = L-1 .. 0: gx = g_l W_l^T over [points x K_l], epilogue: the columns
//   of a_{l-1} masked by a_{l-1} > 0 into g_{l-1} (bf16, the f32 values summed
//   into db_{l-1}), the skip layer's encoding columns rounded to bf16 into
//   denc, layer 0's columns bf16(gx) + that, in bf16 (the twin's roundings).
// * dW, layer l: dW_l += inp^T g_l over [K_l x NO_l] (the last layer's
//   density column included), the points split over blocks, added with f32
//   atomics.
// db and dW are summed with f32 atomics in a run-dependent order, as in
// fused_trunk.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DENS_PAD = 128;
constexpr int BM = 128, BN = 128, BK = 32;  // output tile and reduction slice
constexpr int LDS = BK + 8;                 // shared row stride (elements): fragment loads on distinct banks
constexpr int THREADS = 256;                // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int SEED_ROWS = 256;              // rows of the seed kernel's block

__host__ __device__ __forceinline__ int layer_in(int l, int skip, int H, int KIN) {
  return l == 0 ? KIN : (l == skip ? H + KIN : H);
}
__host__ __device__ __forceinline__ int layer_out(int l, int L, int H) { return l == L - 1 ? H + DENS_PAD : H; }
__host__ __device__ __forceinline__ long w_offset(int l, int L, int skip, int H, int KIN) {
  long o = 0;
  for (int i = 0; i < l; ++i) o += (long)layer_in(i, skip, H, KIN) * layer_out(i, L, H);
  return o;
}

// Element (r, k) of a GEMM operand, r its row in the tile (M for A, N for B)
// and k the reduction index. With `kcontig` it lies at lo[r * ld_lo + k] for
// k < split and at hi[r * ld_hi + k - split] past it (consecutive k adjacent);
// otherwise at lo[k * ld_lo + r] for r < split and hi[k * ld_hi + r - split]
// past it (consecutive r adjacent). Out of [0, rows) x [0, depth) it is zero.
// Strides, splits and rows are multiples of 8 and the bases 16-byte aligned,
// so 8 adjacent elements are one 16-byte load.
struct Operand {
  const bf16* lo;
  const bf16* hi;
  long ld_lo, ld_hi;
  int split, rows, depth, kcontig;
};

__device__ __forceinline__ uint4 load8(const Operand& o, int r, int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < o.rows && k < o.depth) {
    const bf16* p;
    if (o.kcontig)
      p = k < o.split ? o.lo + (long)r * o.ld_lo + k : o.hi + (long)r * o.ld_hi + (k - o.split);
    else
      p = r < o.split ? o.lo + (long)k * o.ld_lo + r : o.hi + (long)k * o.ld_hi + (r - o.split);
    v = *reinterpret_cast<const uint4*>(p);
  }
  return v;
}

// this thread's two 8-element vectors of the [128 x BK] slice at (r0, k0)
__device__ __forceinline__ void fetch(const Operand& o, int r0, int k0, uint4 (&v)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (o.kcontig)
      v[i] = load8(o, r0 + idx / 4, k0 + idx % 4 * 8);
    else
      v[i] = load8(o, r0 + idx % 16 * 8, k0 + idx / 16);
  }
}

// ... into the shared slice S[128][LDS], reduction index contiguous
__device__ __forceinline__ void place(const Operand& o, const uint4 (&v)[2], bf16 (*S)[LDS]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (o.kcontig) {
      *reinterpret_cast<uint4*>(&S[idx / 4][idx % 4 * 8]) = v[i];
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
      const int r = idx % 16 * 8, k = idx / 16;
#pragma unroll
      for (int j = 0; j < 8; ++j) S[r + j][k] = e[j];
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// acc[mt][nt] (+)= the 128 x 128 tile (m0, n0) of A B over k in [k_begin, k_end):
// warp (wm, wn) owns rows 64 wm + 16 mt, columns 32 wn + 8 nt; in each 16 x 8
// piece lane (g, q) = (lane / 4, lane % 4) holds rows g and g + 8, columns 2q
// and 2q + 1 (acc[..][0..1] row g, [2..3] row g + 8)
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4][4], const Operand& A, const Operand& B, int m0, int n0,
                                          int k_begin, int k_end) {
  __shared__ __align__(16) bf16 As[2][BM][LDS];
  __shared__ __align__(16) bf16 Bs[2][BN][LDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  uint4 ra[2], rb[2];
  fetch(A, m0, k_begin, ra);
  fetch(B, n0, k_begin, rb);
  place(A, ra, As[0]);
  place(B, rb, Bs[0]);
  __syncthreads();
  int buf = 0;
  for (int k = k_begin; k < k_end; k += BK) {
    const bool more = k + BK < k_end;
    if (more) {
      fetch(A, m0, k + BK, ra);
      fetch(B, n0, k + BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        a[mt][0] = word(&As[buf][r][kk + 2 * q]);
        a[mt][1] = word(&As[buf][r + 8][kk + 2 * q]);
        a[mt][2] = word(&As[buf][r][kk + 8 + 2 * q]);
        a[mt][3] = word(&As[buf][r + 8][kk + 8 + 2 * q]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        b[nt][0] = word(&Bs[buf][c][kk + 2 * q]);
        b[nt][1] = word(&Bs[buf][c][kk + 8 + 2 * q]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    if (more) {
      place(A, ra, As[buf ^ 1]);
      place(B, rb, Bs[buf ^ 1]);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// calls f(row, col, v0, v1) for this thread's accumulator pairs (col, col + 1)
template <typename F>
__device__ __forceinline__ void each_pair(const float (&acc)[4][4][4], int m0, int n0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = m0 + (warp >> 2) * 64 + (lane >> 2), c = n0 + (warp & 3) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) f(mt, nt, r + mt * 16 + 8 * h, c + nt * 8, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

__device__ __forceinline__ uint32_t pack_bf16(float v0, float v1) {
  __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&o);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// forward of one layer over [n points x cols]: ReLU -> bf16 into out [n, H]
// (hidden layers), or feat [n, H] and dens [n] (the last layer, cols = H + 1)
__global__ void __launch_bounds__(THREADS) trunk_wide_fwd_layer_kernel(Operand A, Operand B, const bf16* __restrict__ bias,
                                                                 int n, int H, int last, bf16* __restrict__ out,
                                                                 float* __restrict__ dens) {
  float acc[4][4][4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_tile(acc, A, B, m0, n0, 0, A.depth);
  each_pair(acc, m0, n0, [&](int, int, int r, int c, float v0, float v1) {
    if (r >= n) return;
    const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
    v0 += bb.x;
    v1 += bb.y;
    if (c < H)
      *reinterpret_cast<uint32_t*>(out + (long)r * H + c) = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
    else if (last && c == H)
      dens[r] = v0;
  });
}

// gx = g_l W_l^T of one layer over [n points x K_l]: the a_{l-1} columns (c <
// H, l > 0) masked into g_{l-1} and summed into db_{l-1}; the encoding
// columns of the skip layer (c >= H) into denc as bf16; layer 0's columns
// (the encoding) as bf16(gx) + denc, in bf16
__global__ void __launch_bounds__(THREADS) trunk_wide_dx_layer_kernel(Operand A, Operand B, int n, int H, int KIN, int K,
                                                                int layer0, const bf16* __restrict__ mask,
                                                                bf16* __restrict__ gprev, float* __restrict__ db_prev,
                                                                bf16* __restrict__ denc) {
  float acc[4][4][4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_tile(acc, A, B, m0, n0, 0, A.depth);
  float cs[4][2] = {};
  each_pair(acc, m0, n0, [&](int, int nt, int r, int c, float v0, float v1) {
    if (r >= n || c >= K) return;
    if (layer0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(denc + (long)r * KIN + c);
      const float2 e = unpack_bf16(*d), x = unpack_bf16(pack_bf16(v0, v1));
      *d = pack_bf16(x.x + e.x, x.y + e.y);
    } else if (c < H) {
      const float2 m = unpack_bf16(word(mask + (long)r * H + c));
      v0 = m.x > 0.f ? v0 : 0.f;
      v1 = m.y > 0.f ? v1 : 0.f;
      *reinterpret_cast<uint32_t*>(gprev + (long)r * H + c) = pack_bf16(v0, v1);
      cs[nt][0] += v0;
      cs[nt][1] += v1;
    } else {
      *reinterpret_cast<uint32_t*>(denc + (long)r * KIN + (c - H)) = pack_bf16(v0, v1);
    }
  });
  if (layer0) return;
  // column sums over the warp's rows: the 8 lanes of one q hold the same columns
  const int lane = threadIdx.x & 31, c0 = n0 + ((threadIdx.x >> 5) & 3) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int c = c0 + nt * 8 + e;
      if (lane < 4 && c < H && c < K) atomicAdd(db_prev + c, v);
    }
}

// dW_l [K_l x cols] (+)= inp^T g_l over the points of blockIdx.z's slice
__global__ void __launch_bounds__(THREADS) trunk_wide_dw_layer_kernel(Operand A, Operand B, int rows, int cols, int NO,
                                                                int rows_per_split, float* __restrict__ dw) {
  float acc[4][4][4];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int p0 = blockIdx.z * rows_per_split, p1 = min(A.depth, p0 + rows_per_split);
  if (p0 >= p1) return;
  gemm_tile(acc, A, B, m0, n0, p0, p1);
  each_pair(acc, m0, n0, [&](int, int, int r, int c, float v0, float v1) {
    if (r >= rows || c >= cols) return;
    atomicAdd(dw + (long)r * NO + c, v0);
    if (c + 1 < cols) atomicAdd(dw + (long)r * NO + c + 1, v1);
  });
}

// the last layer's g [n, H + 128] = [feat > 0 ? g_feat : 0 | g_dens | 0...] and
// its column sums into db_last; a block takes 64 columns of SEED_ROWS rows
__global__ void __launch_bounds__(THREADS) trunk_wide_seed_kernel(const bf16* __restrict__ gfeat,
                                                            const bf16* __restrict__ gdens,
                                                            const bf16* __restrict__ feat, bf16* __restrict__ glast,
                                                            float* __restrict__ db_last, int n, int H) {
  __shared__ float part[THREADS];
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  const int col = blockIdx.x * 64 + tx, NO = H + DENS_PAD;
  const int r0 = blockIdx.y * SEED_ROWS, r1 = min(n, r0 + SEED_ROWS);
  float s = 0.f;
  for (int r = r0 + ty; r < r1; r += THREADS / 64) {
    bf16 v = __float2bfloat16(0.f);
    if (col < H)
      v = __bfloat162float(feat[(long)r * H + col]) > 0.f ? gfeat[(long)r * H + col] : v;
    else if (col == H)
      v = gdens[r];
    glast[(long)r * NO + col] = v;
    s += __bfloat162float(v);
  }
  part[threadIdx.x] = s;
  __syncthreads();
  if (ty == 0 && col <= H) atomicAdd(db_last + col, part[tx] + part[tx + 64] + part[tx + 128] + part[tx + 192]);
}

unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

bool wide_ok(int H, int KIN) { return H >= 384 && H % 128 == 0 && (KIN == 64 || KIN == 128); }

}  // namespace

// ------------------------------------------------------------------ C interface
// Each function launches on `stream` (one kernel per layer, the chain a seed
// kernel first), does not synchronise, and returns the cudaError_t of the
// launches (0 on success): cudaErrorInvalidValue for an H that is not a
// multiple of 128 from 384, or a KIN other than 64 or 128.

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// acts: `slots` activation buffers [n, H] one after another; layer l writes slot l % slots
int trunk_wide_fwd(const void* enc, const void* w, const void* b, void* feat, void* dens, void* acts, int n, int L,
                   int skip, int H, int kin, int slots, void* stream) {
  if (!wide_ok(H, kin) || slots < 1) return (int)cudaErrorInvalidValue;
  const bf16 *E = (const bf16*)enc, *W = (const bf16*)w, *B = (const bf16*)b;
  bf16* act = (bf16*)acts;
  for (int l = 0; l < L; ++l) {
    const int K = layer_in(l, skip, H, kin), NO = layer_out(l, L, H), last = l == L - 1;
    const int Ka = l == 0 ? 0 : (l == skip ? H : K);  // input columns from a_{l-1}; the rest from enc
    const Operand a{l == 0 ? nullptr : act + (long)((l - 1) % slots) * n * H, E, H, kin, Ka, n, K, 1};
    const Operand wt{W + w_offset(l, L, skip, H, kin), nullptr, NO, 0, NO, NO, K, 0};
    const int cols = last ? H + 1 : H;
    trunk_wide_fwd_layer_kernel<<<dim3(cdiv(cols, BN), cdiv(n, BM)), THREADS, 0, (cudaStream_t)stream>>>(
        a, wt, B + (long)l * H, n, H, last, last ? (bf16*)feat : act + (long)(l % slots) * n * H, (float*)dens);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// gsave: g_0 .. g_{L-2} as [n, H] each, then the last layer's g [n, H + 128]
int trunk_wide_bwd_chain(const void* gfeat, const void* gdens, const void* feat, const void* acts, const void* w,
                         void* denc, void* gsave, void* db, int n, int L, int skip, int H, int kin, void* stream) {
  if (!wide_ok(H, kin)) return (int)cudaErrorInvalidValue;
  const bf16 *W = (const bf16*)w, *act = (const bf16*)acts;
  bf16 *G = (bf16*)gsave, *D = (bf16*)denc;
  float* db_ = (float*)db;
  bf16* glast = G + (long)(L - 1) * n * H;
  trunk_wide_seed_kernel<<<dim3(cdiv(H + DENS_PAD, 64), cdiv(n, SEED_ROWS)), THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)gfeat, (const bf16*)gdens, (const bf16*)feat, glast, db_ + (long)(L - 1) * H, n, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int l = L - 1; l >= 0; --l) {
    const int K = layer_in(l, skip, H, kin), NO = layer_out(l, L, H), last = l == L - 1;
    const Operand g{last ? glast : G + (long)l * n * H, nullptr, last ? H + DENS_PAD : H, 0, NO, n, NO, 1};
    const Operand wt{W + w_offset(l, L, skip, H, kin), nullptr, NO, 0, NO, K, NO, 1};
    trunk_wide_dx_layer_kernel<<<dim3(cdiv(K, BN), cdiv(n, BM)), THREADS, 0, (cudaStream_t)stream>>>(
        g, wt, n, H, kin, K, l == 0, l > 0 ? act + (long)(l - 1) * n * H : nullptr,
        l > 0 ? G + (long)(l - 1) * n * H : nullptr, l > 0 ? db_ + (long)(l - 1) * H : nullptr, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int trunk_wide_bwd_dw(const void* enc, const void* acts, const void* gsave, const void* gdens, void* dw, int n,
                      int L, int skip, int H, int kin, void* stream) {
  static int sms = 0;
  if (!wide_ok(H, kin)) return (int)cudaErrorInvalidValue;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  (void)gdens;  // the density column's g is column H of the last layer's g
  const bf16 *E = (const bf16*)enc, *act = (const bf16*)acts, *G = (const bf16*)gsave;
  for (int l = 0; l < L; ++l) {
    const int K = layer_in(l, skip, H, kin), NO = layer_out(l, L, H), last = l == L - 1;
    const int Ka = l == 0 ? 0 : (l == skip ? H : K);
    const int cols = last ? H + 1 : H;
    const Operand a{l == 0 ? nullptr : act + (long)(l - 1) * n * H, E, H, kin, Ka, K, n, 0};
    const Operand g{G + (long)l * n * H, nullptr, last ? H + DENS_PAD : H, 0, NO, NO, n, 0};
    // about two waves of blocks, each slice a whole number of reduction steps
    const int tiles = (int)(cdiv(cols, BN) * cdiv(K, BM)), steps = (int)cdiv(n, BK);
    const int splits = std::max(1, std::min(2 * sms / tiles, steps));
    const int rows_per_split = (int)cdiv(steps, splits) * BK;
    trunk_wide_dw_layer_kernel<<<dim3(cdiv(cols, BN), cdiv(K, BM), splits), THREADS, 0, (cudaStream_t)stream>>>(
        a, g, K, cols, NO, rows_per_split, (float*)dw + w_offset(l, L, skip, H, kin));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
