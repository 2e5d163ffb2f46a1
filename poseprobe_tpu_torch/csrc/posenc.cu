// The scene branch's positional encoding for Hopper (sm_90a), written straight
// into the fused trunk's input tile, and its backward.
//
// Replaces no TPU kernel: the JAX package encodes with XLA ops
// (poseprobe_tpu/ops/pe.py `posenc_scene`), which XLA fuses into the trunk's
// input. In PyTorch the same chain is about ten passes over the samples
// (product, sin, cos, stack, the BARF weights, cat, the bf16 cast, the pad to
// the trunk's width), each writing and reading back a float32 [N, 3, 2, L] or
// [N, 63] tensor: ~2.5 KB of traffic a point for a 128-byte bf16 row.
//
// Forward: points [N, 3] f32 and the [L] BARF weights (a device pointer, so a
// captured graph follows a weight tensor that changes between replays) to
// enc [N, pad] bf16 in `posenc_scene`'s layout: [x | for c: sin(L), cos(L)],
// zeros up to pad; column raw + c*2L + s*L + k holds w_k * sin_or_cos(x_c * f_k),
// f_k = 2^k * (float)pi (2^k without pi). The products are the plain chain's
// f32 products in its order, sinf / cosf are the accurate ones (the build has
// no fast-math flag), and each value is rounded to bf16 by RNE once, so the
// output is the plain chain's, bit for bit.
//
// What bounds it on an H100: 140 bytes a point (12 read, 64 or 128 bf16
// columns written), against 3L arguments a point, each one range reduction and
// two short polynomials: at L = 10 ~0.9 k FP32 instructions a point, under the
// bytes' time at 3.35 TB/s. So the design is about the bytes: a block owns 128
// points; it reads their 1.5 KB in one coalesced pass into shared memory,
// each thread then takes one (point, channel, band) at a time and writes both
// its sin and its cos (one `sincosf`: one range reduction for the two columns,
// and no warp divergence between sin and cos lanes; both rounded by one paired
// conversion) into a bf16 tile of the block's rows, and the tile leaves in
// 16-byte stores, neighbouring threads on neighbouring addresses, since the
// block's rows are one contiguous run of the output. Ragged N is masked; 128
// points and 256 threads a block keep six blocks on each SM (32 KB of tile).
// Measured at a render chunk's 1,048,576 points (H100, in turns): 64 points a
// block 0.123 ms, 128 0.108, 32 with the paired conversion 0.140, against the
// bytes' 0.044; with no sines at all the same design takes 0.073 ms, so the
// sines and the staging take about equal shares of the time over the bound.
//
// Backward: points and denc [N, pad] bf16 (the trunk backward's own output)
// to dx [N, 3] f32 = denc_raw_c + sum_k w_k f_k (dsin_ck cos(x_c f_k) -
// dcos_ck sin(x_c f_k)), with sin and cos computed again from the points.
// The block's gradient rows come in by 16-byte loads into a tile whose row
// pitch is an odd number of words (so the threads of one channel in
// neighbouring rows fall in different banks); one thread per (point, channel)
// walks the bands. It runs where the points need a gradient (the pose window,
// test-time pose optimisation); the f32 sums are in another order than
// autograd's through the plain chain.
//
// Plain C interface: every function launches on the given stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int POINTS = 128;        // points a block owns
constexpr int MAX_PAD = 128;       // widest tile: the trunk's encoding pad is 64 or 128
constexpr int MAX_L = 32;          // 6L <= MAX_PAD bounds L by 21
constexpr int BWD_PITCH = MAX_PAD / 2 + 1;   // words a backward tile row takes

// f_k: 2^k times (float)pi, or 2^k; both products are exact
__device__ __forceinline__ float band_freq(int k, int include_pi) {
  return (include_pi ? 3.14159265358979f : 1.0f) * (float)(1u << k);
}

__global__ void __launch_bounds__(THREADS)
    posenc_scene_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            __nv_bfloat16* __restrict__ enc, long long n, int L, int include_pi,
                            int add_raw, int pad) {
  __shared__ float sx[POINTS * 3];
  __shared__ float sw[MAX_L], sf[MAX_L];
  __shared__ int arg_of[3 * MAX_L];   // argument r = c*L + k of a point: its sin column | k << 8 | c << 16
  __shared__ __align__(16) __nv_bfloat16 tile[POINTS * MAX_PAD];
  const long long p0 = (long long)blockIdx.x * POINTS;
  const int np = (int)min((long long)POINTS, n - p0);
  const int raw = add_raw ? 3 : 0, width = raw + 6 * L, args = 3 * L;
  for (int i = threadIdx.x; i < np * 3; i += THREADS) sx[i] = x[p0 * 3 + i];
  if (threadIdx.x < L) sw[threadIdx.x] = w[threadIdx.x], sf[threadIdx.x] = band_freq(threadIdx.x, include_pi);
  if (threadIdx.x < args) {
    const int c = threadIdx.x / L, k = threadIdx.x - c * L;
    arg_of[threadIdx.x] = (raw + c * 2 * L + k) | k << 8 | c << 16;
  }
  __syncthreads();

  // the block's np * args arguments, THREADS apart: (point, argument) advanced without a division
  if (args > 0) {
    const int dp = THREADS / args, dr = THREADS - dp * args;
    int p = threadIdx.x / args, r = threadIdx.x - p * args;
    while (p < np) {
      const int a = arg_of[r], k = (a >> 8) & 0xff;
      float s, co;
      sincosf(__fmul_rn(sx[p * 3 + (a >> 16)], sf[k]), &s, &co);
      __nv_bfloat16* out = tile + p * pad + (a & 0xff);
      const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(s, sw[k]), __fmul_rn(co, sw[k]));
      out[0] = v.x;
      out[L] = v.y;
      p += dp, r += dr;
      if (r >= args) r -= args, ++p;
    }
  }
  // the raw point's columns and the zero columns up to pad
  const int rest = raw + pad - width;
  for (int i = threadIdx.x; i < np * rest; i += THREADS) {
    const int p = i / rest, j = i - p * rest;
    tile[p * pad + (j < raw ? j : width + j - raw)] = __float2bfloat16_rn(j < raw ? sx[p * 3 + j] : 0.0f);
  }
  __syncthreads();

  const int4* src = reinterpret_cast<const int4*>(tile);
  int4* dst = reinterpret_cast<int4*>(enc + p0 * pad);
  for (int i = threadIdx.x; i < np * pad / 8; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS)
    posenc_scene_bwd_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ denc,
                            const float* __restrict__ w, float* __restrict__ dx, long long n, int L,
                            int include_pi, int add_raw, int pad) {
  __shared__ float sw[MAX_L];
  __shared__ uint32_t tile[POINTS * BWD_PITCH];     // bf16 pairs, rows BWD_PITCH words apart
  const long long p0 = (long long)blockIdx.x * POINTS;
  const int np = (int)min((long long)POINTS, n - p0);
  const int vecs = pad / 8;                           // 16-byte vectors a row
  const int4* src = reinterpret_cast<const int4*>(denc + p0 * pad);
  for (int i = threadIdx.x; i < np * vecs; i += THREADS) {
    const int4 v = src[i];
    uint32_t* row = tile + (i / vecs) * BWD_PITCH + (i % vecs) * 4;
    row[0] = (uint32_t)v.x, row[1] = (uint32_t)v.y, row[2] = (uint32_t)v.z, row[3] = (uint32_t)v.w;
  }
  if (threadIdx.x < L) sw[threadIdx.x] = w[threadIdx.x];
  __syncthreads();

  const int raw = add_raw ? 3 : 0;
  for (int i = threadIdx.x; i < np * 3; i += THREADS) {
    const int p = i / 3, c = i - p * 3;
    const __nv_bfloat16* row = reinterpret_cast<const __nv_bfloat16*>(tile + p * BWD_PITCH);
    const float xc = x[p0 * 3 + i];
    float acc = add_raw ? __bfloat162float(row[c]) : 0.0f;
    for (int k = 0; k < L; ++k) {
      const float f = band_freq(k, include_pi);
      float s, co;
      sincosf(__fmul_rn(xc, f), &s, &co);
      const float ds = __bfloat162float(row[raw + c * 2 * L + k]), dc = __bfloat162float(row[raw + c * 2 * L + L + k]);
      acc += sw[k] * f * (ds * co - dc * s);
    }
    dx[p0 * 3 + i] = acc;
  }
}

bool takes(int L, int add_raw, int pad) {
  return L >= 0 && L <= MAX_L && pad % 8 == 0 && pad <= MAX_PAD && (add_raw ? 3 : 0) + 6 * L <= pad;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int posenc_scene_fwd(const void* x, const void* w, void* enc, long long n, int L, int include_pi, int add_raw,
                     int pad, void* stream) {
  if (!takes(L, add_raw, pad)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  posenc_scene_fwd_kernel<<<(unsigned)((n + POINTS - 1) / POINTS), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (__nv_bfloat16*)enc, n, L, include_pi, add_raw, pad);
  return (int)cudaGetLastError();
}

int posenc_scene_bwd(const void* x, const void* denc, const void* w, void* dx, long long n, int L, int include_pi,
                     int add_raw, int pad, void* stream) {
  if (!takes(L, add_raw, pad)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  posenc_scene_bwd_kernel<<<(unsigned)((n + POINTS - 1) / POINTS), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const __nv_bfloat16*)denc, (const float*)w, (float*)dx, n, L, include_pi, add_raw, pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
