// Trilinear grid sampling for Hopper (sm_90a): an 8-corner gather forward, and a
// backward that adds per-corner contributions with float atomics.
//
// Ports `_trilinear_value` / `_trilinear_vg` and their hand-written VJPs of
// poseprobe_tpu/ops/grid.py (on the TPU the gather and the scatter were XLA
// ops; the Pallas layout kernels of poseprobe_tpu/ops/pallas/layout.py moved
// the grid between [C, X, Y, Z] and [V, C] rows around them). Here both
// directions work on the grid's own contiguous [C, X, Y, Z] layout (V = X*Y*Z
// voxels per channel plane): the kernels read the grid, and add into its
// gradient, in that layout; nothing is transposed.
//
// Coordinates follow `_corner_data` exactly: align_corners=True, clamp to the
// border, i0 clipped to D-2, an `inside` mask that zeroes the spatial gradient
// outside the box, corner order bit0 = +z, bit1 = +y, bit2 = +x. The
// coordinate arithmetic uses explicitly rounded float ops (no fused
// multiply-add), so a point computed to lie on a voxel corner falls in the
// same cell as in the plain PyTorch version.
//
// Bound by memory requests, not by bytes: a point touches 8 voxels scattered
// over the grid, and per channel those are four z-adjacent pairs, so the work
// is up to 8 sector requests per (point, channel), gathered (forward) or added
// with float atomics (backward), with no reuse beyond L2 except between the
// neighbouring points of a warp, which on the training step's clustered points
// share most of their sectors. One thread per point: it locates its cell once
// and walks the channels, one plane after the other, so a warp's loads (and
// atomics) of one channel stay inside one plane. Each voxel is its own 4-byte
// load or atomic. The backward skips zero contributions (clamped points, zero
// cotangents), sums d_pts over the channels in registers and stores it once.
// With more than one channel the forward stages a block's outputs in shared
// memory, so that the rows of C values (and of 3C gradients) leave in
// coalesced stores.
//
// Plain C interface: every function launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;             // threads of a block of the staged scatter
constexpr int POINTS = 128;              // points (= threads) of a block of the lookup kernels
constexpr int STAGE_BYTES = 48 * 1024;   // the forward stages its outputs when they fit

struct Axis {
  int i0;     // lower corner index, in [0, D-2]
  float w;    // weight of the upper corner
  float sm;   // scale * inside-mask: d(index coordinate)/d(world coordinate), 0 outside
};

__device__ __forceinline__ Axis prep(float p, float lo, float hi, int D) {
  const float extent = __fsub_rn(hi, lo);
  const float top = (float)(D - 1);
  float i = __fmul_rn(__fdiv_rn(__fsub_rn(p, lo), extent), top);
  const bool inside = (i >= 0.0f) && (i <= top);
  i = fminf(fmaxf(i, 0.0f), top);
  Axis a;
  a.i0 = min(max((int)floorf(i), 0), D - 2);
  a.w = __fsub_rn(i, (float)a.i0);
  a.sm = inside ? __fdiv_rn(top, extent) : 0.0f;
  return a;
}

struct Cell {
  Axis x, y, z;
  long long base;   // flat voxel id of corner 0
};

__device__ __forceinline__ Cell locate(const float* __restrict__ pts, long long n,
                                       const float* __restrict__ lo, const float* __restrict__ hi,
                                       int X, int Y, int Z) {
  Cell c;
  c.x = prep(pts[n * 3 + 0], lo[0], hi[0], X);
  c.y = prep(pts[n * 3 + 1], lo[1], hi[1], Y);
  c.z = prep(pts[n * 3 + 2], lo[2], hi[2], Z);
  c.base = ((long long)c.x.i0 * Y + c.y.i0) * Z + c.z.i0;
  return c;
}

// voxel id of the lower-z corner of pair p: p = 2i + j for the corners (i, j, 0) and (i, j, 1)
__device__ __forceinline__ long long pair_voxel(const Cell& c, int p, int Y, int Z) {
  return c.base + (long long)(p >> 1) * Y * Z + (long long)(p & 1) * Z;
}

// grid [C, X, Y, Z], V = X*Y*Z floats per channel plane; pts [N, 3]; val [N, C];
// grad [N, C, 3] or null. STAGE: a block's values and then its gradients are
// gathered in shared memory ([POINTS, C] and [POINTS, C, 3], the outputs' own order)
// and stored from there. The plane stride comes as an argument: computed here from
// X, Y, Z instead, the 13-channel gather ran slower at the training step's points.
template <bool STAGE>
__global__ void __launch_bounds__(POINTS)
trilinear_fwd_kernel(const float* __restrict__ grid, long long V, const float* __restrict__ pts,
                     const float* __restrict__ lo, const float* __restrict__ hi, int X, int Y,
                     int Z, int C, long long N, float* __restrict__ val, float* __restrict__ grad) {
  extern __shared__ float staged[];
  const long long n0 = (long long)blockIdx.x * POINTS;
  const long long n = n0 + threadIdx.x;
  if (n < N) {
    const Cell cell = locate(pts, n, lo, hi, X, Y, Z);
    const float ax[2] = {1.0f - cell.x.w, cell.x.w};
    const float ay[2] = {1.0f - cell.y.w, cell.y.w};
    const float az[2] = {1.0f - cell.z.w, cell.z.w};
    long long off[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) off[p] = pair_voxel(cell, p, Y, Z);
    for (int ch = 0; ch < C; ++ch) {
      const float* g = grid + ch * V;
      float c[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        c[2 * p] = __ldg(g + off[p]);
        c[2 * p + 1] = __ldg(g + off[p] + 1);
      }
      float v = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = k >> 2, j = (k >> 1) & 1, l = k & 1;
        v += ax[i] * ay[j] * az[l] * c[k];
        gx += (i ? 1.0f : -1.0f) * ay[j] * az[l] * c[k];
        gy += (j ? 1.0f : -1.0f) * ax[i] * az[l] * c[k];
        gz += (l ? 1.0f : -1.0f) * ax[i] * ay[j] * c[k];
      }
      if (STAGE) {
        staged[threadIdx.x * C + ch] = v;
      } else {
        val[n * C + ch] = v;
      }
      if (grad != nullptr) {
        float* go = STAGE ? staged + (POINTS + threadIdx.x * 3) * C + ch * 3 : grad + (n * C + ch) * 3;
        go[0] = gx * cell.x.sm;
        go[1] = gy * cell.y.sm;
        go[2] = gz * cell.z.sm;
      }
    }
  }
  if (!STAGE) return;
  __syncthreads();
  const long long count = min((long long)POINTS, N - n0) * C;
  for (long long i = threadIdx.x; i < count; i += POINTS) val[n0 * C + i] = staged[i];
  if (grad != nullptr)
    for (long long i = threadIdx.x; i < count * 3; i += POINTS) grad[n0 * C * 3 + i] = staged[POINTS * C + i];
}

// Cotangents ct_v [N, C] and ct_g [N, C, 3] (either may be null: zeros). The
// per-corner contributions are added into d_grid [C, X, Y, Z] with atomics (null:
// no grid gradient); or, when `up` is given, they are written unsummed to
// up [C, N*8] with their voxel ids in up_idx [N*8] for `scatter_rows_kernel`.
// d_pts [N, 3] (null: not needed) is summed over the channels and stored.
__global__ void __launch_bounds__(POINTS)
trilinear_bwd_kernel(const float* __restrict__ grid, const float* __restrict__ pts,
                     const float* __restrict__ lo, const float* __restrict__ hi,
                     const float* __restrict__ ct_v, const float* __restrict__ ct_g, int X, int Y,
                     int Z, int C, long long N, float* __restrict__ d_grid, float* __restrict__ up,
                     int* __restrict__ up_idx, float* __restrict__ d_pts) {
  const long long n = (long long)blockIdx.x * POINTS + threadIdx.x;
  if (n >= N) return;
  const long long V = (long long)X * Y * Z;
  const Cell cell = locate(pts, n, lo, hi, X, Y, Z);
  const float ax[2] = {1.0f - cell.x.w, cell.x.w};
  const float ay[2] = {1.0f - cell.y.w, cell.y.w};
  const float az[2] = {1.0f - cell.z.w, cell.z.w};
  const float sxm = cell.x.sm, sym = cell.y.sm, szm = cell.z.sm;
  long long vox[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) vox[p] = pair_voxel(cell, p, Y, Z);
  if (up != nullptr) {
#pragma unroll
    for (int k = 0; k < 8; ++k) up_idx[n * 8 + k] = (int)(vox[k >> 1] + (k & 1));
  }
  float dwx = 0.0f, dwy = 0.0f, dwz = 0.0f;
  for (int ch = 0; ch < C; ++ch) {
    const long long t = n * C + ch;
    const float cv = ct_v != nullptr ? ct_v[t] : 0.0f;
    float cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;
    if (ct_g != nullptr) {
      cgx = ct_g[t * 3 + 0];
      cgy = ct_g[t * 3 + 1];
      cgz = ct_g[t * 3 + 2];
    }
    float contrib[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = k >> 2, j = (k >> 1) & 1, l = k & 1;
      const float sx = i ? 1.0f : -1.0f, sy = j ? 1.0f : -1.0f, sz = l ? 1.0f : -1.0f;
      const float AX = ax[i], AY = ay[j], AZ = az[l];
      // the outputs are linear in the corner value with these coefficients:
      // val: AX*AY*AZ, gx: sx*AY*AZ*sxm, gy: sy*AX*AZ*sym, gz: sz*AX*AY*szm
      contrib[k] = AX * AY * AZ * cv + sx * AY * AZ * sxm * cgx + sy * AX * AZ * sym * cgy
                   + sz * AX * AY * szm * cgz;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (up != nullptr) {
        up[(ch * N + n) * 8 + 2 * p] = contrib[2 * p];
        up[(ch * N + n) * 8 + 2 * p + 1] = contrib[2 * p + 1];
      } else if (d_grid != nullptr) {
        // a z-pair: two neighbouring floats of the channel's plane, zeros skipped
        float* a = d_grid + ch * V + vox[p];
        if (contrib[2 * p] != 0.0f) atomicAdd(a, contrib[2 * p]);
        if (contrib[2 * p + 1] != 0.0f) atomicAdd(a + 1, contrib[2 * p + 1]);
      }
    }
    if (d_pts != nullptr) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // derivative of the same coefficients with respect to wx, wy, wz
        const int i = k >> 2, j = (k >> 1) & 1, l = k & 1;
        const float sx = i ? 1.0f : -1.0f, sy = j ? 1.0f : -1.0f, sz = l ? 1.0f : -1.0f;
        const float AX = ax[i], AY = ay[j], AZ = az[l];
        const float c = __ldg(grid + ch * V + vox[k >> 1] + l);
        dwx += c * (cv * sx * AY * AZ + cgy * sy * sx * AZ * sym + cgz * sz * sx * AY * szm);
        dwy += c * (cv * sy * AX * AZ + cgx * sx * sy * AZ * sxm + cgz * sz * sy * AX * szm);
        dwz += c * (cv * sz * AX * AY + cgx * sx * sz * AY * sxm + cgy * sy * sz * AX * sym);
      }
    }
  }
  if (d_pts != nullptr) {
    d_pts[n * 3 + 0] = dwx * sxm;
    d_pts[n * 3 + 1] = dwy * sym;
    d_pts[n * 3 + 2] = dwz * szm;
  }
}

// d_grid[c * V + idx[r]] += up[c, r]; up [C, R], idx [R]: a warp adds into one channel plane
__global__ void scatter_rows_kernel(const float* __restrict__ up, const int* __restrict__ idx,
                                    float* __restrict__ d_grid, long long V, long long R, int C) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * C) return;
  atomicAdd(d_grid + (t / R) * V + idx[t % R], up[t]);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int trilinear_fwd(const void* grid, const void* pts, const void* lo, const void* hi, int X, int Y,
                  int Z, int C, long long N, void* val, void* grad, void* stream) {
  if (N * C == 0) return 0;
  // at one channel the values are contiguous already, and the gradients 3 floats apart
  const size_t stage_bytes = (size_t)POINTS * C * (grad != nullptr ? 4 : 1) * sizeof(float);
  const bool stage = C > 1 && stage_bytes <= STAGE_BYTES;
  auto kernel = stage ? trilinear_fwd_kernel<true> : trilinear_fwd_kernel<false>;
  kernel<<<(unsigned)((N + POINTS - 1) / POINTS), POINTS, stage ? stage_bytes : 0,
           (cudaStream_t)stream>>>((const float*)grid, (long long)X * Y * Z, (const float*)pts,
                                   (const float*)lo, (const float*)hi, X, Y, Z, C, N, (float*)val,
                                   (float*)grad);
  return (int)cudaGetLastError();
}

int trilinear_bwd(const void* grid, const void* pts, const void* lo, const void* hi,
                  const void* ct_v, const void* ct_g, int X, int Y, int Z, int C, long long N,
                  void* d_grid, void* up, void* up_idx, void* d_pts, void* stream) {
  if (N * C == 0) return 0;
  trilinear_bwd_kernel<<<(unsigned)((N + POINTS - 1) / POINTS), POINTS, 0, (cudaStream_t)stream>>>(
      (const float*)grid, (const float*)pts, (const float*)lo, (const float*)hi,
      (const float*)ct_v, (const float*)ct_g, X, Y, Z, C, N, (float*)d_grid, (float*)up,
      (int*)up_idx, (float*)d_pts);
  return (int)cudaGetLastError();
}

int scatter_rows(const void* up, const void* idx, void* d_grid, long long V, long long R, int C,
                 void* stream) {
  if (R * C == 0) return 0;
  scatter_rows_kernel<<<(unsigned)((R * C + THREADS - 1) / THREADS), THREADS, 0,
                        (cudaStream_t)stream>>>((const float*)up, (const int*)idx, (float*)d_grid,
                                                V, R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
