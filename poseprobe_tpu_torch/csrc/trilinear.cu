// Trilinear grid sampling for Hopper (sm_90a): 8-corner gather forward, and a
// backward that scatter-adds per-corner contributions with float atomics.
//
// Ports `_trilinear_value` / `_trilinear_vg` and their hand-written VJPs of
// poseprobe_tpu/ops/grid.py (the consumers of the Pallas layout kernels in
// poseprobe_tpu/ops/pallas/layout.py; on the TPU the gather and the scatter
// themselves were XLA ops). The grid is read as row-major rows [V, C]
// (V = X*Y*Z voxels, one row of C channels per voxel) and its gradient is
// accumulated into a zeroed row-major [V, P] buffer, P >= C, that
// `transpose_slice` (layout.cu) turns into [C, X, Y, Z].
//
// Coordinates follow `_corner_data` exactly: align_corners=True, clamp to the
// border, i0 clipped to D-2, an `inside` mask that zeroes the spatial gradient
// outside the box, corner order bit0 = +z, bit1 = +y, bit2 = +x. The
// coordinate arithmetic uses explicitly rounded float ops (no fused
// multiply-add), so a point computed to lie on a voxel corner falls in the
// same cell as in the plain PyTorch version.
//
// Bound by bytes, and by atomics: a point touches 8 rows of C floats scattered
// over the grid, so the work is 8 sector reads (forward) and 8*C atomic adds
// (backward) per point, with no reuse to exploit beyond L2. One thread per
// (point, channel): neighbouring threads read and update neighbouring channels
// of the same row, so a 13-channel row is one or two memory transactions.
//
// Plain C interface: every function launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

// corner k = (i, j, l) with i = k >> 2 (+x), j = (k >> 1) & 1 (+y), l = k & 1 (+z)
__device__ __forceinline__ long long corner_offset(int k, int Y, int Z) {
  return (long long)(k >> 2) * Y * Z + (long long)((k >> 1) & 1) * Z + (k & 1);
}

// rows [V, C]; pts [N, 3]; val [N, C]; grad [N, C, 3] or null
__global__ void trilinear_fwd_kernel(const float* __restrict__ rows, const float* __restrict__ pts,
                                     const float* __restrict__ lo, const float* __restrict__ hi,
                                     int X, int Y, int Z, int C, long long N,
                                     float* __restrict__ val, float* __restrict__ grad) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= N * C) return;
  const long long n = t / C;
  const int ch = (int)(t % C);
  const Cell cell = locate(pts, n, lo, hi, X, Y, Z);
  const float ax[2] = {1.0f - cell.x.w, cell.x.w};
  const float ay[2] = {1.0f - cell.y.w, cell.y.w};
  const float az[2] = {1.0f - cell.z.w, cell.z.w};
  float v = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = k >> 2, j = (k >> 1) & 1, l = k & 1;
    const float c = rows[(cell.base + corner_offset(k, Y, Z)) * C + ch];
    v += ax[i] * ay[j] * az[l] * c;
    gx += (i ? 1.0f : -1.0f) * ay[j] * az[l] * c;
    gy += (j ? 1.0f : -1.0f) * ax[i] * az[l] * c;
    gz += (l ? 1.0f : -1.0f) * ax[i] * ay[j] * c;
  }
  val[t] = v;
  if (grad != nullptr) {
    grad[t * 3 + 0] = gx * cell.x.sm;
    grad[t * 3 + 1] = gy * cell.y.sm;
    grad[t * 3 + 2] = gz * cell.z.sm;
  }
}

// Cotangents ct_v [N, C] and ct_g [N, C, 3] (either may be null: zeros).
// d_rows [V, P] (null: no grid gradient) receives the per-corner contributions
// with atomicAdd; or, when `up` is given, they are written unsummed to
// up [N*8, P] with their voxel ids in up_idx [N*8] for `scatter_rows_kernel`.
// d_pts [N, 3] (null: not needed; needs `rows`) is zeroed by the caller and
// summed over channels with atomicAdd.
__global__ void trilinear_bwd_kernel(const float* __restrict__ rows, const float* __restrict__ pts,
                                     const float* __restrict__ lo, const float* __restrict__ hi,
                                     const float* __restrict__ ct_v, const float* __restrict__ ct_g,
                                     int X, int Y, int Z, int C, int P, long long N,
                                     float* __restrict__ d_rows, float* __restrict__ up,
                                     int* __restrict__ up_idx, float* __restrict__ d_pts) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= N * C) return;
  const long long n = t / C;
  const int ch = (int)(t % C);
  const Cell cell = locate(pts, n, lo, hi, X, Y, Z);
  const float ax[2] = {1.0f - cell.x.w, cell.x.w};
  const float ay[2] = {1.0f - cell.y.w, cell.y.w};
  const float az[2] = {1.0f - cell.z.w, cell.z.w};
  const float sxm = cell.x.sm, sym = cell.y.sm, szm = cell.z.sm;
  const float cv = ct_v != nullptr ? ct_v[t] : 0.0f;
  float cgx = 0.0f, cgy = 0.0f, cgz = 0.0f;
  if (ct_g != nullptr) {
    cgx = ct_g[t * 3 + 0];
    cgy = ct_g[t * 3 + 1];
    cgz = ct_g[t * 3 + 2];
  }
  float dwx = 0.0f, dwy = 0.0f, dwz = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = k >> 2, j = (k >> 1) & 1, l = k & 1;
    const float sx = i ? 1.0f : -1.0f, sy = j ? 1.0f : -1.0f, sz = l ? 1.0f : -1.0f;
    const float AX = ax[i], AY = ay[j], AZ = az[l];
    const long long voxel = cell.base + corner_offset(k, Y, Z);
    // the outputs are linear in the corner value with these coefficients:
    // val: AX*AY*AZ, gx: sx*AY*AZ*sxm, gy: sy*AX*AZ*sym, gz: sz*AX*AY*szm
    const float contrib = AX * AY * AZ * cv + sx * AY * AZ * sxm * cgx
                          + sy * AX * AZ * sym * cgy + sz * AX * AY * szm * cgz;
    if (up != nullptr) {
      up[(n * 8 + k) * P + ch] = contrib;
      if (ch == 0) up_idx[n * 8 + k] = (int)voxel;
    } else if (d_rows != nullptr) {
      atomicAdd(d_rows + voxel * P + ch, contrib);
    }
    if (d_pts != nullptr) {
      // derivative of the same coefficients with respect to wx, wy, wz
      const float c = rows[voxel * C + ch];
      dwx += c * (cv * sx * AY * AZ + cgy * sy * sx * AZ * sym + cgz * sz * sx * AY * szm);
      dwy += c * (cv * sy * AX * AZ + cgx * sx * sy * AZ * sxm + cgz * sz * sy * AX * szm);
      dwz += c * (cv * sz * AX * AY + cgx * sx * sz * AY * sxm + cgy * sy * sz * AX * sym);
    }
  }
  if (d_pts != nullptr) {
    atomicAdd(d_pts + n * 3 + 0, dwx * sxm);
    atomicAdd(d_pts + n * 3 + 1, dwy * sym);
    atomicAdd(d_pts + n * 3 + 2, dwz * szm);
  }
}

// d_rows[idx[r], c] += up[r, c] for c < C; up [R, P], idx [R], d_rows [V, P]
__global__ void scatter_rows_kernel(const float* __restrict__ up, const int* __restrict__ idx,
                                    float* __restrict__ d_rows, long long R, int P, int C) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= R * C) return;
  const long long r = t / C;
  const int c = (int)(t % C);
  atomicAdd(d_rows + (long long)idx[r] * P + c, up[r * P + c]);
}

unsigned blocks_for(long long work) { return (unsigned)((work + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int trilinear_fwd(const void* rows, const void* pts, const void* lo, const void* hi, int X, int Y,
                  int Z, int C, long long N, void* val, void* grad, void* stream) {
  if (N * C == 0) return 0;
  trilinear_fwd_kernel<<<blocks_for(N * C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)pts, (const float*)lo, (const float*)hi, X, Y, Z, C, N,
      (float*)val, (float*)grad);
  return (int)cudaGetLastError();
}

int trilinear_bwd(const void* rows, const void* pts, const void* lo, const void* hi,
                  const void* ct_v, const void* ct_g, int X, int Y, int Z, int C, int P,
                  long long N, void* d_rows, void* up, void* up_idx, void* d_pts, void* stream) {
  if (N * C == 0) return 0;
  trilinear_bwd_kernel<<<blocks_for(N * C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)pts, (const float*)lo, (const float*)hi,
      (const float*)ct_v, (const float*)ct_g, X, Y, Z, C, P, N, (float*)d_rows, (float*)up,
      (int*)up_idx, (float*)d_pts);
  return (int)cudaGetLastError();
}

int scatter_rows(const void* up, const void* idx, void* d_rows, long long R, int P, int C,
                 void* stream) {
  if (R * C == 0) return 0;
  scatter_rows_kernel<<<blocks_for(R * C), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)up, (const int*)idx, (float*)d_rows, R, P, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
