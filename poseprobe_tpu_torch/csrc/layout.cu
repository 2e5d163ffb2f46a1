// Layout kernels for Hopper (sm_90a): float32 transposes and a raw copy.
//
// They replace the Pallas TPU kernels of poseprobe_tpu/ops/pallas/layout.py:
//   transpose2d     [A, B] -> [B, A]
//   transpose_slice [V, P] -> [C, V]   (first C of P columns, transposed)
//   materialize     identity copy into a fresh buffer
// whose one job is to turn the row-major [V, P] buffer that the trilinear
// scatter-add fills (one contiguous row per corner update) into the
// channel-major [C, X, Y, Z] layout grids are stored in, and back for the
// forward gather.
//
// All three are pure data movement, bound by bytes: each element is read once
// and written once. The design only has to keep both sides of the transpose
// coalesced. On the main path one side is very narrow (13 or 16 floats per row
// against 884,736 rows), so 32x32 tiles would leave most lanes idle; the
// narrow kernels instead move a contiguous run of 256 rows (256 x ld floats,
// read or written linearly, fully coalesced) through shared memory, with the
// row pitch padded to an odd number of words so the strided side of the
// exchange has no bank conflicts. Anything wider than 32 columns on both sides
// takes the classic padded 32x32 tile. Ragged edges are masked in the kernels.
//
// Plain C interface: every function launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NARROW = 32;    // widest row the narrow kernels take
constexpr int ROWS = 256;     // rows per block in the narrow kernels (= threads)
constexpr int TILE = 32;

// in: [A, ld] row-major, ld <= NARROW.  out: [C, A], C <= ld.
__global__ void rows_to_channels_kernel(const float* __restrict__ in, float* __restrict__ out,
                                        long long A, int ld, int C) {
  __shared__ float s[ROWS * (NARROW + 1)];
  const int pitch = ld | 1;
  const long long row0 = (long long)blockIdx.x * ROWS;
  const long long rows = min((long long)ROWS, A - row0);
  const float* src = in + row0 * ld;
  const int total = (int)rows * ld;
  for (int i = threadIdx.x; i < total; i += ROWS) s[(i / ld) * pitch + (i % ld)] = src[i];
  __syncthreads();
  if (threadIdx.x < rows) {
    for (int c = 0; c < C; ++c) out[(long long)c * A + row0 + threadIdx.x] = s[threadIdx.x * pitch + c];
  }
}

// in: [A, B] row-major, A <= NARROW.  out: [B, A].
__global__ void channels_to_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                                        int A, long long B) {
  __shared__ float s[ROWS * (NARROW + 1)];
  const int pitch = A | 1;
  const long long col0 = (long long)blockIdx.x * ROWS;
  const long long cols = min((long long)ROWS, B - col0);
  if (threadIdx.x < cols) {
    for (int r = 0; r < A; ++r) s[threadIdx.x * pitch + r] = in[(long long)r * B + col0 + threadIdx.x];
  }
  __syncthreads();
  float* dst = out + col0 * A;
  const int total = (int)cols * A;
  for (int i = threadIdx.x; i < total; i += ROWS) dst[i] = s[(i / A) * pitch + (i % A)];
}

// in: [A, ld] row-major, the first B columns are used.  out: [B, A].
// One 32x32 tile per block (1-D grid over tiles), 32x8 threads.
__global__ void tiled_transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                       long long A, long long B, long long ld) {
  __shared__ float tile[TILE][TILE + 1];
  const long long tiles_b = (B + TILE - 1) / TILE;
  const long long ta = blockIdx.x / tiles_b, tb = blockIdx.x % tiles_b;
  const long long a0 = ta * TILE, b0 = tb * TILE;
  for (int j = threadIdx.y; j < TILE; j += 8) {
    const long long a = a0 + j, b = b0 + threadIdx.x;
    if (a < A && b < B) tile[j][threadIdx.x] = in[a * ld + b];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TILE; j += 8) {
    const long long b = b0 + j, a = a0 + threadIdx.x;
    if (a < A && b < B) out[b * A + a] = tile[threadIdx.x][j];
  }
}

// 16 bytes per thread where both pointers allow it, bytes for the rest
__global__ void materialize_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                   long long nbytes, long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int4* in4 = (const int4*)in;
  int4* out4 = (int4*)out;
  for (long long i = t; i < nvec; i += stride) out4[i] = in4[i];
  for (long long i = nvec * 16 + t; i < nbytes; i += stride) out[i] = in[i];
}

int tiled(const float* in, float* out, long long A, long long B, long long ld, cudaStream_t stream) {
  const long long tiles = ((A + TILE - 1) / TILE) * ((B + TILE - 1) / TILE);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  tiled_transpose_kernel<<<(unsigned)tiles, dim3(TILE, 8), 0, stream>>>(in, out, A, B, ld);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x [A, B] -> out [B, A]
int transpose2d(const void* x, void* out, long long A, long long B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* in = (const float*)x;
  float* o = (float*)out;
  if (A == 0 || B == 0) return 0;
  if (B <= NARROW) {
    rows_to_channels_kernel<<<(unsigned)((A + ROWS - 1) / ROWS), ROWS, 0, st>>>(in, o, A, (int)B, (int)B);
    return (int)cudaGetLastError();
  }
  if (A <= NARROW) {
    channels_to_rows_kernel<<<(unsigned)((B + ROWS - 1) / ROWS), ROWS, 0, st>>>(in, o, (int)A, B);
    return (int)cudaGetLastError();
  }
  return tiled(in, o, A, B, B, st);
}

// x [V, P] -> out [C, V], C <= P
int transpose_slice(const void* x, void* out, long long V, long long P, long long C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* in = (const float*)x;
  float* o = (float*)out;
  if (V == 0 || C == 0) return 0;
  if (P <= NARROW) {
    rows_to_channels_kernel<<<(unsigned)((V + ROWS - 1) / ROWS), ROWS, 0, st>>>(in, o, V, (int)P, (int)C);
    return (int)cudaGetLastError();
  }
  return tiled(in, o, V, C, P, st);
}

// out[0:nbytes] = x[0:nbytes]; both pointers 16-byte aligned
int materialize(const void* x, void* out, long long nbytes, void* stream) {
  if (nbytes == 0) return 0;
  const long long nvec = nbytes / 16;
  long long blocks = (nvec + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  materialize_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, nbytes, nvec);
  return (int)cudaGetLastError();
}

}  // extern "C"
