// Layout kernels for Hopper (sm_90a): float32 transposes and a raw copy.
//
// They replace the Pallas TPU kernels of poseprobe_tpu/ops/pallas/layout.py:
//   transpose2d     [A, B] -> [B, A]
//   transpose_slice [V, P] -> [C, V]   (first C of P columns, transposed)
//   materialize     identity copy into a fresh buffer
// whose job on the TPU was to move a grid between the channel-major
// [C, X, Y, Z] layout it is stored in and the row-major [V, P] rows the
// gather and the scatter-add worked on. The port's trilinear kernels work on
// [C, X, Y, Z] itself, so the two transposes run on no path; they are held
// against their twins and timed.
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

// One 16-byte vector per thread in a single pass over a grid of nbytes / 4 KB
// blocks (no grid-stride loop), loaded and stored with the streaming hints
// (evict-first: nothing is read again); the last nbytes % 16 bytes one by one.
// The designs below are what it was chosen against (`materialize_design`).
constexpr int COPY_THREADS = 256;

__global__ void __launch_bounds__(COPY_THREADS)
    materialize_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                       long long nbytes, long long nvec) {
  const long long i = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (i < nvec) __stcs((int4*)out + i, __ldcs((const int4*)in + i));
  if (i < nbytes - nvec * 16) out[nvec * 16 + i] = in[nvec * 16 + i];
}

// ------------------------------------------------ copy designs, for comparison
// Two other ways to keep bytes in flight, kept so that chip_smoke.py can time
// them beside materialize_kernel on the same buffers; nothing in the port calls
// them. The last nbytes % 16 bytes are copied by block 0 one by one.

// Four independent 16-byte loads per thread before their four stores, in a
// grid-stride loop over a grid sized to the SM count.
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(COPY_THREADS)
    copy_unrolled_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long nbytes,
                         long long nvec) {
  const int4* vin = (const int4*)in;
  int4* vout = (int4*)out;
  const long long stride = (long long)gridDim.x * COPY_THREADS * UNROLL;
  for (long long i0 = (long long)blockIdx.x * COPY_THREADS * UNROLL + threadIdx.x; i0 < nvec; i0 += stride) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * COPY_THREADS < nvec) v[u] = __ldcs(vin + i0 + u * COPY_THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * COPY_THREADS < nvec) __stcs(vout + i0 + u * COPY_THREADS, v[u]);
  }
  if (blockIdx.x == 0 && threadIdx.x < nbytes - nvec * 16) out[nvec * 16 + threadIdx.x] = in[nvec * 16 + threadIdx.x];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A ring of BULK_STAGES shared-memory chunks per block: one thread bulk-copies
// chunks global -> shared (completion on an mbarrier per stage) BULK_STAGES - 1
// ahead, and each full chunk shared -> global; a stage is loaded again once the
// store out of it has read it (cp.async.bulk.wait_group.read).
constexpr int BULK_STAGES = 4;
constexpr int BULK_CHUNK = 16384;
constexpr int BULK_SMEM = BULK_STAGES * BULK_CHUNK;

__global__ void __launch_bounds__(32)
    copy_bulk_ring_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long nbytes,
                          long long nvec) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[BULK_STAGES];
  const long long body = nvec * 16;
  if (threadIdx.x == 0) {
    const long long nch = (body + BULK_CHUNK - 1) / BULK_CHUNK;
    const long long mine = nch > blockIdx.x ? (nch - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
    for (int s = 0; s < BULK_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    auto span = [&](long long k, long long& off) {
      off = (blockIdx.x + k * gridDim.x) * (long long)BULK_CHUNK;
      return (uint32_t)min((long long)BULK_CHUNK, body - off);
    };
    auto load = [&](long long k) {
      long long off;
      const uint32_t bytes = span(k, off);
      const int s = (int)(k % BULK_STAGES);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(full + s)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_u32(ring + s * BULK_CHUNK)),
          "l"(in + off), "r"(bytes), "r"(smem_u32(full + s))
          : "memory");
    };
    for (long long k = 0; k < min((long long)BULK_STAGES - 1, mine); ++k) load(k);
    for (long long k = 0; k < mine; ++k) {
      const int s = (int)(k % BULK_STAGES);
      const uint32_t parity = (uint32_t)((k / BULK_STAGES) & 1);
      asm volatile(
          "{\n.reg .pred P1;\nWAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
          "@!P1 bra WAIT;\n}\n" ::"r"(smem_u32(full + s)),
          "r"(parity)
          : "memory");
      long long off;
      const uint32_t bytes = span(k, off);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(out + off),
                   "r"(smem_u32(ring + s * BULK_CHUNK)), "r"(bytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (k + BULK_STAGES - 1 < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");  // the store of chunk k - 1
        load(k + BULK_STAGES - 1);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  if (blockIdx.x == 0 && threadIdx.x < nbytes - body) out[body + threadIdx.x] = in[body + threadIdx.x];
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
  const long long blocks = nvec > 0 ? (nvec + COPY_THREADS - 1) / COPY_THREADS : 1;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  materialize_kernel<<<(unsigned)blocks, COPY_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, nbytes, nvec);
  return (int)cudaGetLastError();
}

// The same copy by one of the designs materialize_kernel was chosen against:
// design 1 and 2 copy_unrolled_kernel over 4 and 8 blocks of 256 per SM,
// design 3 copy_bulk_ring_kernel over 2 blocks per SM.
int materialize_design(const void* x, void* out, long long nbytes, int design, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (nbytes == 0) return 0;
  const uint8_t* in = (const uint8_t*)x;
  uint8_t* o = (uint8_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long nvec = nbytes / 16;
  if (design == 1 || design == 2) {
    copy_unrolled_kernel<<<sms * 4 * design, COPY_THREADS, 0, st>>>(in, o, nbytes, nvec);
  } else if (design == 3) {
    cudaError_t err = cudaFuncSetAttribute(copy_bulk_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           BULK_SMEM);
    if (err != cudaSuccess) return (int)err;
    copy_bulk_ring_kernel<<<sms * 2, 32, BULK_SMEM, st>>>(in, o, nbytes, nvec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
