// Existence mask sweep: stage A of the pruned all-pairs search.
//
// Replaces the Pallas TPU kernels make_exists_mask_sweep_pallas /
// _exists_mask_sweep_kernel_body and make_exists_mask_kernel_pallas (every
// step valid) in hydrus_video_deduplicator_tpu/ops/similarity_segments.py.
// For one row tile against the whole stacked column corpus it writes
//
//   out[i*8 + w, j*256 + s*64 + c], bit b == 1  <=>  row slot 32w+b of row
//   block i and column slot c of chunk s of column step j hold a frame
//   pair at Hamming distance <= tol;  steps with valid[j] == 0 are zeros.
//
// Design: the frame distances run on the tensor cores (hamming_mma.cuh:
// two binary products mma.sync.m16n8k256.b1.and.popc give popc(a ^ b) for
// 16 x 8 whole hashes, and c = -(tol + 1) makes a match the sign bit), as
// in similarity_segments.cu, whose core this kernel shares. Each warp
// holds eight 16-frame row fragments in registers as bits and complements
// (64 registers a thread); a block holds the 2048 row frames of row
// block i and walks the four 512-frame column chunks of step j, each
// staged once in shared memory as words and complements, word-major with
// a stride of 520 words. The epilogue of a product is the OR of its
// accumulators' sign bits and, every four column fragments, one
// __any_sync; only a warp holding a match takes the slow path, which
// computes the four fragments again and sets one bit per matching pair in
// an [8 x 256] word tile in shared memory (atomicOr). The tile's nonzero
// words are stored into the output once per (step, row block); the output
// was zeroed first (cudaMemsetAsync), so an invalid step and an empty tile
// write nothing. No counters, no frame counts, no per-frame
// masks: this is the lightest of the three Hamming kernels in shared
// memory (the chunk's words and complements, the tile and the slot ids).
//
// Padding is decided BY SLOT ID: -1, and ids outside a block's slot range
// (a row id >= 256 or a column id >= 64), like the plain version's one-hot
// reduction. Such a frame's words and complement are all ones, so its
// "distance" to any frame is at least 256 and never within tol (< 128); an
// all-zero packed frame is a valid hash and stays one. A 32-frame run of
// column padding (four fragments) is skipped, and so is a row fragment of
// 16 padding frames.
//
// Occupancy: 16 warps a block, eight row fragments each, hold the whole
// 2048-frame row block at one block per SM (512 threads, 128 registers).
// Half a row block per block at two blocks per SM (8 warps) was 2-3 %
// slower on an NVIDIA H100 80GB HBM3 at 700 W: staging each column chunk
// twice costs what the overlap gains.
//
// What bounds it on the H100: the binary products, 512 operations per real
// frame pair at the b1 rate mma_rates.py measured (chip_smoke.py
// B1_OPS_PER_S); the row frames stay in registers and each column byte is
// read once per row block.

#include <cuda_runtime.h>

#include <cstdint>

#include "hamming_mma.cuh"

namespace {

constexpr int kRowFrames = 2048;
constexpr int kRowSlots = 256;
constexpr int kMaskWords = kRowSlots / 32;  // 8
constexpr int kChunkFrames = 512;
constexpr int kChunkSlots = 64;
constexpr int kSplit = 4;
constexpr int kStepFrames = kSplit * kChunkFrames;  // 2048
constexpr int kStepSlots = kSplit * kChunkSlots;    // 256
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kFragsPerWarp = 8;                              // row fragments of 16 frames
constexpr int kGroups = kChunkFrames / 8;                     // column fragments of 8 frames
constexpr int kStride = kChunkFrames + 8;                     // staged words, word-major
constexpr int kTile = kMaskWords * kStepSlots;                // output words per block
static_assert(16 * kFragsPerWarp * kWarps == kRowFrames, "a block holds its row block");
static_assert(kGroups == 64, "one bit of glive per column fragment");

// dynamic shared memory, in this order: the chunk's words and their
// complements, the output tile, the row and column slot ids, the live
// column fragments
constexpr int kOffNb = 4 * hmma::kWords * kStride;
constexpr int kOffTile = 2 * kOffNb;
constexpr int kOffRslot = kOffTile + 4 * kTile;
constexpr int kOffCslot = kOffRslot + 4 * kRowFrames;
constexpr int kOffGlive = kOffCslot + 4 * kChunkFrames;
constexpr int kSmemBytes = kOffGlive + 8;
static_assert(kOffGlive % 8 == 0, "64-bit word stays aligned");

__device__ __forceinline__ int in_range(int v, int n) { return (v >= 0 && v < n) ? v : -1; }

// One block per (column step j = blockIdx.x, row block i = blockIdx.y).
__global__ void __launch_bounds__(kThreads, 1)
exists_mask_sweep_kernel(const unsigned* __restrict__ a,
                         const int* __restrict__ slot_a,
                         const unsigned* __restrict__ b,
                         const int* __restrict__ slot_b,
                         const int* __restrict__ valid,
                         unsigned* __restrict__ out, int n_steps, int tol) {
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  if (valid[j] == 0) return;  // the output is already zero

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_b = reinterpret_cast<unsigned*>(smem);
  unsigned* s_nb = reinterpret_cast<unsigned*>(smem + kOffNb);
  unsigned* s_tile = reinterpret_cast<unsigned*>(smem + kOffTile);  // [w * 256 + col]
  int* s_rslot = reinterpret_cast<int*>(smem + kOffRslot);
  int* s_cslot = reinterpret_cast<int*>(smem + kOffCslot);
  unsigned long long* s_glive = reinterpret_cast<unsigned long long*>(smem + kOffGlive);

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int q = lane % 4;       // this thread's place in its fragments
  const int bias = -(tol + 1);  // distance - tol - 1 < 0 <=> distance <= tol
  const long long row0 = (long long)i * kRowFrames;

  for (int k = t; k < kTile; k += kThreads) s_tile[k] = 0u;
  for (int k = t; k < kRowFrames; k += kThreads) s_rslot[k] = in_range(slot_a[row0 + k], kRowSlots);
  // this warp's row fragments r: frames 16 * (warp + kWarps * r) + g (+ 8)
  hmma::Rows rows[kFragsPerWarp];
  unsigned live = 0u;  // bit r: fragment r holds a real frame (uniform in the warp)
#pragma unroll
  for (int r = 0; r < kFragsPerWarp; ++r) {
    const int lo = 16 * (warp + kWarps * r) + g;
    const bool live_lo = in_range(slot_a[row0 + lo], kRowSlots) >= 0;
    const bool live_hi = in_range(slot_a[row0 + lo + 8], kRowSlots) >= 0;
    hmma::load_rows(rows[r], live_lo ? a + 8 * (row0 + lo) : nullptr,
                    live_hi ? a + 8 * (row0 + lo + 8) : nullptr, q);
    if (__any_sync(0xffffffffu, live_lo || live_hi)) live |= 1u << r;
  }

  for (int s = 0; s < kSplit; ++s) {
    __syncthreads();  // the previous chunk is consumed
    if (t == 0) *s_glive = 0ull;
    __syncthreads();
    const long long base = (long long)j * kStepFrames + s * kChunkFrames;
    for (int f = t; f < kChunkFrames; f += kThreads) {
      const int cs = in_range(slot_b[base + f], kChunkSlots);
      s_cslot[f] = cs;
      const unsigned m = __ballot_sync(0xffffffffu, cs >= 0);  // fragments (f - lane) / 8 + 0..3
      if (lane == 0 && m) {
        unsigned long long bits = 0ull;
        for (int k = 0; k < 4; ++k) {
          bits |= (unsigned long long)(((m >> (8 * k)) & 0xffu) != 0u) << (f / 8 + k);
        }
        atomicOr(s_glive, bits);
      }
    }
    for (int k = t; k < hmma::kWords * kChunkFrames; k += kThreads) {
      const int f = k % kChunkFrames;
      const bool real = in_range(slot_b[base + f], kChunkSlots) >= 0;
      hmma::stage_col(s_b, s_nb, kStride, f, k / kChunkFrames, real ? b + 8 * (base + f) : nullptr);
    }
    __syncthreads();

    hmma::sweep(rows, live, s_b, s_nb, kStride, *s_glive, kGroups, bias, lane,
                [&](int r, int rf, int col) {
                  const int rs = s_rslot[16 * (warp + kWarps * r) + rf];
                  atomicOr(&s_tile[(rs >> 5) * kStepSlots + s * kChunkSlots + s_cslot[col]],
                           1u << (rs & 31));
                });
  }
  __syncthreads();

  const long long stride = (long long)n_steps * kStepSlots;
  unsigned* out_blk = out + (long long)i * kMaskWords * stride + (long long)j * kStepSlots;
  for (int k = t; k < kTile; k += kThreads) {
    const unsigned w = s_tile[k];
    if (w != 0u) out_blk[(k / kStepSlots) * stride + (k % kStepSlots)] = w;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: a [n_row_blocks*2048, 8] int32, slot_a
// [n_row_blocks*2048] int32, b [n_steps*2048, 8] int32, slot_b
// [n_steps*2048] int32, valid [n_steps] int32, out [n_row_blocks*8,
// n_steps*256] int32. Zeroes out and launches on `stream` without
// synchronising; returns the CUDA error (0 on success).
extern "C" int hvd_exists_mask_sweep(const void* a, const void* slot_a,
                                     const void* b, const void* slot_b,
                                     const void* valid, void* out,
                                     int n_row_blocks, int n_steps, int tol,
                                     void* stream) {
  if (n_row_blocks <= 0 || n_row_blocks > 65535 || n_steps <= 0 || tol < 0 ||
      tol >= 128) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      exists_mask_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t out_bytes = (size_t)n_row_blocks * kMaskWords * (size_t)n_steps * kStepSlots * 4;
  err = cudaMemsetAsync(out, 0, out_bytes, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_steps, (unsigned)n_row_blocks);
  exists_mask_sweep_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      (const unsigned*)a, (const int*)slot_a, (const unsigned*)b, (const int*)slot_b,
      (const int*)valid, (unsigned*)out, n_steps, tol);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
