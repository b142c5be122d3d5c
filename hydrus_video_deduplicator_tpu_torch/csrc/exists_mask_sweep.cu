// Existence mask sweep: stage A of the pruned all-pairs search.
//
// Replaces the Pallas TPU kernel make_exists_mask_sweep_pallas /
// _exists_mask_sweep_kernel_body in
// hydrus_video_deduplicator_tpu/ops/similarity_segments.py. For one row
// tile against the whole stacked column corpus it writes
//
//   out[i*8 + w, j*256 + s*64 + c], bit b == 1  <=>  row slot 32w+b of row
//   block i and column slot c of chunk s of column step j hold a frame
//   pair at Hamming distance <= tol;  steps with valid[j] == 0 are zeros.
//
// The TPU kernel expands frames to ±1 int8 rows and runs three MXU
// products per chunk (the frame dot and two one-hot slot reductions). This
// first Hopper form reads the BIT-PACKED frames directly (8 words, 32 bytes
// per frame; no ±1 array in device memory) and computes each distance as
// __popc of the XOR of the 8 words; XOR and popcount do not depend on bit
// order, so the words of blobs_to_packed go in as they are. A match sets
// its bit with an atomicOr into a [8 x 256] word tile in shared memory,
// stored once at the end. Matches are rare (tolerance 79 lies about six
// standard deviations below the mean distance of unrelated hashes), so the
// atomics cost nothing measurable.
//
// Padding frames are excluded BY SLOT ID (-1), not by their data: in packed
// form an all-zero row is a valid hash with every bit clear.
//
// What bounds it on the H100: integer issue, not bytes. Each frame pair
// costs 8 XOR, 8 POPC and 7 adds, and POPC issues at a quarter of the
// ALU rate (16 per SM per clock), so the kernel is POPC-bound at about
// 16 x 132 / 8 = 264 frame pairs per clock across the card's 132 SMs.
// Each block reuses its column chunk, held in shared
// memory, across the 2048 row frames it keeps in registers (8 per
// thread), so device memory sees each column byte once per row block.
// Making it fast (int8 or b1 tensor-core MMA with wgmma, TMA, a
// persistent grid) is later work; the result bits stay the same.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowFrames = 2048;
constexpr int kRowSlots = 256;
constexpr int kMaskWords = kRowSlots / 32;  // 8
constexpr int kChunkFrames = 512;
constexpr int kChunkSlots = 64;
constexpr int kSplit = 4;
constexpr int kStepFrames = kSplit * kChunkFrames;  // 2048
constexpr int kStepSlots = kSplit * kChunkSlots;    // 256
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kRowFrames / kThreads;  // 8

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// One block per (column step j = blockIdx.x, row block i = blockIdx.y).
// a, b: frames as two uint4 each; slot ids -1 for padding.
__global__ void __launch_bounds__(kThreads)
exists_mask_sweep_kernel(const uint4* __restrict__ a,
                         const int* __restrict__ slot_a,
                         const uint4* __restrict__ b,
                         const int* __restrict__ slot_b,
                         const int* __restrict__ valid,
                         unsigned* __restrict__ out, int n_steps, int tol) {
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const long long out_stride = (long long)n_steps * kStepSlots;
  unsigned* out_blk =
      out + (long long)i * kMaskWords * out_stride + (long long)j * kStepSlots;

  if (valid[j] == 0) {
    for (int k = t; k < kMaskWords * kStepSlots; k += kThreads) {
      out_blk[(k / kStepSlots) * out_stride + (k % kStepSlots)] = 0u;
    }
    return;
  }

  __shared__ uint4 s_frames[kChunkFrames * 2];  // 16 KB: one column chunk
  __shared__ int s_slots[kChunkFrames];
  __shared__ unsigned s_tile[kMaskWords * kStepSlots];  // 8 KB: the output

  for (int k = t; k < kMaskWords * kStepSlots; k += kThreads) s_tile[k] = 0u;

  // this thread's row frames t, t+256, ..., t+7*256 of row block i
  uint4 ra[kRowsPerThread][2];
  int rs[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long f = (long long)i * kRowFrames + r * kThreads + t;
    ra[r][0] = a[2 * f];
    ra[r][1] = a[2 * f + 1];
    rs[r] = slot_a[f];
  }

  for (int s = 0; s < kSplit; ++s) {
    __syncthreads();  // the previous chunk is consumed
    const long long base = (long long)j * kStepFrames + s * kChunkFrames;
    for (int k = t; k < kChunkFrames * 2; k += kThreads) s_frames[k] = b[2 * base + k];
    for (int k = t; k < kChunkFrames; k += kThreads) s_slots[k] = slot_b[base + k];
    __syncthreads();
    for (int c = 0; c < kChunkFrames; ++c) {
      const int cs = s_slots[c];  // uniform across the block: no divergence
      if (cs < 0) continue;
      const uint4 b0 = s_frames[2 * c];
      const uint4 b1 = s_frames[2 * c + 1];
      const int col = s * kChunkSlots + cs;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (hamming(ra[r][0], ra[r][1], b0, b1) <= tol && rs[r] >= 0) {
          atomicOr(&s_tile[(rs[r] >> 5) * kStepSlots + col], 1u << (rs[r] & 31));
        }
      }
    }
  }
  __syncthreads();
  for (int k = t; k < kMaskWords * kStepSlots; k += kThreads) {
    out_blk[(k / kStepSlots) * out_stride + (k % kStepSlots)] = s_tile[k];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: a [n_row_blocks*2048, 8] int32, slot_a
// [n_row_blocks*2048] int32, b [n_steps*2048, 8] int32, slot_b
// [n_steps*2048] int32, valid [n_steps] int32, out [n_row_blocks*8,
// n_steps*256] int32. Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int hvd_exists_mask_sweep(const void* a, const void* slot_a,
                                     const void* b, const void* slot_b,
                                     const void* valid, void* out,
                                     int n_row_blocks, int n_steps, int tol,
                                     void* stream) {
  if (n_row_blocks <= 0 || n_row_blocks > 65535 || n_steps <= 0 || tol < 0 ||
      tol >= 128) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)n_steps, (unsigned)n_row_blocks);
  exists_mask_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const int*)slot_a, (const uint4*)b, (const int*)slot_b,
      (const int*)valid, (unsigned*)out, n_steps, tol);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
