// Bucketed video-pair similarity: the unpruned search's long-video kernel.
//
// Replaces the Pallas TPU kernel similarity_block_pallas / _make_kernel in
// hydrus_video_deduplicator_tpu/ops/similarity_pallas.py. For a tile of row
// videos (each padded to pa frames) against a tile of column videos (each
// padded to pb frames), and for each pair (row video i, column video j), it
// counts
//
//   ma = real frames of i at Hamming distance <= 31 of some real frame of j,
//   mb = real frames of j at distance <= 31 of some real frame of i,
//
// and writes sim = min(100*ma / max(fa,1), 100*mb / max(fb,1)) into
// out [n_rows, n_cols] int32, 0 when either video is empty. fa, fb are the
// videos' frame counts; frames at or past a count are padding.
//
// The TPU kernel expands frames to ±1 int8 rows, pads with all-zero rows
// (dot 0 never matches), and reduces to videos with one-hot MXU products;
// its N_SPLIT column chunks and its pa*pb <= 64 limit exist because its
// int32 accumulator lives in VMEM. None of that carries over. Here the
// bit-packed frames are read directly and a distance is __popc of the XOR
// of the 8 words. Padding is excluded BY COUNT, never by value: an
// all-zero packed frame is a valid hash. One block per (row video, column
// group) holds the row video's <= 1024 frames in registers (4 per thread)
// and loops over its group's column videos, one at a time, each staged in
// shared memory up to its real frame count:
//
//   - each thread ORs "this row frame matched" across the column video;
//     ma is the sum of four __syncthreads_count;
//   - a 1024-bit array in shared memory records "this column frame
//     matched" through atomicOr; mb is the __popc of its 32 words, summed
//     by one warp, which also clears it for the next column video.
//
// The column groups (gridDim.y) give the grid about kTargetBlocks blocks
// whatever the number of row videos: the route's row tiles hold the few
// long videos of a checkpoint chunk.
//
// What bounds it on the H100: integer issue, as for the other popcount
// kernels. Each frame pair costs 8 XOR, 8 POPC and 7 adds; POPC issues at
// 16 per SM per clock, so about 264 frame pairs per clock across the 132
// SMs, some ten times below the int8 tensor-core rate that would compute
// the same matches as ±1 dot products. Loops run to each video's real
// frame count, so the work is the real frame pairs, not the padded ones.
// Making it fast (int8 mma / wgmma on ±1 rows, TMA, several column videos
// per pass) is later work; the results stay the same.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 1024;                       // largest bucket
constexpr int kRowsPerThread = kMaxFrames / kThreads;  // 4
constexpr int kHitWords = kMaxFrames / 32;             // 32: one per lane
constexpr int kTol = 31;                               // match: distance <= 31
constexpr int kTargetBlocks = 2048;
constexpr int kMaxGroups = 65535;

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// One block per (row video i = blockIdx.x, column group blockIdx.y); the
// group takes column videos blockIdx.y, blockIdx.y + gridDim.y, ...
__global__ void __launch_bounds__(kThreads)
similarity_block_kernel(const uint4* __restrict__ a,
                        const int* __restrict__ counts_a,
                        const uint4* __restrict__ b,
                        const int* __restrict__ counts_b,
                        int* __restrict__ out, int n_cols, int pa, int pb) {
  __shared__ uint4 s_frames[2 * kMaxFrames];  // one column video, 32 KB
  __shared__ unsigned s_hit[kHitWords];       // column frames that matched

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int fa = max(counts_a[i], 1);
  const int na = min(max(counts_a[i], 0), pa);  // real row frames

  // this thread's row frames t, t+256, t+512, t+768 below na
  uint4 ra[kRowsPerThread][2];
  const int nr = t < na ? (na - t + kThreads - 1) / kThreads : 0;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (r < nr) {
      const long long f = (long long)i * pa + r * kThreads + t;
      ra[r][0] = a[2 * f];
      ra[r][1] = a[2 * f + 1];
    }
  }
  if (t < kHitWords) s_hit[t] = 0u;

  for (int j = blockIdx.y; j < n_cols; j += gridDim.y) {
    const int nb = min(max(counts_b[j], 0), pb);  // uniform across the block
    int* o = out + (long long)i * n_cols + j;
    if (na == 0 || nb == 0) {  // an empty video scores 0 against anything
      if (t == 0) *o = 0;
      continue;
    }
    __syncthreads();  // the previous column video is consumed, s_hit clear
    const uint4* bj = b + 2LL * j * pb;
    for (int k = t; k < 2 * nb; k += kThreads) s_frames[k] = bj[k];
    __syncthreads();

    bool hit[kRowsPerThread] = {false, false, false, false};
    for (int c = 0; c < nb; ++c) {
      const uint4 b0 = s_frames[2 * c];
      const uint4 b1 = s_frames[2 * c + 1];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (r < nr && hamming(ra[r][0], ra[r][1], b0, b1) <= kTol) {
          hit[r] = true;
          any = true;
        }
      }
      if (any) atomicOr(&s_hit[c >> 5], 1u << (c & 31));
    }
    int ma = 0;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) ma += __syncthreads_count(hit[r]);
    // past those barriers every atomicOr has landed
    if (t < kHitWords) {
      const unsigned w = s_hit[t];
      s_hit[t] = 0u;
      const unsigned mb = __reduce_add_sync(0xffffffffu, (unsigned)__popc(w));
      if (t == 0) {
        const int fb = max(counts_b[j], 1);
        *o = min(100 * ma / fa, 100 * (int)mb / fb);
      }
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: a [n_rows, pa, 8] int32 bit-packed row frames,
// counts_a [n_rows] int32, b [n_cols, pb, 8] int32, counts_b [n_cols]
// int32, out [n_rows, n_cols] int32; 1 <= pa, pb <= 1024. Launches on
// `stream` without synchronising and returns the CUDA error (0 on success).
extern "C" int hvd_similarity_block(const void* a, const void* counts_a,
                                    const void* b, const void* counts_b,
                                    void* out, int n_rows, int n_cols, int pa,
                                    int pb, void* stream) {
  if (n_rows <= 0 || n_cols <= 0 || pa < 1 || pa > kMaxFrames || pb < 1 ||
      pb > kMaxFrames) {
    return (int)cudaErrorInvalidValue;
  }
  int groups = (kTargetBlocks + n_rows - 1) / n_rows;
  groups = groups < n_cols ? groups : n_cols;
  groups = groups < kMaxGroups ? groups : kMaxGroups;
  const dim3 grid((unsigned)n_rows, (unsigned)groups);
  similarity_block_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const int*)counts_a, (const uint4*)b,
      (const int*)counts_b, (int*)out, n_cols, pa, pb);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
