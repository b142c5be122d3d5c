// Segment similarity: the unpruned all-pairs search's kernel.
//
// Replaces the Pallas TPU kernels similarity_segments_pallas /
// _segment_kernel and make_exists_kernel_pallas /
// _segment_exists_kernel_body in
// hydrus_video_deduplicator_tpu/ops/similarity_segments.py. For one row
// tile against the whole stacked column corpus, and for each (row slot rs,
// column slot cs), it counts
//
//   ma = row frames of rs at Hamming distance <= tol of some frame of cs,
//   mb = column frames of cs at distance <= tol of some frame of rs,
//
// and writes, by MODE (one template instantiation each):
//
//   kSims    sim = min(100*ma / max(fa,1), 100*mb / max(fb,1))
//            out [n_row_blocks*256, n_steps*256] int32 (kernel 3's contract);
//   kMask    sim >= min_sim, row-packed in the sweep's layout: bit b of
//            out[i*8 + w, col] <=> row slot 32w+b of row block i
//            out [n_row_blocks*8, n_steps*256] int32;
//   kCounts  ma alone, out [n_row_blocks*256, n_steps*256] int32 (kernel 6);
//
// fa, fb are the per-slot frame counts; column index col = j*256 + s*64 + cs
// for chunk s of column step j; steps with valid[j] == 0 are all zeros.
//
// The TPU kernel expands frames to ±1 int8 rows and runs five MXU products
// per chunk (the frame dot and four one-hot slot reductions). This Hopper
// form keeps the shape of the existence sweep (exists_mask_sweep.cu): the
// bit-packed frames are read directly, a distance is __popc of the XOR of
// the 8 words, one block per (column step, row block) holds its 2048 row
// frames in registers (8 per thread) and walks the step's four 512-frame
// column chunks through shared memory. Padding is excluded BY SLOT ID (-1,
// and ids outside a block's slot range): an all-zero packed row is a valid
// hash. The two directional counts come without double counting from two
// masks of "which slots did this frame match":
//
//   - each row frame keeps a 64-bit register mask of the column slots of
//     the chunk it matched (ma: one count per row frame and column slot,
//     however many of the slot's frames it matched);
//   - each column frame has a 256-bit row-slot mask in shared memory, set
//     with atomicOr (mb, likewise).
//
// After the chunk the block adds the set bits into one [256 x 64] u32
// counter tile in shared memory with shared atomicAdd, ma in the low half
// and mb in the high half (ma <= 2048, mb <= 512: each fits 16 bits), and
// the epilogue reads each counter once, computes the integer similarity,
// writes it and re-zeroes the counter. Matches are rare: outside the
// self-diagonal, tolerance 31 lies about twelve standard deviations below
// the mean distance of unrelated hashes, so a chunk whose block saw no
// match at all (__syncthreads_or) skips the counting and writes zeros.
//
// What bounds it on the H100: integer issue, as for the sweep. Each frame
// pair costs 8 XOR, 8 POPC and 7 adds; POPC issues at 16 per SM per clock,
// so about 264 frame pairs per clock across the 132 SMs. Shared memory is
// 101,632 bytes per block (opt-in dynamic shared memory): two blocks fit an
// SM, registers allow one. Making it fast (b1/int8 tensor-core MMA with
// wgmma, TMA, a persistent grid) is later work; the results stay the same.

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
constexpr int kTile = kRowSlots * kChunkSlots;         // counters per chunk

enum Mode { kSims = 0, kMask = 1, kCounts = 2 };

// dynamic shared memory, in this order: one column chunk's frames, the
// counter tile, the column frames' row-slot masks, the chunk's slot ids,
// the row block's and the chunk's per-slot frame counts (clamped to >= 1)
constexpr size_t kSmemBytes = sizeof(uint4) * 2 * kChunkFrames +
                              sizeof(unsigned) * kTile +
                              sizeof(unsigned) * kMaskWords * kChunkFrames +
                              sizeof(int) * (kChunkFrames + kRowSlots + kChunkSlots);

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// One block per (column step j = blockIdx.x, row block i = blockIdx.y).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
similarity_segments_kernel(const uint4* __restrict__ a,
                           const int* __restrict__ slot_a,
                           const int* __restrict__ counts_a,
                           const uint4* __restrict__ b,
                           const int* __restrict__ slot_b,
                           const int* __restrict__ counts_b,
                           const int* __restrict__ valid,
                           int* __restrict__ out, int n_steps, int tol,
                           int min_sim) {
  constexpr bool kBothWays = MODE != kCounts;  // mb and the fractions
  constexpr int kOutRows = MODE == kMask ? kMaskWords : kRowSlots;
  const int j = blockIdx.x;
  const int i = blockIdx.y;
  const int t = threadIdx.x;
  const long long stride = (long long)n_steps * kStepSlots;
  int* out_blk = out + (long long)i * kOutRows * stride + (long long)j * kStepSlots;

  if (valid[j] == 0) {
    for (int k = t; k < kOutRows * kStepSlots; k += kThreads) {
      out_blk[(k / kStepSlots) * stride + (k % kStepSlots)] = 0;
    }
    return;
  }

  extern __shared__ uint4 smem[];
  uint4* s_frames = smem;
  unsigned* s_cnt = reinterpret_cast<unsigned*>(smem + 2 * kChunkFrames);
  unsigned* s_rowmask = s_cnt + kTile;  // [c * 8 + w], bit b = row slot 32w+b
  int* s_slots = reinterpret_cast<int*>(s_rowmask + kMaskWords * kChunkFrames);
  int* s_fa = s_slots + kChunkFrames;
  int* s_fb = s_fa + kRowSlots;

  for (int k = t; k < kTile; k += kThreads) s_cnt[k] = 0u;
  for (int k = t; k < kMaskWords * kChunkFrames; k += kThreads) s_rowmask[k] = 0u;
  if (kBothWays) s_fa[t] = max(counts_a[i * kRowSlots + t], 1);

  // this thread's row frames t, t+256, ..., t+7*256 of row block i
  uint4 ra[kRowsPerThread][2];
  int rs[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long f = (long long)i * kRowFrames + r * kThreads + t;
    ra[r][0] = a[2 * f];
    ra[r][1] = a[2 * f + 1];
    const int v = slot_a[f];
    rs[r] = (v >= 0 && v < kRowSlots) ? v : -1;
  }

  for (int s = 0; s < kSplit; ++s) {
    __syncthreads();  // the previous chunk is consumed
    const long long base = (long long)j * kStepFrames + s * kChunkFrames;
    for (int k = t; k < 2 * kChunkFrames; k += kThreads) s_frames[k] = b[2 * base + k];
    for (int k = t; k < kChunkFrames; k += kThreads) {
      const int v = slot_b[base + k];
      s_slots[k] = (v >= 0 && v < kChunkSlots) ? v : -1;
    }
    if (kBothWays && t < kChunkSlots) {
      s_fb[t] = max(counts_b[(long long)j * kStepSlots + s * kChunkSlots + t], 1);
    }
    __syncthreads();

    unsigned long long amask[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) amask[r] = 0ull;
    for (int c = 0; c < kChunkFrames; ++c) {
      const int cs = s_slots[c];  // uniform across the block: no divergence
      if (cs < 0) continue;
      const uint4 b0 = s_frames[2 * c];
      const uint4 b1 = s_frames[2 * c + 1];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (hamming(ra[r][0], ra[r][1], b0, b1) <= tol && rs[r] >= 0) {
          amask[r] |= 1ull << cs;
          if (kBothWays) {
            atomicOr(&s_rowmask[c * kMaskWords + (rs[r] >> 5)], 1u << (rs[r] & 31));
          }
        }
      }
    }

    bool matched = false;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) matched |= amask[r] != 0ull;
    int* out_chunk = out_blk + s * kChunkSlots;
    if (!__syncthreads_or(matched)) {
      // no frame pair of the chunk matched: every count is 0, and so is
      // every output (min_sim >= 1 in the mask mode); nothing was set
      for (int k = t; k < kOutRows * kChunkSlots; k += kThreads) {
        out_chunk[(k / kChunkSlots) * stride + (k % kChunkSlots)] = 0;
      }
      continue;
    }

    // ma: a row frame adds 1 at (its slot, cs) for each column slot cs it
    // matched
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      unsigned long long m = amask[r];
      while (m) {
        const int cs = __ffsll((long long)m) - 1;
        m &= m - 1;
        atomicAdd(&s_cnt[rs[r] * kChunkSlots + cs], 1u);
      }
    }
    // mb: a column frame adds 1 << 16 at (rs, its slot) for each row slot
    // rs it matched; its mask is cleared for the next chunk
    if (kBothWays) {
      for (int k = t; k < kMaskWords * kChunkFrames; k += kThreads) {
        unsigned m = s_rowmask[k];
        if (m == 0u) continue;
        s_rowmask[k] = 0u;
        const int cs = s_slots[k / kMaskWords];  // >= 0: only real frames match
        const int row0 = (k % kMaskWords) * 32;
        while (m) {
          const int bit = __ffs((int)m) - 1;
          m &= m - 1;
          atomicAdd(&s_cnt[(row0 + bit) * kChunkSlots + cs], 1u << 16);
        }
      }
    }
    __syncthreads();

    // epilogue: each counter is read, turned into the output and re-zeroed
    // by one thread
    if (MODE == kMask) {
      for (int k = t; k < kMaskWords * kChunkSlots; k += kThreads) {
        const int w = k / kChunkSlots;
        const int cs = k % kChunkSlots;
        unsigned word = 0u;
        for (int bit = 0; bit < 32; ++bit) {
          const int row = w * 32 + bit;
          const unsigned v = s_cnt[row * kChunkSlots + cs];
          if (v == 0u) continue;  // sim 0 < min_sim
          s_cnt[row * kChunkSlots + cs] = 0u;
          const int sim = min(100 * (int)(v & 0xffffu) / s_fa[row],
                              100 * (int)(v >> 16) / s_fb[cs]);
          if (sim >= min_sim) word |= 1u << bit;
        }
        out_chunk[w * stride + cs] = (int)word;
      }
    } else {
      for (int k = t; k < kTile; k += kThreads) {
        const int row = k / kChunkSlots;
        const int cs = k % kChunkSlots;
        const unsigned v = s_cnt[k];
        int val = 0;
        if (v != 0u) {
          s_cnt[k] = 0u;
          if (MODE == kCounts) {
            val = (int)(v & 0xffffu);
          } else {
            val = min(100 * (int)(v & 0xffffu) / s_fa[row],
                      100 * (int)(v >> 16) / s_fb[cs]);
          }
        }
        out_chunk[row * stride + cs] = val;
      }
    }
  }
}

template <int MODE>
int launch(const void* a, const void* slot_a, const void* counts_a,
           const void* b, const void* slot_b, const void* counts_b,
           const void* valid, void* out, int n_row_blocks, int n_steps,
           int tol, int min_sim, cudaStream_t stream) {
  auto kernel = similarity_segments_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_steps, (unsigned)n_row_blocks);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      (const uint4*)a, (const int*)slot_a, (const int*)counts_a,
      (const uint4*)b, (const int*)slot_b, (const int*)counts_b,
      (const int*)valid, (int*)out, n_steps, tol, min_sim);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: a [n_row_blocks*2048, 8] int32, slot_a
// [n_row_blocks*2048] int32, counts_a [n_row_blocks*256] int32, b
// [n_steps*2048, 8] int32, slot_b [n_steps*2048] int32, counts_b
// [n_steps*256] int32, valid [n_steps] int32; out as MODE says (mode 0
// sims, 1 mask, 2 counts; counts_a and counts_b may be null in mode 2).
// Launches on `stream` without synchronising and returns the CUDA error
// (0 on success).
extern "C" int hvd_similarity_segments(const void* a, const void* slot_a,
                                       const void* counts_a, const void* b,
                                       const void* slot_b, const void* counts_b,
                                       const void* valid, void* out,
                                       int n_row_blocks, int n_steps, int tol,
                                       int mode, int min_sim, void* stream) {
  if (n_row_blocks <= 0 || n_row_blocks > 65535 || n_steps <= 0 || tol < 0 ||
      tol >= 128) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode != kCounts && (counts_a == nullptr || counts_b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kSims:
      return launch<kSims>(a, slot_a, counts_a, b, slot_b, counts_b, valid, out,
                           n_row_blocks, n_steps, tol, min_sim, st);
    case kMask:
      if (min_sim < 1) return (int)cudaErrorInvalidValue;
      return launch<kMask>(a, slot_a, counts_a, b, slot_b, counts_b, valid, out,
                           n_row_blocks, n_steps, tol, min_sim, st);
    case kCounts:
      return launch<kCounts>(a, slot_a, counts_a, b, slot_b, counts_b, valid,
                             out, n_row_blocks, n_steps, tol, min_sim, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
