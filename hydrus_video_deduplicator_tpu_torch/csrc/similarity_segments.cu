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
//            out [n_row_blocks*8, n_steps*256] int32; and, given a hit
//            list, each hit once more as a record (row slot i*256 + 32w
//            + b, col, sim): the unpruned route reads the similarities
//            there instead of scoring its hits again on the host;
//   kCounts  ma alone, out [n_row_blocks*256, n_steps*256] int32 (kernel 6);
//
// fa, fb are the per-slot frame counts; column index col = j*256 + s*64 + cs
// for chunk s of column step j; steps with valid[j] == 0 are all zeros.
//
// Design: the frame distances run on the tensor cores (hamming_mma.cuh:
// two binary products mma.sync.m16n8k256.b1.and.popc give popc(a ^ b) for
// 16 x 8 whole hashes). One block of 16 warps per (column step j, row
// block i) holds the block's 2048 row frames in registers: each warp eight
// fragments of 16 frames, as bits and complements (64 registers a
// thread). It walks the step's four 512-frame column chunks, each staged
// once in shared memory as words and complements (33 KB), and multiplies
// every 8-frame column fragment with its row fragments. Padding is
// excluded BY SLOT ID (-1, and ids outside a block's slot range): such a
// frame's words and complement are all ones, so its "distance" to any
// frame is at least 256 and never within tol; an all-zero packed frame is
// a valid hash and stays one. The epilogue of a product is the OR of its
// accumulators' sign bits (d = distance - tol - 1) and, every four column
// fragments, one __any_sync. Only a warp holding a match takes the slow
// path, which computes the four fragments again and records "which slots
// did this frame match":
//
//   - each row frame has a 64-bit mask of the chunk's column slots it
//     matched, in shared memory (ma: one count per row frame and column
//     slot, however many of the slot's frames it matched);
//   - each column frame has a 256-bit row-slot mask (mb, likewise);
//
// both set with shared atomicOr. After a chunk with a match the block
// adds the set bits into one [256 x 64] u32 counter tile with shared
// atomicAdd, ma in the low half and mb in the high half (ma <= 2048,
// mb <= 512), and the epilogue reads each counter once, computes the
// integer similarity and writes it. A chunk without any match writes zeros.
//
// The hit list (mask mode, optional): a 64-bit counter, then `capacity`
// records of three int32. After a chunk's mask words are written, each
// warp adds the hits of its 32 words to the counter with one atomicAdd
// and writes each record at its place in the warp's range (a shuffle scan
// of the words' popcounts). The counter counts every hit of the launch;
// records past the capacity are not written, and the caller then decodes
// the mask instead. The records come in no particular order. The
// recording is a function out of line that works from the block's and
// the thread's indices and the shared counter tile: written inline, or
// handed values from the kernel's registers, it kept values live through
// the sweep and cost the tensor-core loop register moves (the mask mode
// ran 3-38 % slower on an H100 in those forms, PERF.md).
//
// Why binary and not int8: mma_rates.py measured on the H100
// 2.0e13 hash pairs/s for the b1 product (1.0e13 for the two-product
// distance) against 3.8e12 for int8 wgmma on ±1 frames, which also needs
// each frame expanded to 256 bytes in shared memory; an int8 wgmma form of
// this kernel was built and measured first (PERF.md) and was slower.
//
// Where the trouble is, and what the design does about it:
//   - Shared memory: the chunk stays 32 bytes a frame (and 32 for its
//     complement), no ±1 expansion; 143,120 bytes a block with the
//     counter tile (64 KB) and the masks. Columns stay bit-packed in device
//     memory: no expanded copy of the corpus exists anywhere.
//   - Registers: 512 threads at one block per SM leave 128 a thread; the
//     row fragments take 64 of them.
//   - Layouts: the m16n8k256 fragments take a frame's packed words as
//     they are (hamming_mma.cuh); columns are staged word-major with a
//     stride of 520 words, so a fragment's 32 loads hit 32 banks.
//   - The epilogue's budget: at the b1 rate an SM does about 40 hash pairs
//     per clock and its integer units about 64 simple operations, so the
//     no-match path costs half an OR per pair and a vote per 4,096 pairs.
//   - Dense tiles: every video matches itself on the unpruned route, so
//     the self-diagonal's fragments take the slow path (one compare per
//     accumulator and an atomicOr per matching pair); its cost is in the
//     measured times (chip_smoke phase 6 plants both diagonals).
//   - Padding waste: a 32-frame run of column padding (four fragments) is
//     skipped; so is a row fragment of 16 padding frames; padding inside a
//     live fragment is computed and never matches.
//   - Bound: real frame pairs x 512 int8 operations at 1,979 TOP/s, the
//     definition the popcount kernel it replaces was held to; the binary
//     products can run below it.

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
constexpr int kThreads = 32 * kWarps;                   // 512: one per chunk frame
constexpr int kFragsPerWarp = kRowFrames / 16 / kWarps;  // 8 row fragments of 16 frames
constexpr int kGroups = kChunkFrames / 8;                // column fragments of 8 frames
constexpr int kStride = kChunkFrames + 8;                // staged words, word-major
constexpr int kTile = kRowSlots * kChunkSlots;           // counters per chunk
static_assert(kThreads == kChunkFrames && kGroups == 64, "one thread per chunk frame");
static_assert(kMaskWords * kChunkSlots == kThreads, "one mask word a thread");

enum Mode { kSims = 0, kMask = 1, kCounts = 2 };

// dynamic shared memory, in this order: the chunk's words and their
// complements, the counter tile, the row frames' column-slot masks, the
// column frames' row-slot masks, the row and column slot ids, the
// per-slot frame counts (clamped to >= 1), the live column fragments and
// the "any match in the chunk" flag
constexpr int kOffNb = 4 * hmma::kWords * kStride;
constexpr int kOffCnt = 2 * kOffNb;
constexpr int kOffAmask = kOffCnt + 4 * kTile;
constexpr int kOffRowmask = kOffAmask + 8 * kRowFrames;
constexpr int kOffRslot = kOffRowmask + 4 * kMaskWords * kChunkFrames;
constexpr int kOffCslot = kOffRslot + 4 * kRowFrames;
constexpr int kOffFa = kOffCslot + 4 * kChunkFrames;
constexpr int kOffFb = kOffFa + 4 * kRowSlots;
constexpr int kOffFlags = kOffFb + 4 * kChunkSlots;
constexpr int kSmemBytes = kOffFlags + 16;
static_assert(kOffAmask % 8 == 0 && kOffFlags % 8 == 0, "64-bit words stay aligned");

__device__ __forceinline__ int in_range(int v, int n) { return (v >= 0 && v < n) ? v : -1; }

// The hit list's records of the mask word this thread of the mask epilogue
// wrote for chunk s (column slot t % 64, row slots 32 (t / 64) + its set
// bits); every thread of the block calls it, so a warp's shuffles see all
// 32 lanes (one word a thread: the static_assert above).
__device__ __noinline__ void record_hits(int* hits, int capacity, unsigned word, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned* s_cnt = reinterpret_cast<const unsigned*>(smem + kOffCnt);
  const int* s_fa = reinterpret_cast<const int*>(smem + kOffFa);
  const int* s_fb = reinterpret_cast<const int*>(smem + kOffFb);
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int w = t / kChunkSlots;
  const int cs = t % kChunkSlots;
  const int n = __popc(word);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total == 0) return;  // uniform in the warp
  unsigned long long at = 0ull;
  if (lane == 31) {
    at = atomicAdd(reinterpret_cast<unsigned long long*>(hits), (unsigned long long)total);
  }
  at = __shfl_sync(0xffffffffu, at, 31) + (unsigned long long)(incl - n);
  int* records = hits + 3;
  const int col = blockIdx.x * kStepSlots + s * kChunkSlots + cs;
  for (unsigned m = word; m != 0u && at < (unsigned long long)capacity; m &= m - 1, ++at) {
    const int row = w * 32 + __ffs((int)m) - 1;
    const unsigned v = s_cnt[row * kChunkSlots + cs];
    int* r = records + 3 * at;
    r[0] = blockIdx.y * kRowSlots + row;
    r[1] = col;
    r[2] = min(100 * (int)(v & 0xffffu) / s_fa[row], 100 * (int)(v >> 16) / s_fb[cs]);
  }
}

// One block per (column step j = blockIdx.x, row block i = blockIdx.y).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
similarity_segments_kernel(const unsigned* __restrict__ a,
                           const int* __restrict__ slot_a,
                           const int* __restrict__ counts_a,
                           const unsigned* __restrict__ b,
                           const int* __restrict__ slot_b,
                           const int* __restrict__ counts_b,
                           const int* __restrict__ valid,
                           int* __restrict__ out, int n_steps, int tol,
                           int min_sim, int* __restrict__ hits, int capacity) {
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

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_b = reinterpret_cast<unsigned*>(smem);
  unsigned* s_nb = reinterpret_cast<unsigned*>(smem + kOffNb);
  unsigned* s_cnt = reinterpret_cast<unsigned*>(smem + kOffCnt);
  unsigned long long* s_amask = reinterpret_cast<unsigned long long*>(smem + kOffAmask);
  unsigned* s_rowmask = reinterpret_cast<unsigned*>(smem + kOffRowmask);  // [c*8 + w]
  int* s_rslot = reinterpret_cast<int*>(smem + kOffRslot);
  int* s_cslot = reinterpret_cast<int*>(smem + kOffCslot);
  int* s_fa = reinterpret_cast<int*>(smem + kOffFa);
  int* s_fb = reinterpret_cast<int*>(smem + kOffFb);
  unsigned long long* s_glive = reinterpret_cast<unsigned long long*>(smem + kOffFlags);
  int* s_any = reinterpret_cast<int*>(smem + kOffFlags + 8);

  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int q = lane % 4;  // this thread's place in its fragments
  const int bias = -(tol + 1);  // distance - bias - 1 < 0 <=> distance <= tol
  const long long row0 = (long long)i * kRowFrames;

  if (kBothWays && t < kRowSlots) s_fa[t] = max(counts_a[i * kRowSlots + t], 1);
  for (int k = t; k < kMaskWords * kChunkFrames; k += kThreads) s_rowmask[k] = 0u;
  for (int k = t; k < kRowFrames; k += kThreads) {
    s_rslot[k] = in_range(slot_a[row0 + k], kRowSlots);
    s_amask[k] = 0ull;
  }
  // this warp's row fragments r: frames 16 * (warp + 16 r) + g (+ 8)
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
    const long long base = (long long)j * kStepFrames + s * kChunkFrames;
    if (t == 0) {
      *s_any = 0;
      *s_glive = 0ull;
    }
    if (kBothWays && t < kChunkSlots) {
      s_fb[t] = max(counts_b[(long long)j * kStepSlots + s * kChunkSlots + t], 1);
    }
    __syncthreads();
    {
      const int cs = in_range(slot_b[base + t], kChunkSlots);  // chunk frame t
      s_cslot[t] = cs;
      const unsigned m = __ballot_sync(0xffffffffu, cs >= 0);  // this warp's 4 fragments
      if (lane == 0 && m) {
        unsigned long long bits = 0ull;
        for (int k = 0; k < 4; ++k) bits |= (unsigned long long)(((m >> (8 * k)) & 0xffu) != 0u) << (4 * warp + k);
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
                  const int row = 16 * (warp + kWarps * r) + rf;
                  atomicOr(&s_amask[row], 1ull << s_cslot[col]);
                  if (kBothWays) {
                    const int rs = s_rslot[row];
                    atomicOr(&s_rowmask[col * kMaskWords + (rs >> 5)], 1u << (rs & 31));
                  }
                  *s_any = 1;
                });
    __syncthreads();

    int* out_chunk = out_blk + s * kChunkSlots;
    if (!*s_any) {
      // no frame pair of the chunk matched: every count is 0, and so is
      // every output (min_sim >= 1 in the mask mode); nothing was set
      for (int k = t; k < kOutRows * kChunkSlots; k += kThreads) {
        out_chunk[(k / kChunkSlots) * stride + (k % kChunkSlots)] = 0;
      }
      continue;
    }

    for (int k = t; k < kTile; k += kThreads) s_cnt[k] = 0u;
    __syncthreads();
    // ma: a row frame adds 1 at (its slot, cs) for each column slot cs it
    // matched; its mask is cleared for the next chunk
    for (int r = t; r < kRowFrames; r += kThreads) {
      unsigned long long m = s_amask[r];
      if (m == 0ull) continue;
      s_amask[r] = 0ull;
      const int rs = s_rslot[r];  // >= 0: only real frames match
      while (m) {
        const int cs = __ffsll((long long)m) - 1;
        m &= m - 1;
        atomicAdd(&s_cnt[rs * kChunkSlots + cs], 1u);
      }
    }
    // mb: a column frame adds 1 << 16 at (rs, its slot) for each row slot
    // rs it matched; its mask is cleared for the next chunk
    if (kBothWays) {
      for (int k = t; k < kMaskWords * kChunkFrames; k += kThreads) {
        unsigned m = s_rowmask[k];
        if (m == 0u) continue;
        s_rowmask[k] = 0u;
        const int cs = s_cslot[k / kMaskWords];
        const int row0w = (k % kMaskWords) * 32;
        while (m) {
          const int bit = __ffs((int)m) - 1;
          m &= m - 1;
          atomicAdd(&s_cnt[(row0w + bit) * kChunkSlots + cs], 1u << 16);
        }
      }
    }
    __syncthreads();

    // epilogue: each counter is read and turned into the output by one thread
    if (MODE == kMask) {
      unsigned word_kept = 0u;
      for (int k = t; k < kMaskWords * kChunkSlots; k += kThreads) {
        const int w = k / kChunkSlots;
        const int cs = k % kChunkSlots;
        unsigned word = 0u;
        for (int bit = 0; bit < 32; ++bit) {
          const int row = w * 32 + bit;
          const unsigned v = s_cnt[row * kChunkSlots + cs];
          if (v == 0u) continue;  // sim 0 < min_sim
          const int sim = min(100 * (int)(v & 0xffffu) / s_fa[row],
                              100 * (int)(v >> 16) / s_fb[cs]);
          if (sim >= min_sim) word |= 1u << bit;
        }
        out_chunk[w * stride + cs] = (int)word;
        word_kept = word;
      }
      if (hits != nullptr) record_hits(hits, capacity, word_kept, s);
    } else {
      for (int k = t; k < kTile; k += kThreads) {
        const int row = k / kChunkSlots;
        const int cs = k % kChunkSlots;
        const unsigned v = s_cnt[k];
        int val = 0;
        if (v != 0u) {
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
           int tol, int min_sim, void* hits, int capacity, cudaStream_t stream) {
  auto kernel = similarity_segments_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (hits != nullptr) {
    err = cudaMemsetAsync(hits, 0, sizeof(unsigned long long), stream);  // the counter
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n_steps, (unsigned)n_row_blocks);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      (const unsigned*)a, (const int*)slot_a, (const int*)counts_a,
      (const unsigned*)b, (const int*)slot_b, (const int*)counts_b,
      (const int*)valid, (int*)out, n_steps, tol, min_sim, (int*)hits, capacity);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: a [n_row_blocks*2048, 8] int32, slot_a
// [n_row_blocks*2048] int32, counts_a [n_row_blocks*256] int32, b
// [n_steps*2048, 8] int32, slot_b [n_steps*2048] int32, counts_b
// [n_steps*256] int32, valid [n_steps] int32; out as MODE says (mode 0
// sims, 1 mask, 2 counts; counts_a and counts_b may be null in mode 2).
// hits, mode 1 only and else null: an 8-byte aligned int32 buffer
// [capacity + 1, 3], its first two words the 64-bit hit counter (zeroed
// here before the launch), then `capacity` records (row slot, column
// slot, similarity). Launches on `stream` without synchronising and
// returns the CUDA error (0 on success).
extern "C" int hvd_similarity_segments(const void* a, const void* slot_a,
                                       const void* counts_a, const void* b,
                                       const void* slot_b, const void* counts_b,
                                       const void* valid, void* out,
                                       int n_row_blocks, int n_steps, int tol,
                                       int mode, int min_sim, void* hits,
                                       int capacity, void* stream) {
  if (n_row_blocks <= 0 || n_row_blocks > 65535 || n_steps <= 0 || tol < 0 ||
      tol >= 128) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode != kCounts && (counts_a == nullptr || counts_b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (hits != nullptr &&
      (mode != kMask || capacity < 0 || reinterpret_cast<uintptr_t>(hits) % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kSims:
      return launch<kSims>(a, slot_a, counts_a, b, slot_b, counts_b, valid, out,
                           n_row_blocks, n_steps, tol, min_sim, nullptr, 0, st);
    case kMask:
      if (min_sim < 1) return (int)cudaErrorInvalidValue;
      return launch<kMask>(a, slot_a, counts_a, b, slot_b, counts_b, valid, out,
                           n_row_blocks, n_steps, tol, min_sim, hits, capacity, st);
    case kCounts:
      return launch<kCounts>(a, slot_a, counts_a, b, slot_b, counts_b, valid,
                             out, n_row_blocks, n_steps, tol, min_sim, nullptr, 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
