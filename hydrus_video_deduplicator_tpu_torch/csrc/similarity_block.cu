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
// Design: the frame distances run on the tensor cores (hamming_mma.cuh),
// as in similarity_segments.cu: two binary products per 16 x 8 whole-hash
// pairs give their Hamming distances. One block of 8 warps per (row video
// i, column group) holds the row video's real frames in registers (each
// warp eight fragments of 16 frames, round-robin, as bits and
// complements) and walks its group's column units: a unit is 256 / pb
// column videos side by side when pb <= 256 (one 256-frame tile), or one
// column video of ceil(pb / 256) tiles when pb > 256. Each tile is staged
// once in shared memory as words and complements. Padding is excluded BY
// COUNT, never by value: frames at or past a video's count are all ones in
// both (their distance to anything is at least 256), while an all-zero
// real frame stays itself. The epilogue of a product is the OR of its
// accumulators' sign bits and, every four column fragments, a warp vote;
// only a warp holding a match computes them again and records it, in
// shared memory:
//
//   - ma: a bit per (row frame, column video of the unit), set with
//     atomicOr: an OR along the video's frames that crosses fragments,
//     tiles and warps;
//   - mb: a bit per column frame of the unit, set with atomicOr: an OR
//     down the row video's fragments, which belong to all the warps.
//
// After a unit with a match, one thread per column video counts its ma
// bits and the __popc of its mb bits and writes the similarity; a unit
// without any match writes zeros.
//
// Where the trouble is, and what the design does about it:
//   - Shared memory and registers: a 1024-frame row video is 64 fragments,
//     eight per warp, 64 registers a thread; the tile takes 17 KB and the
//     ma bits 32 KB (1024 rows x 256 videos): 50,824 bytes a block, two
//     blocks per SM at 128 registers a thread.
//   - Layouts, as in similarity_segments.cu: the packed words are the
//     fragments; columns are staged word-major, stride 264 words.
//   - The epilogue's budget: half an OR per pair and a vote per 4,096
//     pairs on the no-match path.
//   - Dense tiles: phase 8 of chip_smoke.py holds self-pairs scoring 100
//     (1024 x 1024) and near copies; the slow path is one compare per
//     accumulator and an atomicOr per matching pair, and its cost is in
//     the measured times.
//   - Padding waste: row fragments stop at the row video's real frames and
//     spread round-robin over the warps (a 600-frame video: 38 fragments,
//     five or four a warp); a 32-frame run of column padding is skipped;
//     padding inside a live fragment (counts between pb/2 and pb on the
//     route) is computed and never matches.
//   - Few rows per launch: the route's row tiles hold the ~38 long videos
//     of a checkpoint chunk, so the column groups (gridDim.y) give the
//     grid about kTargetBlocks blocks whatever the number of row videos.
//   - Bound: real frame pairs x 512 int8 operations at 1,979 TOP/s, the
//     definition the popcount kernel it replaces was held to; the binary
//     products can run below it.

#include <cuda_runtime.h>

#include <cstdint>

#include "hamming_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrames = 1024;                          // largest bucket
constexpr int kFragsPerWarp = kMaxFrames / 16 / kWarps;   // 8 row fragments of 16 frames
constexpr int kTileFrames = 256;                          // column frames per pass
constexpr int kGroups = kTileFrames / 8;                  // column fragments of 8 frames
constexpr int kStride = kTileFrames + 8;                  // staged words, word-major
constexpr int kUnitVideos = kTileFrames;                  // at most, when pb == 1
constexpr int kVideoWords = kUnitVideos / 32;             // 8 ma words per row frame
constexpr int kColWords = kMaxFrames / 32;                // mb bits of a unit's frames
constexpr int kBias = -(31 + 1);                          // match: distance <= 31
constexpr int kTargetBlocks = 2048;
constexpr int kMaxGroups = 65535;
static_assert(kGroups == 32, "one bit per column fragment");

// dynamic shared memory, in this order: the column tile's words and their
// complements, the ma bits [row frame][video word], the mb bits, the
// unit's real frame counts, the live column fragments and the "any match
// in the unit" flag
constexpr int kOffNb = 4 * hmma::kWords * kStride;
constexpr int kOffMa = 2 * kOffNb;
constexpr int kOffMb = kOffMa + 4 * kMaxFrames * kVideoWords;
constexpr int kOffNbc = kOffMb + 4 * kColWords;
constexpr int kOffFlags = kOffNbc + 4 * kUnitVideos;
constexpr int kSmemBytes = kOffFlags + 8;

// One block per (row video i = blockIdx.x, column group blockIdx.y); the
// group takes units blockIdx.y, blockIdx.y + gridDim.y, ...
__global__ void __launch_bounds__(kThreads, 2)
similarity_block_kernel(const unsigned* __restrict__ a,
                        const int* __restrict__ counts_a,
                        const unsigned* __restrict__ b,
                        const int* __restrict__ counts_b,
                        int* __restrict__ out, int n_cols, int pa, int pb) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_b = reinterpret_cast<unsigned*>(smem);
  unsigned* s_nb = reinterpret_cast<unsigned*>(smem + kOffNb);
  unsigned* s_ma = reinterpret_cast<unsigned*>(smem + kOffMa);  // [r * 8 + v / 32]
  unsigned* s_mb = reinterpret_cast<unsigned*>(smem + kOffMb);  // bit = unit frame
  int* s_nbc = reinterpret_cast<int*>(smem + kOffNbc);
  unsigned* s_glive = reinterpret_cast<unsigned*>(smem + kOffFlags);
  int* s_any = reinterpret_cast<int*>(smem + kOffFlags + 4);

  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int fa = max(counts_a[i], 1);
  const int na = min(max(counts_a[i], 0), pa);  // real row frames
  const long long row0 = (long long)i * pa;
  const int videos = pb <= kTileFrames ? kTileFrames / pb : 1;  // per unit
  const int tiles = (videos * pb + kTileFrames - 1) / kTileFrames;  // per unit
  const int n_units = (n_cols + videos - 1) / videos;

  // this warp's row fragments r: frames 16 * (warp + 16 r) + g (+ 8) below na
  hmma::Rows rows[kFragsPerWarp];
  unsigned live = 0u;  // bit r: fragment r holds a real frame (uniform in the warp)
#pragma unroll
  for (int r = 0; r < kFragsPerWarp; ++r) {
    const int lo = 16 * (warp + kWarps * r) + g;
    hmma::load_rows(rows[r], lo < na ? a + 8 * (row0 + lo) : nullptr,
                    lo + 8 < na ? a + 8 * (row0 + lo + 8) : nullptr, q);
    if (16 * (warp + kWarps * r) < na) live |= 1u << r;
  }
  for (int k = t; k < kMaxFrames * kVideoWords; k += kThreads) s_ma[k] = 0u;
  if (t < kColWords) s_mb[t] = 0u;

  for (int u = blockIdx.y; u < n_units; u += gridDim.y) {
    const int j0 = u * videos;
    const int nv = min(videos, n_cols - j0);
    int* o = out + (long long)i * n_cols + j0;
    if (na == 0) {  // an empty video scores 0 against anything
      for (int v = t; v < nv; v += kThreads) o[v] = 0;
      continue;
    }
    __syncthreads();  // the previous unit is consumed
    for (int v = t; v < nv; v += kThreads) s_nbc[v] = min(max(counts_b[j0 + v], 0), pb);
    if (t == 0) *s_any = 0;

    for (int sc = 0; sc < tiles; ++sc) {
      __syncthreads();  // s_nbc is written; the previous column tile is consumed
      if (t == 0) *s_glive = 0u;
      __syncthreads();
      // tile frame c is frame f of unit video v, real below its count
      for (int k = t; k < hmma::kWords * kTileFrames; k += kThreads) {
        const int c = k % kTileFrames;
        const int uf = sc * kTileFrames + c;
        const int v = uf / pb;
        const int f = uf - v * pb;
        const bool real = v < nv && f < s_nbc[v];
        hmma::stage_col(s_b, s_nb, kStride, c, k / kTileFrames,
                        real ? b + 8 * ((long long)(j0 + v) * pb + f) : nullptr);
        if (k < kTileFrames) {  // the first pass: one ballot per 32 frames, 4 fragments
          const unsigned m = __ballot_sync(0xffffffffu, real);
          if (lane == 0 && m) {
            unsigned bits = 0u;
            for (int x = 0; x < 4; ++x) bits |= (unsigned)(((m >> (8 * x)) & 0xffu) != 0u) << (4 * warp + x);
            atomicOr(s_glive, bits);
          }
        }
      }
      __syncthreads();

      hmma::sweep(rows, live, s_b, s_nb, kStride, *s_glive, kGroups, kBias, lane,
                  [&](int r, int rf, int col) {
                    const int row = 16 * (warp + kWarps * r) + rf;
                    const int uf = sc * kTileFrames + col;
                    const int v = uf / pb;
                    atomicOr(&s_ma[row * kVideoWords + (v >> 5)], 1u << (v & 31));
                    atomicOr(&s_mb[uf >> 5], 1u << (uf & 31));
                    *s_any = 1;
                  });
    }
    __syncthreads();

    if (!*s_any) {  // no frame pair of the unit matched
      for (int v = t; v < nv; v += kThreads) o[v] = 0;
      continue;
    }
    for (int v = t; v < nv; v += kThreads) {
      int ma = 0;
      for (int r = 0; r < na; ++r) ma += (s_ma[r * kVideoWords + (v >> 5)] >> (v & 31)) & 1u;
      int mb = 0;
      for (int lo = v * pb, hi = lo + pb; lo < hi;) {  // the video's frame bits
        const int end = min(hi, (lo / 32 + 1) * 32);
        unsigned w = s_mb[lo / 32] >> (lo % 32);
        if (end - lo < 32) w &= (1u << (end - lo)) - 1u;
        mb += __popc(w);
        lo = end;
      }
      const int fb = max(counts_b[j0 + v], 1);
      o[v] = s_nbc[v] == 0 ? 0 : min(100 * ma / fa, 100 * mb / fb);
    }
    __syncthreads();  // every count is read: clear the unit's bits
    for (int k = t; k < na * kVideoWords; k += kThreads) s_ma[k] = 0u;
    if (t < kColWords) s_mb[t] = 0u;
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
  cudaError_t err = cudaFuncSetAttribute(
      similarity_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int videos = pb <= kTileFrames ? kTileFrames / pb : 1;
  const int n_units = (n_cols + videos - 1) / videos;
  int groups = (kTargetBlocks + n_rows - 1) / n_rows;
  groups = groups < n_units ? groups : n_units;
  groups = groups < kMaxGroups ? groups : kMaxGroups;
  const dim3 grid((unsigned)n_rows, (unsigned)groups);
  similarity_block_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const unsigned*)a, (const int*)counts_a, (const unsigned*)b,
      (const int*)counts_b, (int*)out, n_cols, pa, pb);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
