// Exact similarity of a ragged list of candidate video pairs: stage B of
// the pruned search (ops/pair_verify.py verify_pairs).
//
// It replaces no TPU kernel: the JAX package verifies the candidates with
// a batched ±1 product that XLA compiles (ops/pair_verify.py
// _verify_chunk), and the port first ran that product as float16 bmm
// chunks of 8 to 32 pairs, some twenty small launches and four copies a
// chunk, thousands of chunks a search step. This kernel takes a whole
// call's pairs in one launch. For pair p = (a_off, na, b_off, nb) over one
// packed frame array it counts
//
//   ma = frames of video a within Hamming distance 31 of some frame of b,
//   mb = frames of video b within distance 31 of some frame of a,
//
// and writes out[p] = min(100 * ma / na, 100 * mb / nb), the integer of
// native matchHashBytes; 1 <= na, nb <= 512 (the wrapper checks it, and a
// pair outside that range gets -1).
//
// Design: one block of 8 warps per pair. Video a's frames sit in registers
// as row fragments of 16 frames (at most 32, four a warp, round-robin),
// as bits and complements; video b is staged once in shared memory as
// words and complements (hamming_mma.cuh), padded to a whole vote of 32
// frames. hmma::sweep runs the binary products: two per 16 x 8 frame
// pairs give their distances, and a warp vote every four column fragments
// skips the epilogue where nothing matched. A matching pair sets its row
// frame's and its column frame's bit in two shared bit sets (atomicOr, on
// the vote's slow path only); the block ends with a __popc of each set.
// Padding is decided by count, never by bits: frames at or past a count
// are all ones in bits and complement (distance >= 256 to anything), while
// an all-zero real frame stays itself.
//
// Ragged sizes: the host puts the longer video of a pair on the rows side
// (the similarity is symmetric in its two videos), so its fragments spread
// over the warps, and orders the pairs by frame pairs, largest first, so
// the block scheduler hands the long pairs out first and the short ones
// fill the tail.
//
// Bound: a step's candidates are about 1e9 frame pairs, under 0.1 ms at
// the binary product's 2.02e13 pairs/s, and their frames a few hundred MB
// at 3.35 TB/s; what the kernel saves is the launches and copies around
// the work, not the work.

#include <cuda_runtime.h>

#include <cstdint>

#include "hamming_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxFrames = 512;                          // a video's frames at most
constexpr int kFragsPerWarp = kMaxFrames / 16 / kWarps;  // 4 row fragments of 16 frames
constexpr int kStride = kMaxFrames + 8;                  // staged words, word-major
constexpr int kBitWords = kMaxFrames / 32;               // a side's matched bits
constexpr int kBias = -(31 + 1);                         // match: distance <= 31

// One block per pair blockIdx.x of `pairs` ({a_off, na, b_off, nb}, frame
// offsets into `frames`, [*, 8] words a frame).
__global__ void __launch_bounds__(kThreads)
pair_verify_kernel(const int4* __restrict__ pairs, const unsigned* __restrict__ frames,
                   int* __restrict__ out) {
  __shared__ unsigned s_b[hmma::kWords * kStride];
  __shared__ unsigned s_nb[hmma::kWords * kStride];
  __shared__ unsigned s_ma[kBitWords];  // bit = a frame with a match in b
  __shared__ unsigned s_mb[kBitWords];  // bit = b frame with a match in a

  const int4 pair = pairs[blockIdx.x];
  const int na = pair.y;
  const int nb = pair.w;
  const int t = threadIdx.x;
  if (na < 1 || na > kMaxFrames || nb < 1 || nb > kMaxFrames) {  // uniform in the block
    if (t == 0) out[blockIdx.x] = -1;
    return;
  }
  const unsigned* a = frames + 8ll * pair.x;
  const unsigned* b = frames + 8ll * pair.z;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = lane / 4;
  const int q = lane % 4;

  // this warp's row fragments r: frames 16 * (warp + 8 r) + g (+ 8) below na
  hmma::Rows rows[kFragsPerWarp];
  unsigned live = 0u;  // bit r: fragment r holds a real frame (uniform in the warp)
#pragma unroll
  for (int r = 0; r < kFragsPerWarp; ++r) {
    const int lo = 16 * (warp + kWarps * r) + g;
    hmma::load_rows(rows[r], lo < na ? a + 8 * lo : nullptr,
                    lo + 8 < na ? a + 8 * (lo + 8) : nullptr, q);
    if (16 * (warp + kWarps * r) < na) live |= 1u << r;
  }
  // video b, padded to whole votes (4 column fragments, 32 frames); neighbour
  // threads read neighbour words
  const int staged = (nb + 31) & ~31;
  for (int k = t; k < hmma::kWords * staged; k += kThreads) {
    const int f = k / hmma::kWords;
    hmma::stage_col(s_b, s_nb, kStride, f, k % hmma::kWords, f < nb ? b + 8 * f : nullptr);
  }
  if (t < kBitWords) {
    s_ma[t] = 0u;
    s_mb[t] = 0u;
  }
  __syncthreads();

  const int real_groups = (nb + 7) / 8;  // column fragments holding a real frame
  const unsigned long long glive = real_groups == 64 ? ~0ull : (1ull << real_groups) - 1ull;
  hmma::sweep(rows, live, s_b, s_nb, kStride, glive, staged / 8, kBias, lane,
              [&](int r, int rf, int col) {
                const int row = 16 * (warp + kWarps * r) + rf;
                atomicOr(&s_ma[row >> 5], 1u << (row & 31));
                atomicOr(&s_mb[col >> 5], 1u << (col & 31));
              });
  __syncthreads();

  if (warp == 0) {
    int ma = lane < kBitWords ? __popc(s_ma[lane]) : 0;
    int mb = lane < kBitWords ? __popc(s_mb[lane]) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ma += __shfl_xor_sync(0xffffffffu, ma, o);
      mb += __shfl_xor_sync(0xffffffffu, mb, o);
    }
    if (lane == 0) out[blockIdx.x] = min(100 * ma / na, 100 * mb / nb);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers:
// pairs [n_pairs, 4] int32 (a_off, na, b_off, nb), 16-byte aligned; frames
// [*, 8] int32 bit-packed frames; out [n_pairs] int32. Launches on `stream`
// without synchronising and returns the CUDA error (0 on success).
extern "C" int hvd_pair_verify(const void* pairs, const void* frames, void* out, int n_pairs,
                               void* stream) {
  if (n_pairs <= 0 || reinterpret_cast<uintptr_t>(pairs) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  pair_verify_kernel<<<n_pairs, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)pairs, (const unsigned*)frames, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
