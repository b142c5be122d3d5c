// PDQ filter: luma, the two Jarosz box-filter reps and the 8x decimation of
// stage 1 (perceptual hashing), for a batch of 512x512 frames.
//
// Replaces the Pallas TPU kernel pdq_filter_batch_pallas /
// _pdq_filter_kernel in hydrus_video_deduplicator_tpu/ops/pdq_pallas.py.
// It maps planar frames [B, 3, 512, 512] uint8 to the decimated buffer
// [B, 64, 64] float32, bit for bit what the full-pass form computes
// (hydrus_video_deduplicator_tpu/vpdq/pdq_math.py, steps 1-3):
//
//   luma = float(299 R + 587 G + 114 B)          (exact: below 2^24)
//   rep 1: rows pass, then cols pass; rep 2: cols pass, then rows pass;
//   each pass  out[i] = ((x[i-1] + x[i]) + (x[i+1] + x[i+2])) * recip[i],
//   out-of-frame terms an exact 0.0, recip[i] = f32(1 / live window count);
//   out[k, j] = filtered[8k + 4, 8j + 4].
//
// Design. The Pallas kernel keeps one whole frame in VMEM and rolls it.
// Here one block computes one 8-row band k of one frame, so B * 64 blocks
// fill the card's SMs and a block needs only 40 KB of shared memory:
// output row 8k+4 of rep 2's cols pass reads rep 1's cols pass at rows
// 8k+3 .. 8k+6, which read rep 1's rows pass at rows 8k+2 .. 8k+8. The
// block stages the luma of those 7 rows (row 512, past the frame for
// k = 63, is the exact 0.0 the full pass adds), runs the rows pass on them,
// the cols pass at the 4 site rows (row 510 takes recip[510] = 1/3 from the
// table), rep 2's cols pass at row 8k+4, and rep 2's rows pass at the 64
// columns 8j+4. Every rep-2 site window is interior, so this is the same
// arithmetic the full passes do at the sites (pdq_math step 2).
//
// Rounding. Every add and multiply is __fadd_rn / __fmul_rn in the fixed
// pairwise order above; those intrinsics are never contracted into an FMA,
// and the library is built with --fmad=false as a second guard.
//
// What bounds it on the H100: bytes. A block reads 7 of every 8 frame rows
// (688 KB of the 786 KB frame, each byte once) and does about 4 integer
// and float ops per byte read, far below the card's 20 ops per byte of HBM
// bandwidth, so
// 512 frames need at least about 0.11 ms at 3.35 TB/s. Upstream of it,
// each frame also crosses PCIe and is decoded on the host, which is what
// bounds stage 1. Vectorised 16-byte loads keep the reads coalesced; the
// DCT and threshold tail (1/64 of the data) stays in PyTorch for now.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDim = 512;      // frame side
constexpr int kBuf = 64;       // decimated side
constexpr int kStride = 8;     // decimation stride
constexpr int kOff = 4;        // decimation offset
constexpr int kStaged = 7;     // rep-1 rows-pass rows of a band: 8k+2 .. 8k+8
constexpr int kSites = 4;      // rep-1 cols-pass rows rep 2 reads: 8k+3 .. 8k+6
constexpr int kThreads = 256;
constexpr int kGroup = 16;     // pixels per 16-byte load
constexpr int kLumaR = 299, kLumaG = 587, kLumaB = 114;

// ((a + b) + (c + d)) * r, each op rounded on its own
__device__ __forceinline__ float box4(float a, float b, float c, float d, float r) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d)), r);
}

// One block per (frame b, band k): blockIdx.x = b * 64 + k.
__global__ void __launch_bounds__(kThreads)
pdq_filter_kernel(const uint8_t* __restrict__ frames,
                  const float* __restrict__ recips,
                  float* __restrict__ out) {
  const int k = blockIdx.x % kBuf;
  const long long b = blockIdx.x / kBuf;
  const int t = threadIdx.x;
  const int row0 = kStride * k + 2;  // frame row of staged row 0

  __shared__ float s_recip[kDim];
  __shared__ float s_luma[kStaged][kDim];
  __shared__ float s_x[kStaged][kDim];  // rep 1, rows pass
  __shared__ float s_y[kSites][kDim];   // rep 1, cols pass at the site rows
  __shared__ float s_z[kDim];           // rep 2, cols pass at row 8k+4

  for (int c = t; c < kDim; c += kThreads) s_recip[c] = recips[c];

  // luma of the staged rows, 16 pixels of one row per thread
  const long long plane = (long long)kDim * kDim;
  const uint8_t* frame = frames + b * 3 * plane;
  constexpr int kGroups = kDim / kGroup;
  for (int g = t; g < kStaged * kGroups; g += kThreads) {
    const int rr = g / kGroups;
    const int c0 = (g % kGroups) * kGroup;
    const int row = row0 + rr;
    if (row >= kDim) continue;  // row 512: never read (see the rows pass)
    const long long off = (long long)row * kDim + c0;
    const uint4 r16 = *reinterpret_cast<const uint4*>(frame + off);
    const uint4 g16 = *reinterpret_cast<const uint4*>(frame + plane + off);
    const uint4 b16 = *reinterpret_cast<const uint4*>(frame + 2 * plane + off);
    const uint8_t* rp = reinterpret_cast<const uint8_t*>(&r16);
    const uint8_t* gp = reinterpret_cast<const uint8_t*>(&g16);
    const uint8_t* bp = reinterpret_cast<const uint8_t*>(&b16);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int milli = kLumaR * rp[i] + kLumaG * gp[i] + kLumaB * bp[i];
      s_luma[rr][c0 + i] = __int2float_rn(milli);
    }
  }
  __syncthreads();

  // rep 1, rows pass on the staged rows; row 512 is the full pass's 0.0
  for (int i = t; i < kStaged * kDim; i += kThreads) {
    const int rr = i / kDim;
    const int c = i % kDim;
    float v = 0.0f;
    if (row0 + rr < kDim) {
      const float* l = s_luma[rr];
      v = box4(c >= 1 ? l[c - 1] : 0.0f, l[c],
               c + 1 < kDim ? l[c + 1] : 0.0f, c + 2 < kDim ? l[c + 2] : 0.0f,
               s_recip[c]);
    }
    s_x[rr][c] = v;
  }
  __syncthreads();

  // rep 1, cols pass at site rows 8k+3+s, whose window is staged rows s..s+3
  for (int i = t; i < kSites * kDim; i += kThreads) {
    const int s = i / kDim;
    const int c = i % kDim;
    s_y[s][c] = box4(s_x[s][c], s_x[s + 1][c], s_x[s + 2][c], s_x[s + 3][c],
                     s_recip[row0 + 1 + s]);
  }
  __syncthreads();

  // rep 2, cols pass at row 8k+4
  const float r_site = s_recip[kStride * k + kOff];
  for (int c = t; c < kDim; c += kThreads) {
    s_z[c] = box4(s_y[0][c], s_y[1][c], s_y[2][c], s_y[3][c], r_site);
  }
  __syncthreads();

  // rep 2, rows pass at columns 8j+4: out[b, k, j]
  if (t < kBuf) {
    const int c = kStride * t + kOff;
    out[(b * kBuf + k) * kBuf + t] =
        box4(s_z[c - 1], s_z[c], s_z[c + 1], s_z[c + 2], s_recip[c]);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: frames [batch, 3, 512, 512] uint8 (16-byte aligned),
// recips [512] float32 (pdq_math.box_recips(512)), out [batch, 64, 64]
// float32. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int hvd_pdq_filter(const void* frames, const void* recips, void* out,
                              int batch, void* stream) {
  if (batch <= 0 || batch > (1 << 24)) return (int)cudaErrorInvalidValue;
  pdq_filter_kernel<<<batch * kBuf, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)recips, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
