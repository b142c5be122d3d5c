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
// Only rep 2 at the decimation sites is needed. Output row k (band k) reads
// rep 2's cols pass at row 8k+4, which reads rep 1's cols pass at rows
// 8k+3 .. 8k+6, which read rep 1's rows pass at rows 8k+2 .. 8k+8: seven
// frame rows (row 512, past the frame for k = 63, is the exact 0.0 the
// full pass adds). Bands never share a row, so 447 of a frame's 512 rows
// are read (7 a band, 6 in band 63), each byte once. Every rep-2 site window is interior, so this is the same
// arithmetic the full passes do at the sites (pdq_math step 2).
//
// What bounds it on the H100: bytes, about 4 float32 operations per byte
// read against the card's 20 per byte of HBM bandwidth. The design keeps
// the memory busy:
//   - One warp computes one band, one lane 16 adjacent columns (32 x 16 =
//     one row): the rows pass takes its three neighbours from the next and
//     previous lanes with shuffles, the cols passes and rep 2's rows pass
//     are the lane's own columns, so a band's arithmetic runs in registers
//     with no shared-memory round trip and no block barrier.
//   - Each warp walks bands gw, gw + W, ... (a persistent grid sized by the
//     occupancy the card reports) and copies the next band's 3 x 7 rows
//     (10.75 KB) into shared memory with cp.async while it computes the
//     current one, double-buffered; a lane copies and later reads the same
//     16-byte pieces, so cp.async.wait_group alone orders them.
//   - The row reciprocals a lane needs (its 16 columns) stay in registers;
//     the cols passes' reciprocals are one warp-uniform load each.
// Upstream of it, each frame also crosses PCIe and is decoded on the host,
// which is what bounds stage 1.
//
// Rounding. Every add and multiply is __fadd_rn / __fmul_rn in the fixed
// pairwise order above; those intrinsics are never contracted into an FMA,
// and the library is built with --fmad=false as a second guard.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kDim = 512;      // frame side
constexpr int kBuf = 64;       // decimated side
constexpr int kStride = 8;     // decimation stride
constexpr int kOff = 4;        // decimation offset
constexpr int kStaged = 7;     // rep-1 rows-pass rows of a band: 8k+2 .. 8k+8
constexpr int kPix = 16;       // columns of a lane: one 16-byte piece a plane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBandBytes = 3 * kStaged * kDim;       // 10,752: planes x rows x columns
constexpr int kSmemBytes = kWarps * 2 * kBandBytes;  // two bands a warp
constexpr int kLumaR = 299, kLumaG = 587, kLumaB = 114;
static_assert(32 * kPix == kDim, "a warp spans one row");

// ((a + b) + (c + d)) * r, each op rounded on its own
__device__ __forceinline__ float box4(float a, float b, float c, float d, float r) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d)), r);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Starts the copy of band n's rows into buf ([plane][row][column] bytes),
// this lane's 16 columns of each, as one cp.async group.
__device__ __forceinline__ void fetch_band(const uint8_t* __restrict__ frames, long long n,
                                           uint8_t* buf, int lane) {
  const long long plane = (long long)kDim * kDim;
  const uint8_t* frame = frames + (n / kBuf) * 3 * plane;
  const int row0 = kStride * (int)(n % kBuf) + 2;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int r = 0; r < kStaged; ++r) {
      if (row0 + r < kDim) {
        cp_async16(buf + (p * kStaged + r) * kDim + kPix * lane,
                   frame + p * plane + (long long)(row0 + r) * kDim + kPix * lane);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ unsigned byte_of(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (w >> (8 * (i % 4))) & 0xffu;
}

// rep 1's rows pass on staged row r of buf at this lane's columns, into x;
// a row past the frame is the full pass's 0.0
__device__ __forceinline__ void rows_pass(const uint8_t* buf, int r, bool in_frame, int lane,
                                          const float (&rc)[kPix], float (&x)[kPix]) {
  float l[kPix];
  if (in_frame) {
    const uint4 vr = *reinterpret_cast<const uint4*>(buf + (0 * kStaged + r) * kDim + kPix * lane);
    const uint4 vg = *reinterpret_cast<const uint4*>(buf + (1 * kStaged + r) * kDim + kPix * lane);
    const uint4 vb = *reinterpret_cast<const uint4*>(buf + (2 * kStaged + r) * kDim + kPix * lane);
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int milli = kLumaR * (int)byte_of(vr, i) + kLumaG * (int)byte_of(vg, i) +
                        kLumaB * (int)byte_of(vb, i);
      l[i] = __int2float_rn(milli);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) l[i] = 0.0f;
  }
  // columns c0 - 1, c0 + 16 and c0 + 17 are the neighbouring lanes'; past
  // the frame's edges they are the exact 0.0
  const float left = __shfl_up_sync(0xffffffffu, l[kPix - 1], 1);
  const float right1 = __shfl_down_sync(0xffffffffu, l[0], 1);
  const float right2 = __shfl_down_sync(0xffffffffu, l[1], 1);
  float e[kPix + 3];
  e[0] = lane > 0 ? left : 0.0f;
#pragma unroll
  for (int i = 0; i < kPix; ++i) e[i + 1] = l[i];
  e[kPix + 1] = lane < 31 ? right1 : 0.0f;
  e[kPix + 2] = lane < 31 ? right2 : 0.0f;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    x[i] = in_frame ? box4(e[i], e[i + 1], e[i + 2], e[i + 3], rc[i]) : 0.0f;
  }
}

__device__ __forceinline__ void add(float (&d)[kPix], const float (&a)[kPix],
                                    const float (&b)[kPix]) {
#pragma unroll
  for (int i = 0; i < kPix; ++i) d[i] = __fadd_rn(a[i], b[i]);
}

// d = (a + b) * r
__device__ __forceinline__ void add_mul(float (&d)[kPix], const float (&a)[kPix],
                                        const float (&b)[kPix], float r) {
#pragma unroll
  for (int i = 0; i < kPix; ++i) d[i] = __fmul_rn(__fadd_rn(a[i], b[i]), r);
}

// Band n of the batch from its staged rows: out[n / 64, n % 64, :].
__device__ __forceinline__ void filter_band(const uint8_t* buf, long long n, int lane,
                                            const float* __restrict__ recips,
                                            const float (&rc)[kPix], float* __restrict__ out) {
  const int k = (int)(n % kBuf);
  const int row0 = kStride * k + 2;  // frame row of staged row 0
  // rep 1's cols pass at site row 8k+3+s is ((x[s] + x[s+1]) + (x[s+2] +
  // x[s+3])) * recip[8k+3+s] over staged rows x: with the pair sums
  // p[s] = x[s] + x[s+1], y[s] = (p[s] + p[s+2]) * recip; rep 2's cols
  // pass at row 8k+4 is z = ((y[0] + y[1]) + (y[2] + y[3])) * recip[8k+4].
  float x0[kPix], x1[kPix], p0[kPix], p1[kPix], p2[kPix], p3[kPix], y0[kPix], y1[kPix];
  rows_pass(buf, 0, true, lane, rc, x0);
  rows_pass(buf, 1, true, lane, rc, x1);
  add(p0, x0, x1);
  rows_pass(buf, 2, true, lane, rc, x0);
  add(p1, x1, x0);
  rows_pass(buf, 3, true, lane, rc, x1);
  add(p2, x0, x1);
  add_mul(y0, p0, p2, recips[row0 + 1]);  // y[0]
  rows_pass(buf, 4, true, lane, rc, x0);
  add(p3, x1, x0);
  add_mul(y1, p1, p3, recips[row0 + 2]);  // y[1]
  add(p0, y0, y1);                        // y[0] + y[1]
  rows_pass(buf, 5, true, lane, rc, x1);
  add(p1, x0, x1);                        // p[4]
  add_mul(y0, p2, p1, recips[row0 + 3]);  // y[2]
  rows_pass(buf, 6, row0 + 6 < kDim, lane, rc, x0);
  add(p2, x1, x0);                        // p[5]
  add_mul(y1, p3, p2, recips[row0 + 4]);  // y[3]
  add(p1, y0, y1);                        // y[2] + y[3]
  add_mul(x1, p0, p1, recips[kStride * k + kOff]);  // z at this lane's columns
  // rep 2's rows pass at columns 8j+4, j = 2 lane and 2 lane + 1: the
  // windows c-1 .. c+2 lie in this lane's columns
  float2 o;
  o.x = box4(x1[kOff - 1], x1[kOff], x1[kOff + 1], x1[kOff + 2], rc[kOff]);
  o.y = box4(x1[kStride + kOff - 1], x1[kStride + kOff], x1[kStride + kOff + 1],
             x1[kStride + kOff + 2], rc[kStride + kOff]);
  reinterpret_cast<float2*>(out + n * kBuf)[lane] = o;
}

// A persistent grid: warp gw of W takes bands gw, gw + W, ... (band n =
// frame n / 64, output row n % 64).
__global__ void __launch_bounds__(kThreads)
pdq_filter_kernel(const uint8_t* __restrict__ frames,
                  const float* __restrict__ recips,
                  float* __restrict__ out, long long n_bands) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* const bufs = smem + warp * 2 * kBandBytes;  // this warp's two bands
  const long long step = (long long)gridDim.x * kWarps;
  long long n = (long long)blockIdx.x * kWarps + warp;
  if (n >= n_bands) return;

  float rc[kPix];  // recip[c] of this lane's columns
#pragma unroll
  for (int i = 0; i < kPix; ++i) rc[i] = recips[kPix * lane + i];

  fetch_band(frames, n, bufs, lane);
  for (int it = 0; n < n_bands; ++it, n += step) {
    if (n + step < n_bands) {
      fetch_band(frames, n + step, bufs + ((it + 1) & 1) * kBandBytes, lane);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // band n has landed
    filter_band(bufs + (it & 1) * kBandBytes, n, lane, recips, rc, out);
  }
}

// The persistent grid's resident blocks on the current card: worked out at
// the first launch there (the shared-memory opt-in, the SM count and the
// occupancy query) and reused after.
cudaError_t resident_blocks(int* blocks) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> resident[kMaxDevices];  // 0 until a card's first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *blocks = resident[dev].load(std::memory_order_relaxed);
  if (*blocks > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(pdq_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pdq_filter_kernel, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  resident[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: frames [batch, 3, 512, 512] uint8 (16-byte aligned),
// recips [512] float32 (pdq_math.box_recips(512)), out [batch, 64, 64]
// float32. Launches on `stream` without synchronising and returns the CUDA
// error (0 on success).
extern "C" int hvd_pdq_filter(const void* frames, const void* recips, void* out,
                              int batch, void* stream) {
  if (batch <= 0 || batch > (1 << 24)) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long n_bands = (long long)batch * kBuf;
  const long long wanted = (n_bands + kWarps - 1) / kWarps;
  const int blocks = (int)(wanted < resident ? wanted : resident);
  pdq_filter_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)recips, (float*)out, n_bands);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
