"""Tensor-core rates for 256-bit frame pairs on one GPU: the measurement
that chose the binary form of csrc/similarity_segments.cu and
csrc/similarity_block.cu over int8.

    python3 mma_rates.py

Builds one small CUDA file with nvcc (sm_90a) and times, with CUDA events,
frame pairs (one 256-bit hash against one hash) per second of:

- wgmma int8 from shared memory on ±1 frames (dot = 256 - 2 * hamming):
  "tile" issues one 64 x 128 tile (eight m64n128k32) and waits;
  "chained" keeps 64 tiles in one accumulator before it waits;
- mma.sync m16n8k256 b1 with .and.popc: one instruction is 16 x 8 whole
  hashes, popc(a & b) alone ("b1_and_popc"), and the kernels' distance
  (csrc/hamming_mma.cuh: popc(a & ~b) + popc(~a & b), two instructions,
  and the OR of the signs, "b1_distance");
- mma.sync m16n8k32 int8 (eight per 16 x 8 frame pairs).

Each kernel runs on data already on chip, so the rates are the
instructions' ceilings, not a kernel's. Prints the card (nvidia-smi) and
one JSON object; exits non-zero without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "hamming_mma.cuh"

// wgmma int8: 64 x 128 tiles of +-1 frames, K-major without swizzle (core
// matrices of 8 frames x 16 bytes; leading byte offset 128 = the next 16 K
// bytes, stride byte offset 2048 = the next 8 frames)
__device__ uint64_t descriptor(const int8_t* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3FFFFu) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(2048 >> 4) << 32);
}

#define ACC8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__global__ void __launch_bounds__(256) wgmma_rate(int iters, int chained, int* sink) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int8_t* s_b = reinterpret_cast<int8_t*>(smem);                       // 128 frames
  int8_t* s_a = s_b + 128 * 256 + (threadIdx.x / 128) * 64 * 256;      // 64 frames
  for (int k = threadIdx.x; k < (128 + 2 * 64) * 256 / 16; k += 256) {
    reinterpret_cast<uint4*>(smem)[k] = make_uint4(0x01FF01FFu, k, 0xFF01FF01u, ~k);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = descriptor(s_a), db = descriptor(s_b);
  int d[64] = {};
  int acc = 0;
  for (int it = 0; it < iters; it += chained ? 64 : 1) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int r = 0; r < (chained ? 64 : 1); ++r) {
#pragma unroll
      for (int k = 0; k < 8; ++k) wgmma_k32(d, da + 16 * k, db + 16 * k, chained || k > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    int mx = d[0];
#pragma unroll
    for (int i = 1; i < 64; ++i) mx = max(mx, d[i]);
    acc += mx >= 194;
  }
  if (acc == 12345) sink[0] = acc;
}

__global__ void b1_rate(int iters, int distance, int* sink) {
  hmma::Rows rows[8];  // eight independent row fragments a warp, as in the kernels
  hmma::Cols cols;
  for (int r = 0; r < 8; ++r) {
    for (int k = 0; k < 4; ++k) {
      rows[r].a[k] = threadIdx.x * (2 * k + 3u) + r;
      rows[r].na[k] = ~rows[r].a[k];
    }
  }
  cols.b[0] = threadIdx.x * 11u, cols.b[1] = threadIdx.x * 13u;
  cols.nb[0] = ~cols.b[0], cols.nb[1] = ~cols.b[1];
  int any = 0;
  if (distance) {  // per 16 x 8 pairs: two products and the OR of the signs
    for (int it = 0; it < iters; it += 2) {
      cols.b[0] += it;  // a new column fragment each time: nothing can be hoisted
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        int d[4];
        hmma::distance(d, rows[r], cols, -32);
        any |= d[0] | d[1] | d[2] | d[3];
      }
    }
  } else {  // per 16 x 8 pairs: one product, 8 independent chains
    int c[8][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        hmma::and_popc(c[r], rows[r].a, cols.b, c[r][0], c[r][1], c[r][2], c[r][3]);
      }
    }
    for (int r = 0; r < 8; ++r) any += c[r][r % 4];
  }
  if (any == 12345) sink[0] = 1;
}

__global__ void imma_rate(int iters, int* sink) {
  unsigned a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  unsigned b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  int c[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(c[s][0]), "+r"(c[s][1]), "+r"(c[s][2]), "+r"(c[s][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  if (c[0][0] + c[1][1] + c[2][2] + c[3][3] == 12345) sink[0] = 1;
}

extern "C" int run(int which, int blocks, int iters, void* sink, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (which < 2) {
    const int smem = (128 + 2 * 64) * 256;
    cudaError_t err = cudaFuncSetAttribute(wgmma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    wgmma_rate<<<blocks, 256, smem, st>>>(iters, which, (int*)sink);
  } else if (which < 4) {
    b1_rate<<<blocks, 256, 0, st>>>(iters, which == 3, (int*)sink);
  } else {
    imma_rate<<<blocks, 256, 0, st>>>(iters, (int*)sink);
  }
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rates: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hydrus_video_deduplicator_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="hvd_mma_rates_") as tmp:
        src, so = os.path.join(tmp, "mma_rates.cu"), os.path.join(tmp, "libmma_rates.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run(
            [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, src],
            check=True,
        )
        lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    #: name -> (which, blocks, iterations, frame pairs per block-iteration)
    cases = {
        "wgmma_int8_tile": (0, 2 * sms, 2048, 2 * 64 * 128),
        "wgmma_int8_chained": (1, 2 * sms, 2048, 2 * 64 * 128),
        "b1_and_popc": (2, 4 * sms, 2048, 8 * 8 * 16 * 8),
        "b1_distance": (3, 4 * sms, 2048, 8 * 8 * 16 * 8 // 2),
        "mma_sync_int8": (4, 4 * sms, 4096, 8 * 4 * 16 * 8 // 8),
    }
    rates = {}
    for name, (which, blocks, iters, pairs) in cases.items():
        def call():
            err = lib.run(which, blocks, iters, sink.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        rates[name] = {"ms": ms, "frame_pairs_per_s": blocks * iters * pairs / (ms / 1e3)}
        print(f"{name}: {ms:.4f} ms, {rates[name]['frame_pairs_per_s']:.4g} frame pairs/s",
              flush=True)
    print(card)
    print(json.dumps({"card": card, "rates": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
