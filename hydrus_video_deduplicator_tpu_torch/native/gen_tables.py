"""Generate pdq_tables.h from the shared constants in vpdq.pdq_math.

Constants are emitted as uint32 IEEE-754 bit patterns (not decimal floats) so
the C++ build is guaranteed bit-identical to the Python/JAX side. The
generated header is committed; re-run this script only when pdq_math changes:

    python -m hydrus_video_deduplicator_tpu_torch.native.gen_tables
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..vpdq import pdq_math as pm


def f32_bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def main() -> None:
    out = Path(__file__).parent / "pdq_tables.h"
    lines = []
    lines.append("// Auto-generated by gen_tables.py from vpdq/pdq_math.py. DO NOT EDIT.")
    lines.append("// f32 constants are stored as IEEE-754 bit patterns for bit-exactness.")
    lines.append("#pragma once")
    lines.append("#include <cstdint>")
    lines.append("")
    lines.append(f"constexpr int PDQ_FRAME_DIM = {pm.FRAME_DIM};")
    lines.append(f"constexpr int PDQ_BUF_DIM = {pm.BUF_DIM};")
    lines.append(f"constexpr int PDQ_DCT_DIM = {pm.DCT_DIM};")
    lines.append(f"constexpr int PDQ_BYTES_PER_HASH = {pm.BYTES_PER_HASH};")
    lines.append(f"constexpr int PDQ_WINDOW = {pm.WINDOW};")
    lines.append(f"constexpr int PDQ_OFF_L = {pm.OFF_L};")
    lines.append(f"constexpr int PDQ_OFF_R = {pm.OFF_R};")
    lines.append(f"constexpr int PDQ_N_REPS = {pm.N_REPS};")
    lines.append(f"constexpr int PDQ_LUMA_R = {pm.LUMA_R};")
    lines.append(f"constexpr int PDQ_LUMA_G = {pm.LUMA_G};")
    lines.append(f"constexpr int PDQ_LUMA_B = {pm.LUMA_B};")
    lines.append(f"constexpr int PDQ_QUALITY_DENOM = {pm.QUALITY_DENOM};")
    lines.append(f"constexpr int PDQ_QUALITY_MAX = {pm.QUALITY_MAX};")
    lines.append(f"constexpr int PDQ_QUALITY_MIN_KEEP = {pm.QUALITY_MIN_KEEP};")
    lines.append(f"constexpr int PDQ_DEFAULT_TOLERANCE = {pm.DEFAULT_DISTANCE_TOLERANCE};")
    lines.append("")
    qbits = int(f32_bits(pm.QUALITY_SCALE))
    lines.append(f"constexpr uint32_t PDQ_QUALITY_SCALE_BITS = 0x{qbits:08x}u;")
    lines.append("")
    dct = f32_bits(pm.DCT_MATRIX).reshape(-1)
    lines.append(f"// DCT-II matrix [16][64], row-major, f32 bit patterns.")
    lines.append(f"constexpr uint32_t PDQ_DCT_MATRIX_BITS[{pm.DCT_DIM * pm.BUF_DIM}] = {{")
    for row in range(pm.DCT_DIM):
        vals = dct[row * pm.BUF_DIM : (row + 1) * pm.BUF_DIM]
        for i in range(0, pm.BUF_DIM, 8):
            chunk = ", ".join(f"0x{v:08x}u" for v in vals[i : i + 8])
            lines.append(f"    {chunk},")
    lines.append("};")
    lines.append("")
    recip = f32_bits(pm.RECIP)
    lines.append(f"// f32(1.0/c) for c in 0..{pm.WINDOW} (index 0 unused).")
    lines.append(f"constexpr uint32_t PDQ_RECIP_BITS[{pm.WINDOW + 1}] = {{")
    lines.append("    " + ", ".join(f"0x{v:08x}u" for v in recip) + ",")
    lines.append("};")
    lines.append("")
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
