"""k1_roofline.<cell>: kernel 1 (csrc/exists_mask_sweep.cu, through
ops/similarity_segments.exists_mask_sweep), its roofline bound over its
device time (CUDA events) summed over the window's launches, in percent."""

from hvdb.layerspans import K1

KERNELS = (K1,)


def read(rec):
    return rec.roofline(K1[0])
