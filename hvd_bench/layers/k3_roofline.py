"""k3_roofline.<cell>: kernel 3 in mask mode (csrc/similarity_segments.cu,
through ops/similarity_segments.similarity_segments), its roofline bound
over its device time (CUDA events) summed over the window's launches, in
percent."""

from hvdb.layerspans import K3

KERNELS = (K3,)


def read(rec):
    return rec.roofline(K3[0])
