"""Video decode + frame sampling.

Rebuilds the reference's PyAV/ffmpeg decode path
(upstream src/hydrusvideodeduplicator/vpdqpy/vpdqpy.py:59-101) with a
backend registry:

- Native libav (default): direct libavformat/avcodec/swscale calls — the
  exact libraries PyAV wraps — reproducing the reference's frame sampling,
  InvalidDataError handling, and SWS_POINT 512x512 rgb24 rescale
  byte-for-byte (native/decode.cpp).
- OpenCV (bundled ffmpeg) fallback for container formats
- Pillow for animated webp (libavcodec can't decode webp animation) and as
  a fallback for animated images (gif, apng) — first-class inputs for the
  reference tool ("system:filetype=video, gif, apng", dedup.py:199-203)
- A pure-numpy YUV4MPEG2 (.y4m) parser as a fully deterministic
  uncompressed format for tests.

Sampling parity with the reference: ~1 frame/sec via
``frame_index % round(average_fps) == 0``; fps unknown or < 1 hashes every
frame (vpdqpy.py:71-77). On the fallback backends, sampled frames are
rescaled with deterministic center-based nearest-neighbor instead of
swscale POINT; cross-backend hashes agree within the reference's own >= 99
similarity tolerance (tests/unit_tests/test_decode_libav.py).
"""

from .frames import (  # noqa: F401
    DecodeError,
    extract_frames,
    resize_nearest_512,
    sample_indices,
)
