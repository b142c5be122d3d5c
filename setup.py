"""Wheel-time build of the native ctypes libraries.

The reference tool distributes its hot compute as compiled wheels
(hvdaccelerators); this framework's equivalents are plain shared libraries
loaded via ctypes (native/libhvdaccel.so, native/libhvdecode.so). Building
them at wheel time means `pip install` users get compiled code without a
toolchain; source installs without a compiler still work — the runtime
loaders fall back to the numpy oracle / OpenCV decode chain.

Uses the portable distutils ccompiler (g++/clang on POSIX, MSVC on
Windows) rather than the developer Makefile. The decode module is only
built when the FFmpeg dev libraries are available.

Both packages get their own copies: the JAX package's libraries land in its
native/, the PyTorch port's in its native/build/, where its loader (and its
Makefile) keep them.
"""

from __future__ import annotations

import sys
from pathlib import Path

from setuptools import setup
from setuptools.command.build_py import build_py
from setuptools.dist import Distribution

NATIVE = Path(__file__).parent / "hydrus_video_deduplicator_tpu" / "native"
PORT_NATIVE = Path(__file__).parent / "hydrus_video_deduplicator_tpu_torch" / "native"
#: (a package's native sources, the directory its libraries land in)
NATIVE_BUILDS = ((NATIVE, NATIVE), (PORT_NATIVE, PORT_NATIVE / "build"))


def _compile_shared(source, out, include_dirs=(), libraries=(), extra_args=()) -> None:
    """Compile and link one library; on failure print why and go on: the
    runtime loaders fall back (numpy oracle, OpenCV/Pillow decode)."""
    try:
        from distutils.ccompiler import new_compiler
        from distutils.sysconfig import customize_compiler

        cc = new_compiler()
        customize_compiler(cc)
        objs = cc.compile(
            [str(source)],
            output_dir=str(source.parent / "_build"),
            include_dirs=[str(d) for d in include_dirs],
            extra_preargs=list(extra_args),
        )
        cc.link_shared_object(
            objs,
            str(out),
            libraries=list(libraries),
            target_lang="c++",  # link with the C++ driver (libstdc++/libc++)
        )
    except Exception as exc:  # no toolchain, or a missing source
        print(f"skipping the build of {out} ({exc}); runtime will fall back")
    else:
        print(f"built {out}")


def _build_native() -> None:
    import subprocess

    is_msvc = sys.platform == "win32"
    # -ffp-contract=off is REQUIRED for hash bit-exactness (pdq_math.py);
    # MSVC does not contract FP by default (/fp:precise)
    args = ["/O2", "/std:c++17", "/fp:precise"] if is_msvc else [
        "-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-pthread"
    ]
    try:
        cflags = subprocess.run(
            ["pkg-config", "--cflags", "libavformat", "libavcodec", "libswscale", "libavutil"],
            capture_output=True, text=True, check=True,
        ).stdout.split()
    except (OSError, subprocess.CalledProcessError) as exc:
        cflags = None  # no FFmpeg dev libs: OpenCV/Pillow chain instead
        print(f"skipping the native decode builds ({exc}); runtime will fall back")
    for native, lib_dir in NATIVE_BUILDS:
        _compile_shared(native / "pdq.cpp", lib_dir / "libhvdaccel.so", extra_args=args)
        if cflags is not None:
            _compile_shared(
                native / "decode.cpp",
                lib_dir / "libhvdecode.so",
                include_dirs=[f[2:] for f in cflags if f.startswith("-I")],
                libraries=["avformat", "avcodec", "swscale", "avutil"],
                extra_args=args,
            )


class build_py_with_native(build_py):
    def run(self):
        _build_native()
        super().run()


class BinaryDistribution(Distribution):
    """Tag wheels with the platform: they carry ctypes shared libraries."""

    def has_ext_modules(self):
        return True


try:
    from wheel.bdist_wheel import bdist_wheel

    class bdist_wheel_ctypes(bdist_wheel):
        """py3-none-<platform> tag: the shared libraries are ctypes (no
        CPython ABI), so ONE wheel per platform covers every Python —
        the reference's hvdaccelerators needs a cp310..cp314 matrix for
        the same coverage (uv.lock:186-206)."""

        def get_tag(self):
            _python, _abi, plat = super().get_tag()
            return "py3", "none", plat

    _wheel_cmd = {"bdist_wheel": bdist_wheel_ctypes}
except ImportError:  # building without the wheel package (sdist only)
    _wheel_cmd = {}

setup(
    cmdclass={"build_py": build_py_with_native, **_wheel_cmd},
    distclass=BinaryDistribution,
)
