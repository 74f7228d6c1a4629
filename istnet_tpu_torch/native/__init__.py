"""Host C++ depth completion (``depth_fill.cpp``) through ctypes: the
port's default host depth fill, the counterpart of ``istnet_tpu/native``.

The library is built at first use, never at import, with ``$CXX`` (else
``g++``) and the flags of ``istnet_tpu/native/Makefile`` (``-O3
-march=native -ffast-math -fPIC -std=c++17``) into
``istnet_tpu_torch/build/<hash>/libistnet_native.so``. The hash covers the
source, the flags, the compiler's version line and the host CPU (the code
is built for it), so an edit or another compiler rebuilds. Concurrent
builds (several test processes, loader threads) are safe: each compiles in
a temporary directory and moves its library into place with
``os.replace``.

There is no fallback: a missing compiler or a failed build raises with the
compiler's log. ``data/depth_utils.fill_missing(prefer_native=False)``, or
``ISTNET_NATIVE_DEPTH_FILL=0`` in the environment, asks for the OpenCV
chain instead. The C calls release the GIL (``ctypes.CDLL``), so loader
threads fill frames in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "depth_fill.cpp"
BUILD = SOURCE.parent.parent / "build"
LIB_NAME = "libistnet_native.so"
CXXFLAGS = ("-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17",
            "-Wall")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_info: dict = {}

_F32P = ctypes.POINTER(ctypes.c_float)


def compiler() -> str:
    """The C++ compiler the core is built with: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def compiler_version(cxx: str) -> str:
    """The first line of ``cxx --version``; raises if it cannot be run."""
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found: the native depth fill cannot be "
            "built (set $CXX, or ask for the OpenCV fill with "
            "prefer_native=False or ISTNET_NATIVE_DEPTH_FILL=0)")
    proc = subprocess.run([path, "--version"], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return (proc.stdout.splitlines() or [""])[0]


def build() -> Path:
    """Compile the library unless this hash is already built; return it."""
    cxx = compiler()
    version = compiler_version(cxx)
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(CXXFLAGS), version, platform.machine(), _cpu()):
        h.update(b"\0" + part.encode())
    out_dir = BUILD / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    build_info.update(compiler=version)
    if lib.is_file():
        build_info.setdefault("cached", True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        so = tmp / LIB_NAME
        cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(so), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"building the native depth fill failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(cached=False, seconds=seconds, log=proc.stdout)
    return lib


def library() -> ctypes.CDLL:
    """The loaded core, built first if need be (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fill_in_multiscale.argtypes = [_F32P, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_float]
            lib.fill_in_multiscale.restype = None
            lib.fill_in_multiscale_scaled.argtypes = [
                _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float]
            lib.fill_in_multiscale_scaled.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the core builds and loads on this host."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def fill_in_multiscale_native(depth: np.ndarray,
                              max_depth: float = 3.0) -> np.ndarray:
    """(H, W) float32 depth in metres -> the completed depth
    (``depth_utils.fill_in_multiscale`` with the bilateral blur)."""
    lib = library()
    buf = np.ascontiguousarray(depth, np.float32).copy()
    lib.fill_in_multiscale(buf.ctypes.data_as(_F32P), buf.shape[0],
                           buf.shape[1], ctypes.c_float(max_depth))
    return buf


def fill_missing_native(dpt: np.ndarray, cam_scale: float,
                        scale_2_80m: float) -> np.ndarray:
    """``depth_utils.fill_missing``'s default through the core: depth in
    sensor units -> completed depth, same units. The unit scaling is fused
    into the native pass (four numpy scaling passes would cost a third of
    the fill at 480 x 640)."""
    lib = library()
    buf = np.array(dpt, np.float32, copy=True, order="C")
    lib.fill_in_multiscale_scaled(
        buf.ctypes.data_as(_F32P), buf.shape[0], buf.shape[1],
        ctypes.c_float(3.0), ctypes.c_float(scale_2_80m / cam_scale))
    return buf
