"""Build and load the CUDA kernels of ``istnet_tpu_torch/csrc``.

At first use the sources are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per ``.cu`` file,
all started together, then linked into one shared library with a plain C
interface under ``istnet_tpu_torch/build/<hash>/`` and loaded with
``ctypes``. The hash covers the sources (headers included) and the flags,
so an edit rebuilds.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.

Nothing here runs when the module is imported, and there is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB_NAME = "libistnet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
_fns: dict[str, ctypes._CFuncPtr] = {}
build_info: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> Path:
    """Compile the library unless this hash is already built; return it."""
    out_dir = BUILD / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        build_info.setdefault("cached", True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs, cmds = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            objs.append(str(tmp / (src.stem + ".o")))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
        t0 = time.perf_counter()
        log = _run_all(cmds)
        so = str(tmp / LIB_NAME)
        log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", so, *objs]])
        seconds = time.perf_counter() - t0
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(cached=False, seconds=seconds, log=log)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.istnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.istnet_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types declared."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().istnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


P = ctypes.c_void_p
I = ctypes.c_int


F32 = (torch.float32,)
BF16 = (torch.bfloat16,)
F32_BF16 = (torch.float32, torch.bfloat16)
I32 = (torch.int32,)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises:
    there is neither a kernel nor a plain version for it."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def cuda_inputs(name: str, *tensors, dtypes=None):
    """Validate the tensors a wrapper hands to its kernel and return them
    contiguous. Each must be a CUDA tensor on one device, of a dtype its
    kernel takes: ``dtypes`` gives one tuple of accepted dtypes per tensor
    (float32 for all when omitted). With grad mode on none may require
    grad: a wrapper launches its kernel and records no graph. The
    gradients are the autograd Functions' (``ball_query_group.py``,
    ``fp_interpolate.py``), whose forward and backward call the
    wrappers."""
    dev = tensors[0].device
    dtypes = dtypes or [F32] * len(tensors)
    out = []
    for t, ok in zip(tensors, dtypes, strict=True):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must be on {dev}, got "
                             f"{t.device}")
        if t.dtype not in ok:
            raise TypeError(f"{name}: {' or '.join(map(str, ok))} inputs "
                            f"only, got {t.dtype}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the kernel wrapper is forward-only; "
                               f"call it under torch.no_grad() or use the "
                               f"differentiable op of istnet_tpu_torch.ops")
        out.append(t.contiguous())
    return out


def stream(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
