"""Peaks of one NVIDIA H100 and the least time of each hand-written
kernel call (a copy of the port's ``chip_smoke.py::bound_ms`` arithmetic).

Peaks, NVIDIA's data sheet for the SXM part, dense: 3.35 TB/s of HBM,
989 TFLOP/s bf16 on tensor cores, 67 TFLOP/s float32 outside them (the
port keeps TF32 off, so float32 work is held to that rate).

A call's least time is the larger of its bytes (every input tensor read
once, every output written once, at the HBM rate) and its operations at
the peak of their type: ~10 a point pair for an FPS distance update, ~8
for a ball-query or 3-NN distance test, 2 a multiply-add of an MLP or
convolution (the fused SA stage reassociated: layer 1 once a point and
radius, its xyz rows in float32 for points and centroids, layers 2..L once
a slot row; the fold: the channel contraction once a low-resolution pixel
and tap), ~6 a channel for a 3-point interpolation, 1 an added element for
the scatters; the depth fill ~36 a pixel plus ~442 a valid input pixel;
the eval BatchNorm pass its bytes alone (its ~8 float32 operations an
element take a tenth of its bytes' time or less).
A kernel wrapper that the program adds later, with no formula here, is
held to its bytes alone, which is still a lower bound, and is named on
standard error; a call of a kernel with a formula whose arguments are
laid out otherwise raises, so that the count never changes meaning
unseen.

``KernelMeter`` installs a counting wrapper around each kernel wrapper of
the program (``istnet_tpu_torch.ops.dispatch``) for a traced window and
sums the calls' least times. The depth fill's valid-pixel count is summed
on the device and read once, after the window.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from pathlib import Path

HBM_BPS = 3.35e12
BF16_OPS = 989e12
F32_OPS = 67e12
PEAK_OPS = {"bfloat16": BF16_OPS, "float32": F32_OPS}


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)
    elif dataclasses.is_dataclass(x):
        # packed weights: what they were made from, not a derived layout
        for f in dataclasses.fields(x):
            if f.name != "km":
                yield from _tensors(getattr(x, f.name))


#: the kernels with a formula below
FORMULAS = frozenset({"fps", "ball_query_group", "ball_query", "sa_fused",
                      "fp_interpolate", "three_nn", "fold_upsample",
                      "group_scatter", "interp_scatter", "depth_fill",
                      "bn_eval"})


def bound_parts(name: str, args, out):
    """``(bytes, float32 operations, bf16 tensor-core operations, device
    tensor of valid pixels or None)`` of one call of kernel ``name`` (its
    bytes alone where ``name`` has no formula)."""
    import torch
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(_tensors(args)) + list(_tensors(out)))
    f32 = mma = 0.0
    valid = None
    if name == "fps":
        b, n, _ = args[0].shape
        f32 = 10.0 * b * n * args[1]
    elif name in ("ball_query_group", "ball_query", "sa_fused"):
        xyz, new_xyz = args[2], args[3]
        b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        f32 = 8.0 * b * n * m
        if name == "sa_fused":
            for ns, ch in zip(args[1], args[5].chans):
                mma += 2.0 * b * n * (ch[0] - 3) * ch[1]
                f32 += 2.0 * 3 * b * (n + m) * ch[1]
                mma += sum(2.0 * ci * co for ci, co in zip(ch[1:-1], ch[2:])) \
                    * b * m * ns
    elif name in ("fp_interpolate", "three_nn"):
        b, n, m = args[0].shape[0], args[0].shape[1], args[1].shape[1]
        f32 = 8.0 * b * n * m
        if name == "fp_interpolate":
            f32 += 6.0 * b * n * args[2].shape[-1]
    elif name == "fold_upsample":
        b, h, w, cin = args[0].shape
        ops = 2.0 * 9 * b * h * w * cin * args[1].k.shape[-1]
        if args[0].dtype == torch.bfloat16:
            mma = ops
        else:
            f32 = ops
    elif name == "group_scatter":
        f32 = float(sum(g.numel() for g in args[1]))
    elif name == "interp_scatter":
        f32 = 6.0 * args[0].numel()
    elif name == "depth_fill":
        f32 = 36.0 * args[0].numel()
        valid = (args[0] > 0.01).sum()
    elif name == "bn_eval":
        x, rows = args[0], args[1]
        if tuple(rows.shape) != (4, x.shape[-1]):
            raise ValueError(f"bn_eval: rows {tuple(rows.shape)} for a map "
                             f"of {x.shape[-1]} channels")
    return nbytes, f32, mma, valid


def least_ms(nbytes: float, f32: float, mma: float) -> float:
    return max(nbytes / HBM_BPS, f32 / F32_OPS + mma / BF16_OPS) * 1e3


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"([A-Za-z_]\w*)\s*\(")


def kernel_names() -> set[str]:
    """The names of the program's hand-written device kernels, read from
    its CUDA sources."""
    import istnet_tpu_torch
    csrc = Path(istnet_tpu_torch.__file__).resolve().parent / "csrc"
    names = set()
    for p in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(p.read_text()))
    return names


class KernelMeter:
    """Counts each kernel wrapper's calls and keeps each call's bound
    while installed (a context manager); ``finish`` sums the calls' least
    ms once the window is over."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.bytes_only: set[str] = set()
        self._records = []
        self._saved = []

    def __enter__(self):
        from istnet_tpu_torch.ops import dispatch
        for name in dispatch.KERNELS:
            fn = dispatch.wrapper(name)
            module = sys.modules[fn.__module__]
            wrapped = self._wrap(name, fn)
            self._saved.append((module, fn.__name__, fn, wrapped))
            setattr(module, fn.__name__, wrapped)
        return self

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls[name] = self.calls.get(name, 0) + 1
            if name in FORMULAS:
                record = bound_parts(name, args, out)
            else:
                self.bytes_only.add(name)
                record = bound_parts(name, (args, tuple(kwargs.values())),
                                     out)
            self._records.append(record)
            return out
        # the wrappers count their launches on their own global name
        wrapped.launches = getattr(fn, "launches", 0)
        return wrapped

    def __exit__(self, *exc):
        for module, attr, fn, wrapped in self._saved:
            setattr(module, attr, fn)
            if hasattr(fn, "launches"):
                fn.launches = wrapped.launches
        self._saved = []
        return False

    def finish(self) -> float:
        """The summed least ms of every call (reads the device counts)."""
        total = 0.0
        for nbytes, f32, mma, valid in self._records:
            if valid is not None:
                f32 += 442.0 * float(valid)
            total += least_ms(nbytes, f32, mma)
        return total
