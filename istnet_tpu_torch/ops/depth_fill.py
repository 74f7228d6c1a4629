"""Kernel 11: ip_basic multiscale depth completion (``csrc/depth_fill.cu``).

Replaces the TPU kernel ``istnet_tpu/ops/depth_fill_pallas.py:
_fill_kernel`` (reached through ``fill_in_multiscale_pallas``).
``plain`` follows the JAX package's XLA pipeline ``data/device_preprocess.
py::fill_in_multiscale_tpu`` op for op in PyTorch and runs on any device;
the CPU uses it. Every maximum, minimum and median is exact, so kernel and
plain version agree bit for bit up to the bilateral filter, whose ``exp``,
products and divide round on their own. ``bilateral=False`` on the wrapper
and on ``plain`` stops before that filter; it is an argument for checks
alone (it lets the exact part be held equal) and ``ops.fill_in_multiscale``
does not offer it. The kernel takes any
``H, W >= 5``: the TPU kernel's ``W % 128``, ``H % 8`` gate came from
Mosaic's tiling.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from istnet_tpu_torch.ops import _build

SOURCE = "istnet_tpu_torch/csrc/depth_fill.cu"
REPLACES = "istnet_tpu/ops/depth_fill_pallas.py:201"
VALID = 0.01

__all__ = ["fill_in_multiscale_cuda", "plain", "median5", "disk_offsets"]


def disk_offsets(radius: int = 2) -> list[tuple[int, int]]:
    """The taps of the bilateral's disk footprint, row-major."""
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]


def _dilate(x: torch.Tensor, kind: str, radius: int) -> torch.Tensor:
    """Max over a footprint of a (B, H, W) map; outside counts as -inf
    (``max_pool2d`` pads with -inf)."""
    k = 2 * radius + 1
    x = x[:, None]
    if kind == "full":
        out = F.max_pool2d(x, k, 1, radius)
    else:  # cross: a horizontal and a vertical segment
        out = torch.maximum(F.max_pool2d(x, (1, k), 1, (0, radius)),
                            F.max_pool2d(x, (k, 1), 1, (radius, 0)))
    return out[:, 0]


def _erode(x: torch.Tensor, radius: int) -> torch.Tensor:
    return -_dilate(-x, "full", radius)


def _taps(x: torch.Tensor, offsets, mode: str) -> torch.Tensor:
    """Shifted copies stacked last: (B, H, W) -> (B, H, W, len(offsets))."""
    _, h, w = x.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    xp = F.pad(x[:, None], (r, r, r, r), mode=mode)[:, 0]
    return torch.stack([xp[:, r + dy:r + dy + h, r + dx:r + dx + w]
                        for dy, dx in offsets], dim=-1)


def median5(x: torch.Tensor) -> torch.Tensor:
    """Exact 5x5 median of a (B, H, W) map, edge-replicated borders
    (``cv2.medianBlur``): rank 12 of the 25 sorted taps."""
    offsets = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
    return _taps(x, offsets, "replicate").sort(dim=-1).values[..., 12]


def _bilateral5(x: torch.Tensor, sigma_color: float = 0.5,
                sigma_space: float = 2.0) -> torch.Tensor:
    """5x5 disk bilateral, reflect-101 borders (``cv2.bilateralFilter``)."""
    offsets = disk_offsets(2)
    space = torch.tensor(
        [math.exp(-0.5 * (dy * dy + dx * dx) / sigma_space ** 2)
         for dy, dx in offsets], dtype=torch.float32, device=x.device)
    p = _taps(x, offsets, "reflect")
    diff = p - x[..., None]
    w = space * torch.exp(-0.5 * diff.square() / sigma_color ** 2)
    return (w * p).sum(-1) / w.sum(-1)


def _top_mask(x: torch.Tensor) -> torch.Tensor:
    """Rows at or below the first valid row of their column; all true for
    an empty column."""
    h = x.shape[1]
    rows = torch.arange(h, device=x.device)[None, :, None]
    first = torch.where(x > VALID, rows, h).amin(dim=1, keepdim=True)
    first = torch.where(first == h, 0, first)
    return rows >= first


def plain(depth: torch.Tensor, max_depth: float = 3.0,
          bilateral: bool = True) -> torch.Tensor:
    """(B, H, W) metres -> completed depth, plain PyTorch."""
    x = depth.float()
    near = (x > VALID) & (x <= 1.0)
    med = (x > 1.0) & (x <= 2.0)
    far = x > 2.0

    x = torch.where(x > VALID, max_depth - x, x)

    # the three band dilations read the ORIGINAL inverted depths and are
    # combined farthest to nearest
    inv0 = x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for mask, r in ((far, 1), (med, 2), (near, 3)):
        d = _dilate(torch.where(mask, inv0, zero), "cross", r)
        x = torch.where(d > VALID, d, x)

    x = _erode(_dilate(x, "full", 2), 2)  # 5x5 closing

    x = torch.where(x > VALID, median5(x), x)

    top = _top_mask(x)
    x = torch.where(~(x > VALID) & top, _dilate(x, "full", 4), x)  # 9x9 fill

    top = _top_mask(x)
    for _ in range(6):
        x = torch.where((x < VALID) & top, _dilate(x, "full", 2), x)

    valid = (x > VALID) & top
    x = torch.where(valid, median5(x), x)
    if bilateral:
        x = torch.where(valid, _bilateral5(x), x)  # the median step's mask

    return torch.where(x > VALID, max_depth - x, x)


def fill_in_multiscale_cuda(depth: torch.Tensor, max_depth: float = 3.0,
                            bilateral: bool = True) -> torch.Tensor:
    """(B, H, W) f32 metres on the card -> completed depth; two launches
    (two tiled stages, the first reducing the top mask's rows by atomics)
    and one memset, one count."""
    (depth,) = _build.cuda_inputs("depth_fill", depth)
    if depth.dim() != 3 or min(depth.shape[1:]) < 5:
        raise ValueError(f"depth_fill: (B, H, W) with H, W >= 5, got "
                         f"{tuple(depth.shape)}")
    b, h, w = depth.shape
    # the first stage's output; the C entry's second scratch is unused
    tmp = torch.empty_like(depth)
    first = torch.empty(b, w, dtype=torch.int32, device=depth.device)
    out = torch.empty_like(depth)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_depth_fill",
                         [P, I, I, I, _build.ctypes.c_float, I, P, P, P, P, P])
    err = fn(depth.data_ptr(), b, h, w, float(max_depth), int(bilateral),
             tmp.data_ptr(), tmp.data_ptr(), first.data_ptr(),
             out.data_ptr(), _build.stream(depth))
    _build.check(err, "istnet_depth_fill")
    fill_in_multiscale_cuda.launches += 1
    return out


fill_in_multiscale_cuda.launches = 0
