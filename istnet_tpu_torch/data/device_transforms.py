"""Batched ColorJitter on the device (counterpart of
``istnet_tpu/data/device_transforms.py``).

The reference jitters each RGB crop on the host with torchvision's
``ColorJitter(0.2, 0.2, 0.2, 0.05)``: brightness, contrast, saturation and
hue, each with a uniform factor, in a random order. Here the same transform
runs batched on the crops' device, as float math on 0..255 images:

- brightness: ``img * f``;
- contrast: a blend with the scalar mean of the grayscale;
- saturation: a blend with the per-pixel grayscale;
- hue: an HSV hue rotation by ``f`` turns.

Brightness, contrast and saturation are maps ``p -> a*p + b*gray(p) +
c*mean(gray(p))``, a family closed under composition, so the ops before the
hue rotation compose into one affine pass (``_compose_affine``), the hue
turns once, and the ops after it compose into a second pass.

This computes the JAX function, not PIL's: a float pipeline without uint8
rounding between ops, the exact grayscale mean, and clipping after each
affine group rather than after each op.

The draws are tensors: ``factors (B, 3)`` of brightness, contrast and
saturation, already in ``[1 - x, 1 + x]``; ``hue (B,)`` in ``[-x, x]``;
``order_id (B,)``, an index into ``ORDERS``, the 24 permutations of the 4
ops in ``itertools.permutations`` order (op 3 is the hue).
``draw_color_jitter`` makes them from a ``torch.Generator``.
"""

from __future__ import annotations

import functools
import itertools

import torch

from istnet_tpu_torch.data.device_preprocess import _div

ORDERS = tuple(itertools.permutations(range(4)))
# ColorJitter(brightness, contrast, saturation, hue), as the reference sets it
JITTER = (0.2, 0.2, 0.2, 0.05)
_GRAY = (0.299, 0.587, 0.114)  # ITU-R 601-2, PIL's "L"


@functools.lru_cache(maxsize=None)
def _orders(device: torch.device) -> torch.Tensor:
    """The (24, 4) order table on ``device``, built once per device."""
    return torch.tensor(ORDERS, dtype=torch.long, device=device)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): the luma of each pixel."""
    return (img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1]
            + img[..., 2] * _GRAY[2])


def adjust_brightness(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return (img * f).clamp(0.0, 255.0)


def adjust_contrast(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    mean = _gray(img).mean(dim=(-2, -1), keepdim=True)[..., None]
    return (mean + f * (img - mean)).clamp(0.0, 255.0)


def adjust_saturation(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    gray = _gray(img)[..., None]
    return (gray + f * (img - gray)).clamp(0.0, 255.0)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """0..1 rgb -> h, s, v in 0..1 (h in turns)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    c = mx - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(mx == r, (g - b) / safe_c,
                    torch.where(mx == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(_div(h, 6.0), 1.0),
                    torch.zeros_like(h))
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """h, s, v -> rgb, branch-free: ``v - v*s*clamp(min(k, 4-k), 0, 1)``
    with ``k = (n + 6h) mod 6``."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def f(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([f(5.0), f(3.0), f(1.0)], dim=-1)


def adjust_hue(img: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Rotate the hue by ``f`` turns (broadcastable to the (..., H, W)
    hue plane); img 0..255."""
    hsv = _rgb_to_hsv(_div(img, 255.0))
    h = torch.remainder(hsv[..., 0] + f, 1.0)
    out = _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return (out * 255.0).clamp(0.0, 255.0)


def _compose_affine(a, b, c, op, f):
    """One adjustment composed onto ``p -> a*p + b*G0(p) + c*M0(p)``
    (G0, M0: gray and gray mean of the map's input): brightness ``(fa, fb,
    fc)``, contrast ``(fa, fb, fc + (1-f)(a+b+c))``, saturation ``(fa, fb +
    (1-f)(a+b), c)``; ``op`` 0, 1, 2 picks one per sample."""
    b2 = torch.where(op == 2, f * b + (1 - f) * (a + b), f * b)
    c2 = torch.where(op == 1, f * c + (1 - f) * (a + b + c),
                     torch.where(op == 2, c, f * c))
    return f * a, b2, c2


def _apply_affine(img: torch.Tensor, a, b, c) -> torch.Tensor:
    """img (B, H, W, 3) 0..255; a, b, c (B,) per-sample coefficients."""
    gray = _gray(img)
    mean = gray.mean(dim=(-2, -1), keepdim=True)
    out = (a[:, None, None, None] * img
           + (b[:, None, None] * gray + c[:, None, None] * mean)[..., None])
    return out.clamp(0.0, 255.0)


def draw_color_jitter(b: int, generator: torch.Generator,
                      device=None) -> dict:
    """``color_jitter_batch``'s draws for ``b`` images from ``generator``
    (on ``device``, the generator's by default): with ``JITTER``'s x,
    factors ~ U(1-x, 1+x), hue ~ U(-x, x), a uniform order."""
    device = torch.device(device if device is not None else generator.device)
    brightness, contrast, saturation, hue = JITTER
    u = torch.rand(b, 4, generator=generator, device=device)
    lo = (1 - brightness, 1 - contrast, 1 - saturation, -hue)
    width = (2 * brightness, 2 * contrast, 2 * saturation, 2 * hue)
    scaled = torch.stack([u[:, i] * width[i] + lo[i] for i in range(4)], 1)
    order_id = torch.randint(len(ORDERS), (b,), generator=generator,
                             device=device)
    return {"factors": scaled[:, :3], "hue": scaled[:, 3],
            "order_id": order_id}


def color_jitter_batch(rgb: torch.Tensor, draws: dict) -> torch.Tensor:
    """ColorJitter on (B, H, W, 3) float 0..255 images with per-sample
    factors and order (``draws``: ``factors``, ``hue``, ``order_id``)."""
    b = rgb.shape[0]
    factors = draws["factors"].to(rgb.device, torch.float32)
    per_sample = _orders(rgb.device)[draws["order_id"].to(rgb.device)]

    ones = torch.ones(b, device=rgb.device)
    zeros = torch.zeros(b, device=rgb.device)
    pre = suf = (ones, zeros, zeros)
    seen_hue = torch.zeros(b, dtype=torch.bool, device=rgb.device)
    for step in range(4):
        op = per_sample[:, step]
        is_hue = op == 3
        f_step = factors.gather(1, op.clamp(max=2)[:, None])[:, 0]
        new_pre = _compose_affine(*pre, op, f_step)
        new_suf = _compose_affine(*suf, op, f_step)
        apply_pre = ~seen_hue & ~is_hue
        apply_suf = seen_hue & ~is_hue
        pre = tuple(torch.where(apply_pre, n, o) for n, o in zip(new_pre, pre))
        suf = tuple(torch.where(apply_suf, n, o) for n, o in zip(new_suf, suf))
        seen_hue = seen_hue | is_hue

    img = _apply_affine(rgb.float(), *pre)
    img = adjust_hue(img, draws["hue"].to(rgb.device,
                                          torch.float32)[:, None, None])
    return _apply_affine(img, *suf)
