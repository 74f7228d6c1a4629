"""Batched FS-Net shape augmentation on the device (counterpart of
``istnet_tpu/data/device_augment.py``).

The reference stretches the box (``defor_3D_bb``) and moves the cloud
rigidly (``defor_3D_rt``) per sample on the host; here both run batched on
the batch's device inside the train step, each sample gated by its own
Bernoulli draw. Only these two exist on the device (the augmentations the
shipped configs enable); ``train/solver.py`` refuses a config that asks for
the others with it.

The draws are tensors: ``ex (B, 3)`` in ``S_RANGE``, ``u_bb (B,)``,
``angles (B, 3)`` in degrees, ``aug_t (B, 3)`` in metres (already divided
by 1000) and ``u_rt (B,)``; a sample is stretched where ``u_bb <
aug_bb_pro`` and moved where ``u_rt < aug_rt_pro``. ``draw_augment`` makes
them from a ``torch.Generator``. The batch's tensors are promoted to one
float dtype first and the rotation draws with them: JAX promotes as it
goes, a matrix product here does not.
"""

from __future__ import annotations

import functools

import torch

from istnet_tpu_torch.data.device_preprocess import _div

# the draws' ranges, as the reference sets them: the box stretch's factors,
# the rigid motion's translation (mm) and its Euler angles (degrees)
S_RANGE = (0.8, 1.2)
A_TRANS = 50.0
A_ROT = 15.0


def _euler_rotation(angles_deg: torch.Tensor) -> torch.Tensor:
    """(..., 3) XYZ Euler angles in degrees -> (..., 3, 3), Rz @ Ry @ Rx."""
    rad = torch.deg2rad(angles_deg)
    cx, cy, cz = (torch.cos(rad[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(rad[..., i]) for i in range(3))
    z = torch.zeros_like(cx)
    o = torch.ones_like(cx)
    shape = (*cx.shape, 3, 3)
    rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(shape)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(shape)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(shape)
    return rz @ ry @ rx


def defor_3d_bb_batch(pc, r, t, s, nocs, sym0, aug_bb):
    """The box stretch: (B, N, 3) points, (B, 3, 3) R, (B, 3) t and s,
    (B, N, 3) NOCS, (B,) symmetry flag, (B, 3) stretch factors; a symmetric
    sample stretches x and z by their mean."""
    ex, ey, ez = aug_bb[..., 0], aug_bb[..., 1], aug_bb[..., 2]
    exz = (ex + ez) / 2
    scale_vec = torch.where((sym0 == 1)[..., None],
                            torch.stack([exz, ey, exz], -1),
                            torch.stack([ex, ey, ez], -1))
    nocs_scale_aug = (torch.linalg.norm(s * scale_vec, dim=-1)
                      / torch.linalg.norm(s, dim=-1))
    pc_obj = (pc - t[:, None]) @ r * scale_vec[:, None]
    pc_new = pc_obj @ r.transpose(1, 2) + t[:, None]
    s_new = s * scale_vec
    nocs_new = nocs * scale_vec[:, None] / nocs_scale_aug[:, None, None]
    return pc_new, s_new, nocs_new


def defor_3d_rt_batch(pc, r, t, aug_t, aug_r):
    """The rigid motion: translate by ``aug_t``, then rotate by ``aug_r``."""
    pc = (pc + aug_t[:, None]) @ aug_r.transpose(1, 2)
    t = t + aug_t
    return pc, aug_r @ r, (aug_r @ t[..., None])[..., 0]


def draw_augment(b: int, generator: torch.Generator, device=None) -> dict:
    """``device_augment``'s draws for ``b`` samples from ``generator`` (on
    ``device``, the generator's by default)."""
    device = torch.device(device if device is not None else generator.device)
    u = torch.rand(b, 11, generator=generator, device=device)
    return {"ex": u[:, 0:3] * (S_RANGE[1] - S_RANGE[0]) + S_RANGE[0],
            "u_bb": u[:, 3],
            "angles": u[:, 4:7] * (2 * A_ROT) - A_ROT,
            "aug_t": _div(u[:, 7:10] * (2 * A_TRANS) - A_TRANS, 1000.0),
            "u_rt": u[:, 10]}


def device_augment(batch: dict, draws: dict, aug_bb_pro: float = 0.3,
                   aug_rt_pro: float = 0.3) -> dict:
    """The box stretch and the rigid motion of a train batch
    (``{"inputs", "labels"}``: inputs ``pts``, ``qo``, ``sym_info`` (its
    first column is the symmetry flag); labels ``rotation_label``,
    ``translation_label``, ``size_label``, ``qo``), each sample gated by its
    draws. Returns a new batch; the NOCS target goes to both ``qo``."""
    inputs = dict(batch["inputs"])
    labels = dict(batch["labels"])
    parts = (inputs["pts"], labels["rotation_label"],
             labels["translation_label"], labels["size_label"], labels["qo"])
    dtype = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    pc, r, t, s, nocs = (p.to(dtype) for p in parts)
    sym0 = inputs.get("sym_info")
    if sym0 is None:
        sym0 = torch.zeros(pc.shape[0], dtype=torch.int32, device=pc.device)
    elif sym0.dim() > 1:
        sym0 = sym0[:, 0]
    d = {k: v.to(pc.device) for k, v in draws.items()}

    pc_bb, s_bb, nocs_bb = defor_3d_bb_batch(pc, r, t, s, nocs, sym0,
                                             d["ex"])
    take_bb = d["u_bb"] < aug_bb_pro
    pc = torch.where(take_bb[:, None, None], pc_bb, pc)
    s = torch.where(take_bb[:, None], s_bb, s)
    nocs = torch.where(take_bb[:, None, None], nocs_bb, nocs)

    aug_r = _euler_rotation(d["angles"]).to(dtype)
    pc_rt, r_rt, t_rt = defor_3d_rt_batch(pc, r, t, d["aug_t"], aug_r)
    take_rt = d["u_rt"] < aug_rt_pro
    pc = torch.where(take_rt[:, None, None], pc_rt, pc)
    r = torch.where(take_rt[:, None, None], r_rt, r)
    t = torch.where(take_rt[:, None], t_rt, t)

    inputs.update(pts=pc, qo=nocs)
    labels.update(qo=nocs, rotation_label=r, translation_label=t,
                  size_label=s)
    return {"inputs": inputs, "labels": labels}


def make_device_augment(aug_bb_pro: float = 0.3, aug_rt_pro: float = 0.3):
    """``augment(batch, generator_or_draws)``: ``device_augment`` with
    these gates, its draws from a ``torch.Generator`` (``draw_augment``)
    or given as a dict."""

    def augment(batch: dict, generator_or_draws) -> dict:
        draws = generator_or_draws
        if not isinstance(draws, dict):
            draws = draw_augment(batch["inputs"]["pts"].shape[0], draws,
                                 device=batch["inputs"]["pts"].device)
        return device_augment(batch, draws, aug_bb_pro, aug_rt_pro)

    return augment
