"""FS-Net-style shape augmentations on the host (numpy; counterpart of
``istnet_tpu/data/augment.py``). They run in the data loader's threads.

- ``defor_3d_bb``: anisotropic bbox stretch in the object frame; classes
  symmetric about y (``sym[0] == 1``) tie the x/z stretch to their mean.
- ``defor_3d_rt``: random translation + rotation of the cloud and the pose
  (the translated cloud AND t are rotated by Rm, as in the reference).
- ``defor_3d_bc``: box-cage y-taper (mug and bowl only).
- ``defor_3d_pc``: gaussian point noise.
- ``deform_non_linear``: quadratic per-axis resize.
- ``data_augment``: the probability dispatcher (the shipped configs enable
  only bb + rt at p = 0.3).

Every draw comes from the caller's ``RandomState`` in the JAX package's
order, so the same seed gives the same samples bit for bit.
"""

from __future__ import annotations

import math

import numpy as np


def get_rotation(x_deg: float, y_deg: float, z_deg: float) -> np.ndarray:
    """Euler XYZ in degrees (applied as Rz @ Ry @ Rx) -> 3x3."""
    x, y, z = (math.radians(v) for v in (x_deg, y_deg, z_deg))
    rx = np.array([[1, 0, 0],
                   [0, math.cos(x), -math.sin(x)],
                   [0, math.sin(x), math.cos(x)]])
    ry = np.array([[math.cos(y), 0, math.sin(y)],
                   [0, 1, 0],
                   [-math.sin(y), 0, math.cos(y)]])
    rz = np.array([[math.cos(z), -math.sin(z), 0],
                   [math.sin(z), math.cos(z), 0],
                   [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


def generate_aug_parameters(rng: np.random.RandomState,
                            s_range=(0.8, 1.2), a_trans=50.0, a_rot=15.0):
    """Random bb stretch, translation (mm -> m) and rotation."""
    ex, ey, ez = rng.rand(3) * (s_range[1] - s_range[0]) + s_range[0]
    rm = get_rotation(rng.uniform(-a_rot, a_rot), rng.uniform(-a_rot, a_rot),
                      rng.uniform(-a_rot, a_rot))
    d = rng.rand(3) * 2 * a_trans - a_trans
    return (np.array([ex, ey, ez], np.float32),
            (d / 1000.0).astype(np.float32), rm)


def defor_3d_bb(pc, r, t, s, nocs, model, sym, aug_bb):
    pc_obj = (pc - t[None]) @ r  # R^T (pc - t)
    ex, ey, ez = aug_bb
    if sym[0] == 1:
        exz = (ex + ez) / 2
        scale_vec = np.array([exz, ey, exz], np.float32)
    else:
        scale_vec = np.array([ex, ey, ez], np.float32)
    nocs_scale_aug = np.linalg.norm(s * scale_vec) / np.linalg.norm(s)
    pc_obj = pc_obj * scale_vec[None]
    s = s * scale_vec
    nocs = nocs * scale_vec[None] / nocs_scale_aug
    model = model * scale_vec[None] / nocs_scale_aug
    pc_new = pc_obj @ r.T + t[None]
    return pc_new.astype(np.float32), s.astype(np.float32), nocs, model


def defor_3d_rt(pc, r, t, aug_rt_t, aug_rt_r):
    pc = pc + aug_rt_t[None]
    t = t + aug_rt_t
    rm = aug_rt_r
    pc = pc @ rm.T
    r = rm @ r
    t = rm @ t
    return pc.astype(np.float32), r.astype(np.float32), t.astype(np.float32)


def defor_3d_bc(pc, r, t, s, model, nocs, rng):
    ey_up = rng.rand() * 0.4 + 0.8
    ey_down = rng.rand() * 0.4 + 0.8
    pc_obj = (pc - t[None]) @ r
    resize = (pc_obj[:, 1] + s[1] / 2) / s[1] * (ey_up - ey_down) + ey_down
    pc_obj[:, 0] *= resize
    pc_obj[:, 2] *= resize
    pc_new = pc_obj @ r.T + t[None]

    norm_s = s / np.linalg.norm(s)
    m_resize = (model[:, 1] + norm_s[1] / 2) / norm_s[1] * (ey_up - ey_down) + ey_down
    model = model.copy()
    model[:, 0] *= m_resize
    model[:, 2] *= m_resize

    lx = 2 * max(model[:, 0].max(), -model[:, 0].min())
    ly = model[:, 1].max() - model[:, 1].min()
    lz = model[:, 2].max() - model[:, 2].min()
    size_new = np.array([lx, ly, lz], np.float32) * np.linalg.norm(s)
    nocs_scale_aug = np.linalg.norm([lx, ly, lz])
    model = model / nocs_scale_aug

    nocs = nocs.copy()
    n_resize = (nocs[:, 1] + norm_s[1] / 2) / norm_s[1] * (ey_up - ey_down) + ey_down
    nocs[:, 0] *= n_resize
    nocs[:, 2] *= n_resize
    nocs = nocs / nocs_scale_aug
    return pc_new.astype(np.float32), size_new, model, nocs


def defor_3d_pc(pc, r, rng):
    return (pc + rng.randn(*pc.shape).astype(np.float32) * r).astype(np.float32)


def deform_non_linear(pc, r, t, s, nocs, model, axis, rng):
    r_max = rng.rand() * 0.2 + 1.1
    r_min = -rng.rand() * 0.2 + 0.9
    pc_obj = (pc - t[None]) @ r
    resize = r_min + 4 * (pc_obj[:, axis] ** 2) / (s[axis] ** 2) * (r_max - r_min)
    pc_obj[:, axis] *= resize
    pc_new = pc_obj @ r.T + t[None]

    norm_s = s / np.linalg.norm(s)
    model = model.copy()
    m_resize = r_min + 4 * (model[:, axis] ** 2) / (norm_s[axis] ** 2) * (r_max - r_min)
    model[:, axis] *= m_resize

    lx = 2 * max(model[:, 0].max(), -model[:, 0].min())
    ly = model[:, 1].max() - model[:, 1].min()
    lz = model[:, 2].max() - model[:, 2].min()
    size_new = np.array([lx, ly, lz], np.float32) * np.linalg.norm(s)
    nocs_scale_aug = np.linalg.norm([lx, ly, lz])
    model = model / nocs_scale_aug

    nocs = nocs.copy()
    n_resize = r_min + 4 * (nocs[:, axis] ** 2) / (norm_s[axis] ** 2) * (r_max - r_min)
    nocs[:, axis] *= n_resize
    nocs = nocs / nocs_scale_aug
    return pc_new.astype(np.float32), size_new, model, nocs


def data_augment(cfg, pc, gt_r, gt_t, gt_s, sym, aug_bb, aug_rt_t, aug_rt_r,
                 model, nocs_scale, nocs, obj_id, rng: np.random.RandomState):
    """Apply each augmentation with its configured probability."""
    if rng.rand() < cfg.get("aug_bb_pro", 0.0):
        pc, gt_s, nocs, model = defor_3d_bb(pc, gt_r, gt_t, gt_s, nocs, model,
                                            sym=sym, aug_bb=aug_bb)
    if rng.rand() < cfg.get("aug_rt_pro", 0.0):
        pc, gt_r, gt_t = defor_3d_rt(pc, gt_r, gt_t, aug_rt_t, aug_rt_r)
    if rng.rand() < cfg.get("aug_bc_pro", 0.0) and obj_id in (1, 5):  # bowl, mug
        pc, gt_s, model, nocs = defor_3d_bc(pc, gt_r, gt_t, gt_s, model, nocs, rng)
    if rng.rand() < cfg.get("aug_pc_pro", 0.0):
        pc = defor_3d_pc(pc, cfg.get("aug_pc_r", 0.002), rng)
    if rng.rand() < cfg.get("aug_nl_pro", 0.0) and obj_id in (0, 1, 2, 3, 5):
        axis = 0 if obj_id == 2 else 1
        pc, gt_s, model, nocs = deform_non_linear(pc, gt_r, gt_t, gt_s, nocs,
                                                  model, axis, rng)
    return pc, gt_r, gt_t, gt_s, model, nocs
