"""The numbers that decide ``correct``, each held to a limit of its own.

- ``gap``: the widest difference between the program's answers and the
  reference's over every compared element, as a share of the reference
  answers' root mean square (per kind of answer: rotations, translations,
  sizes, NOCS points).
- ``leaf_gap``: over leaves (parameters, or running statistics), the gap
  between the program's norm and the reference's, as a share of the
  larger of that leaf's reference norm and the median leaf's.
- ``rotation_gaps``: per answer, the widest difference of its rotation
  in the scale of the reference's 6D rotation.
- ``rel_gap``: the widest relative difference of scalars (loss parts).

A runner computes every number it has; a cell compares those its limits
file names.
"""

from __future__ import annotations

import math
import statistics

import torch

#: the control of a configuration's precision: the reference one step
#: below it (TF32 for float32 with TF32 off, fp8 for bf16)
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def gap(prog, ref) -> float:
    """max |prog - ref| / rms(ref) over matching tensors of two lists;
    infinite where their shapes differ."""
    if len(prog) != len(ref) or any(a.shape != b.shape
                                    for a, b in zip(prog, ref)):
        return math.inf
    p = torch.cat([t.reshape(-1).double() for t in prog])
    r = torch.cat([t.reshape(-1).double() for t in ref])
    rms = math.sqrt(float((r * r).mean()))
    return float((p - r).abs().max()) / max(rms, 1e-30)


def rotation_gaps(prog: list, ref: list, rot6d: list) -> torch.Tensor:
    """Per answer the widest difference of its rotation matrix, times the
    sine of the angle between the two 3-vectors of the reference's 6D
    rotation: the rotation is made from them by Gram-Schmidt, which
    divides their rounding by that sine, so an answer's error counts in
    the 6D representation's own scale (a head whose two vectors are
    nearly parallel, as random weights can make it, amplifies every
    rounding alike)."""
    p = torch.cat([t.double().flatten(1) for t in prog])
    r = torch.cat([t.double().flatten(1) for t in ref])
    if p.shape != r.shape:
        return torch.full((1,), math.inf, dtype=torch.float64)
    six = torch.cat([t.double() for t in rot6d])
    x, y = six[:, :3], six[:, 3:]
    sine = (torch.linalg.vector_norm(torch.linalg.cross(x, y), dim=-1)
            / (torch.linalg.vector_norm(x, dim=-1)
               * torch.linalg.vector_norm(y, dim=-1)).clamp(min=1e-30))
    return (p - r).abs().amax(dim=1) * sine


def add_pose_numbers(verdict, prog: dict, ref: dict, rot6d: list) -> None:
    """The pose answers' numbers: ``ts_gap`` (translations and sizes),
    ``rot_gap`` (rotations in the 6D scale) and ``pose_gap`` (all three
    by ``gap``, the rotation unscaled). ``prog`` and ``ref`` map each pose
    key to matching lists of ``(n, ...)`` tensors."""
    rot, size, trans = "pred_rotation", "pred_size", "pred_translation"
    verdict.add("ts_gap", max(gap(prog[k], ref[k]) for k in (trans, size)))
    verdict.add("rot_gap", float(rotation_gaps(prog[rot], ref[rot],
                                               rot6d).max()))
    verdict.add("pose_gap", max(gap(prog[k], ref[k]) for k in prog))


def leaf_gaps(prog: dict, ref: dict) -> list[float]:
    """Per leaf of ``ref``: ``|norm_p - norm_r| / max(norm_r, median
    norm_r)``."""
    median = statistics.median(ref.values())
    return [abs(prog[k] - v) / max(v, median, 1e-30) for k, v in ref.items()]


def leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(prog, ref))


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median leaf's gap."""
    return statistics.median(leaf_gaps(prog, ref))


def rel_gap(prog: dict, ref: dict) -> float:
    return max(abs(prog[k] - v) / max(abs(v), 1e-12) for k, v in ref.items())


class Verdict:
    """The compared numbers: ``(name, value, limit)`` for each number the
    limits name (every number with ``record_all``, unlimited), correct
    when every value is finite and at most its limit."""

    def __init__(self, limits: dict, record_all: bool = False):
        self.limits = limits
        self.record_all = record_all
        self.rows: list[tuple[str, float, float]] = []

    def add(self, name: str, value: float) -> None:
        if name in self.limits or self.record_all:
            self.rows.append((name, float(value),
                              float(self.limits.get(name, math.inf))))

    @property
    def correct(self) -> bool:
        """Every number the limits name was compared and is within."""
        seen = {name for name, _, _ in self.rows}
        return bool(self.rows) and set(self.limits) <= seen and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.rows)

    def as_dict(self) -> dict:
        return {name: {"value": v, "limit": lim} for name, v, lim in self.rows}

    def lines(self) -> list[str]:
        return [f"check {name}: {v!r} (limit {lim!r}) "
                f"{'ok' if math.isfinite(v) and v <= lim else 'FAILED'}"
                for name, v, lim in self.rows]
