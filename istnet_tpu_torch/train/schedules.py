"""LR and BatchNorm-momentum schedules, pure functions of the step
(counterpart of ``istnet_tpu/train/schedules.py``).

The reference trains with torch's ``CyclicLR`` (triangular, base 1e-5, max
1e-3) and a BN momentum of ``0.9 * 0.5 ** floor(step / 4000)`` clipped at
0.01. JAX evaluates both in float32; so do these, operation by operation,
with numpy float32 scalars, and return the float32 value as a Python float.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def cyclic_triangular_lr(step: int, base_lr: float = 1e-5,
                         max_lr: float = 1e-3, step_size_up: int = 20000,
                         step_size_down: int | None = None) -> float:
    """``CyclicLR(mode='triangular', cycle_momentum=False)`` at ``step``:
    ``base + (max - base) * max(0, scale)``, ``scale`` rising from 0 to 1
    over ``step_size_up`` steps and falling back over ``step_size_down``."""
    up = float(step_size_up)
    down = float(step_size_down if step_size_down is not None
                 else step_size_up)
    total = up + down
    s = _F(step)
    cycle = np.floor(_F(1.0) + s / _F(total))
    x = s / _F(total) - (cycle - _F(1.0))
    if x <= _F(up / total):
        scale = x * _F(total) / _F(up)
    else:
        scale = (_F(total) - x * _F(total)) / _F(down)
    return float(_F(base_lr) + _F(max_lr - base_lr) * max(_F(0.0), scale))


def bn_momentum(step: int, bn_mom: float = 0.9, bn_decay: float = 0.5,
                decay_step: int = 4000, clip: float = 0.01) -> float:
    """The reference's BN momentum at ``step`` (torch semantics:
    ``running = (1 - m) * running + m * batch``)."""
    m = _F(bn_mom) * _F(bn_decay) ** np.floor(_F(step) / _F(decay_step))
    return float(max(m, _F(clip)))
