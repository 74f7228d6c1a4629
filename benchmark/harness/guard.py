"""What a run refuses: too few cards, and JAX or the JAX package loaded.

The JAX package is ``istnet_tpu``; the port under test is
``istnet_tpu_torch``. A module counts by its top-level name, the part
before the first dot, compared whole: ``istnet_tpu_torch.ops`` is the
port's, ``istnet_tpu.ops`` is not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "istnet_tpu")


class Refused(SystemExit):
    """A run that must print no result; its message goes to stderr."""

    def __init__(self, message: str):
        super().__init__(f"benchmark: {message}")


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (``sys.modules`` unless ``names``) whose
    top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_no_jax() -> None:
    found = forbidden_modules()
    if found:
        raise Refused(f"JAX or the JAX package is loaded: {', '.join(found)}")


def require_cards(n: int):
    """The first of ``n`` CUDA cards, or ``Refused``."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA card (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell needs {n} cards, "
                      f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)
