"""The package's CUDA library rebuilt from an edited copy of its sources, for
the ``--sweep`` modes of ``tools/scatter_variants_torch.py`` and
``tools/three_nn_variants_torch.py``."""

from __future__ import annotations

import contextlib
import re


@contextlib.contextmanager
def edited_build(name: str, edits, sources):
    """Inside the block the package's kernels come from a copy of
    ``sources`` (file names in its ``csrc/``) with ``edits`` applied, each a
    ``(file, old text, new text)``, built under ``<build>/sweep/<name>/``
    at the first call; on exit the package's own sources and library come
    back. Raises ``ValueError`` where an old text is not in its file."""
    from istnet_tpu_torch.ops import _build

    def reset():
        _build._lib = None
        _build._fns.clear()
        _build.build_info.clear()

    csrc, build = _build.CSRC, _build.BUILD
    root = build / "sweep" / re.sub(r"[^\w-]+", "_", name)
    (root / "csrc").mkdir(parents=True, exist_ok=True)
    for src in sources:
        text = (csrc / src).read_text()
        for file, old, new in edits:
            if file == src:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not in {src}")
                text = text.replace(old, new)
        (root / "csrc" / src).write_text(text)
    _build.CSRC, _build.BUILD = root / "csrc", root / "lib"
    reset()
    try:
        yield
    finally:
        _build.CSRC, _build.BUILD = csrc, build
        reset()
