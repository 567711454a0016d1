"""The whole-name import check: what the run's process has loaded of JAX
or of the JAX package. A module counts by its top-level name, the part
before the first dot, compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
