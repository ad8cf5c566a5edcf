"""The check that the process that prints a result never loaded JAX or the
JAX package: every module name in ``sys.modules`` is compared by its whole
top-level name (the part before the first dot), so ``qtpu_torch`` passes
and ``qtpu`` fails."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qtpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among the module ``names``, sorted."""
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
