"""The check that no module of JAX, of its libraries or of the JAX package
was loaded. A module's top-level name (before the first dot) is compared
whole: ``mpgan_torch`` begins with the JAX package's name but is not it."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax",
                       "mpgan_tpu"})


def loaded_forbidden(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check(stage: str) -> None:
    """Raise ``SystemExit`` naming what was found, if anything was."""
    found = loaded_forbidden()
    if found:
        print(f"port_bench: {stage}: forbidden modules loaded: "
              f"{', '.join(found[:20])}", file=sys.stderr)
        raise SystemExit(3)
