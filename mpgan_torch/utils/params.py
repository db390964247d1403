"""Reference-compatible CLI parameter shim.

The reference (tempoGAN-family ``paramhelpers.py``, see SURVEY.md §2.2) parses
``sys.argv`` as a flat ``name value`` token stream: ``getParam(name, default)``
scans argv for ``name`` and returns the *following* token as a string; callers
cast. A used-params set plus ``checkUnusedParams()`` aborts on typos.

This module reproduces that exact surface (so the reference's command lines work
verbatim against our entry scripts) while adding a typed layer on top
(:func:`get_typed`) used by :mod:`mpgan_torch.config` to build dataclass configs.

A copy of ``mpgan_tpu/utils/params.py``: the port imports nothing of the
JAX package, so it keeps its own copy of this jax-free module.

Reference parity: paramhelpers.getParam / checkUnusedParams (file:line unknown —
reference mount was empty at survey time; behavior per SURVEY.md §2.2).
"""

from __future__ import annotations

import shutil
import sys
from typing import Any, Sequence

# Module-level state mirrors the reference's globals.
_params: list[str] | None = None  # tokenized argv (excluding argv[0])
_used: set[str] = set()


def setParams(argv: Sequence[str]) -> None:
    """Install the token stream to parse (excluding the program name)."""
    global _params, _used
    _params = list(argv)
    _used = set()


def _tokens() -> list[str]:
    global _params
    if _params is None:
        _params = list(sys.argv[1:])
    return _params


def getParam(name: str, default: Any) -> str:
    """Return the token following ``name`` in argv, else ``str(default)``.

    Matches the reference semantics: everything comes back as a *string*;
    the caller casts. Matching is case-insensitive like upstream paramhelpers.
    """
    toks = _tokens()
    low = name.lower()
    for i, tok in enumerate(toks):
        if tok.lower() == low and i + 1 < len(toks):
            _used.add(low)
            return toks[i + 1]
    _used.add(low)
    return str(default)


def hasParam(name: str) -> bool:
    """True when ``name`` appears as a flag with a value — same token scan
    as getParam (any position followed by a value token), so the two can
    never disagree about whether a flag is present. Part of the reference's
    paramhelpers API surface; does not mark the param as used."""
    toks = _tokens()
    low = name.lower()
    return any(tok.lower() == low and i + 1 < len(toks)
               for i, tok in enumerate(toks))


def checkUnusedParams() -> None:
    """Abort (SystemExit) if argv contains a ``name`` token never requested.

    Argv is interpreted as alternating name/value pairs, as upstream does.
    """
    toks = _tokens()
    ok = True
    for i in range(0, len(toks) - 1, 2):
        if toks[i].lower() not in _used:
            print(f"Error: param '{toks[i]}' was set but never used; typo?")
            ok = False
    if len(toks) % 2 != 0:
        print("Error: odd number of param tokens; params are 'name value' pairs")
        ok = False
    if not ok:
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# Typed layer (rebuild-native; not part of the reference surface)
# ---------------------------------------------------------------------------

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def get_typed(name: str, default: Any) -> Any:
    """Like getParam but casts the returned string to ``type(default)``."""
    raw = getParam(name, default)
    if isinstance(default, bool):
        s = raw.strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"param {name}: cannot parse bool from {raw!r}")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def backupFile(name: str, test_path: str) -> None:
    """Copy a source file into the run output dir (reference keeps param logs)."""
    try:
        shutil.copy(name, test_path)
    except OSError:
        pass
