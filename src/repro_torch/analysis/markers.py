"""Source markers consumed by the analysis subsystem.

``@hot_path`` is a no-op at runtime: it tags a function as part of the
decode hot path so the AST lint (``repro.analysis.lint``, rule MG101)
holds it to the no-host-sync contract — no ``np.asarray`` / ``float()`` /
``.item()`` / ``.tolist()`` / ``.block_until_ready()`` on device values
inside it, except at lines carrying a justified allowlist comment
(``# lint: allow[MG101] <why this sync is planned>``).

The marker is matched BY NAME in the AST (``hot_path`` or
``markers.hot_path`` in a decorator list), so the lint needs no imports
to resolve it; the runtime attribute is only for introspection.
"""
from __future__ import annotations

HOT_PATH_ATTR = "__hot_path__"


def hot_path(fn):
    """Mark ``fn`` as a decode hot-path function (lint rule MG101 scope)."""
    setattr(fn, HOT_PATH_ATTR, True)
    return fn


def is_hot_path(fn) -> bool:
    return bool(getattr(fn, HOT_PATH_ATTR, False))
