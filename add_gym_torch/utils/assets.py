"""Asset resolution.

The G1 robot description and mocap clips are data assets this repository
does not ship.  Relative asset paths resolve from, in order:

1. ``$ADD_GYM_TORCH_ASSETS`` if set,
2. ``<repo>/assets`` if present.

Absolute paths are used as given (the test fixtures and ``chip_smoke.py``
pass absolute paths).
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def asset_root() -> str:
    for cand in (os.environ.get("ADD_GYM_TORCH_ASSETS"), os.path.join(_REPO_ROOT, "assets")):
        if cand and os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        "No asset root found; set ADD_GYM_TORCH_ASSETS to a directory containing "
        "g1_description/ and motions/"
    )


def asset_path(rel: str) -> str:
    """Resolve a path under the asset root; accepts 'assets/<rel>' too."""
    if os.path.isabs(rel):
        return rel
    if rel.startswith("assets/"):
        rel = rel[len("assets/"):]
    return os.path.join(asset_root(), rel)
