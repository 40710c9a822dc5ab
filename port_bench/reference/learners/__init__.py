"""The reference's learning, one module per ``agent.disc_mode``: the
check loads ``learners/<disc_mode>.py``, so a configuration of another
mode brings its own module and edits none here."""

from __future__ import annotations

import importlib


def load(cfg: dict):
    mode = cfg.get("agent", {}).get("disc_mode", "add")
    return importlib.import_module(f"port_bench.reference.learners.{mode}")
