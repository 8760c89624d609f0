"""Network-config loading (port of ``instant_ngp_tpu/config.py``).

JSON configs only: the JAX package also reads a snapshot's config from a
``.ingp`` file here, which no caller of the port does. Mirrors the
reference's config behavior (testbed.cu:254-310):
  * `.json` files may contain ``//`` line comments (the reference uses
    nlohmann::json with comments enabled).
  * A config may name a ``"parent"`` config whose keys it overrides
    (testbed.h:427-430: the parent is loaded first, child keys replace
    recursively).
  * `find_network_config` searches alongside the requested path and in
    the repository's configs/<mode> directories.
"""

from __future__ import annotations

import copy
import json
import os
import re
from pathlib import Path
from typing import Any

CONFIGS_DIR = Path(__file__).resolve().parent.parent / "configs"

_COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|//[^\n]*')


def _strip_comments(text: str) -> str:
    """Remove // comments outside of string literals."""
    return _COMMENT_RE.sub(lambda m: m.group(1) or "", text)


def loads_json_with_comments(text: str) -> Any:
    return json.loads(_strip_comments(text))


def load_json_file(path: str | os.PathLike) -> Any:
    return loads_json_with_comments(Path(path).read_text(encoding="utf-8"))


def find_network_config(path: str | os.PathLike, mode: str | None = None) -> Path:
    """Search-path logic of the reference (testbed.cu:254-270)."""
    path = Path(path)
    if path.exists():
        return path
    candidates = []
    if mode is not None:
        candidates.append(CONFIGS_DIR / mode / path.name)
        candidates.append(CONFIGS_DIR / mode / (path.name + ".json"))
    candidates.append(CONFIGS_DIR / path)
    for cand in candidates:
        if cand.exists():
            return cand
    raise FileNotFoundError(f"network config not found: {path}")


def load_network_config(path: str | os.PathLike, mode: str | None = None) -> dict:
    """Load a config, resolving ``"parent"`` inheritance recursively."""
    path = find_network_config(path, mode)
    config = load_json_file(path)
    if isinstance(config, dict) and "parent" in config:
        parent_path = find_network_config(Path(path).parent / config["parent"], mode)
        parent = load_network_config(parent_path, mode)
        child = {k: v for k, v in config.items() if k != "parent"}
        config = merge_parent(parent, child)
    return config


def merge_parent(parent: dict, child: dict) -> dict:
    """Child keys override parent keys (recursive dict merge)."""
    out = copy.deepcopy(parent)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_parent(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def default_config(mode: str) -> dict:
    """The built-in network config of a mode: configs/<mode>/base.json
    (the reference compiles a default in, testbed.cu:4494-4521)."""
    return load_network_config(CONFIGS_DIR / mode / "base.json")
