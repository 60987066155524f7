"""Find a configuration, a traffic mix, a kind or a metric by its name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(folder: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = BENCH / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return path


def data(folder: str, name: str) -> dict:
    return json.loads(_path(folder, name, ".json").read_text())


_modules: dict = {}


def module(folder: str, name: str):
    """``portbench/<folder>/<name>.py`` as a module, loaded once."""
    key = (folder, name)
    if key not in _modules:
        path = _path(folder, name, ".py")
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{re.sub(r'[.-]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def roofline(name: str):
    return importlib.import_module(f"portbench.roofline.{name}")
