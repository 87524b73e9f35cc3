"""Python-file config system (mirrors yololp_tpu/utils/config.py).

Config files are plain Python modules defining dicts (model/solver/data_aug),
loaded by importlib and wrapped in a minimal attribute-access dict.
`Config.named` resolves built-in names inside this package's own `configs/`.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Any, Dict


class DotDict(dict):
    """dict with recursive attribute access (addict-lite)."""

    def __init__(self, d: Dict | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any):
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def to_dict(self) -> Dict:
        """Plain nested dicts (DotDicts inside lists and tuples too)."""
        out = {}
        for k, v in self.items():
            if isinstance(v, DotDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(x.to_dict() if isinstance(x, DotDict) else x for x in v)
            out[k] = v
        return out


class Config(DotDict):
    """A loaded model config; carries its source filename for bookkeeping."""

    @staticmethod
    def fromfile(filename: str) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        if not filename.endswith(".py"):
            raise ValueError("config file must be a .py file")
        modname = "_yololp_torch_cfg_" + os.path.splitext(os.path.basename(filename))[0]
        spec = importlib.util.spec_from_file_location(modname, filename)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        try:
            spec.loader.exec_module(mod)
            cfg = {k: v for k, v in mod.__dict__.items() if not k.startswith("__")}
        finally:
            sys.modules.pop(modname, None)
        out = Config(cfg)
        out["_filename"] = filename
        return out

    @staticmethod
    def named(name: str) -> "Config":
        """Load a built-in config by short name, e.g. 'yololps'."""
        here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "configs")
        return Config.fromfile(os.path.join(here, name + ".py"))
