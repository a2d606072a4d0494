"""The runtime property store of the port (h2o3_tpu/utils/config.py; the
reference's flags, water/H2O.java:327 OptArgs, each also settable as a
Java system property with the ``ai.h2o.`` prefix).

Three layers, the later winning:
  1. defaults a subsystem registers (`register_default`);
  2. environment variables, ``H2O3_TPU_<UPPER_SNAKE>``;
  3. `set_property` at run time (the Rapids ``setproperty`` prim).
"""

from __future__ import annotations

import os
import threading

_LOCK = threading.Lock()
_PROPS: dict = {}
_DEFAULTS: dict = {}

PREFIX = "ai.h2o."          # the reference's prefix, accepted as it is
ENV_PREFIX = "H2O3_TPU_"


def _norm(name: str) -> str:
    if name.startswith(PREFIX):
        name = name[len(PREFIX):]
    return name.replace("-", ".").lower()


def register_default(name: str, value) -> None:
    with _LOCK:
        _DEFAULTS[_norm(name)] = value


def set_property(name: str, value) -> None:
    with _LOCK:
        _PROPS[_norm(name)] = value


def get_property(name: str, default=None):
    key = _norm(name)
    with _LOCK:
        if key in _PROPS:
            return _PROPS[key]
    # h2o3-ok: R017 layered property store — names are dynamic ai.h2o.* properties mapped to H2O3_TPU_*; the census covers the typed-accessor surface, properties are censused via register_default
    env = os.environ.get(ENV_PREFIX + key.replace(".", "_").upper())
    if env is not None:
        return env
    with _LOCK:
        return _DEFAULTS.get(key, default)


def get_bool(name: str, default: bool = False) -> bool:
    v = get_property(name, default)
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def all_properties() -> dict:
    with _LOCK:
        out = dict(_DEFAULTS)
        out.update(_PROPS)
    return out
