"""Extension SPI — water/ExtensionManager.java + AbstractH2OExtension +
water/api/RestApiExtension rebuilt for the single-controller runtime.

The reference discovers extensions via ServiceLoader on the classpath and
gives them lifecycle hooks (onLocalNodeStarted) plus registration points
(new algos, new REST routes). Here registration is explicit Python —
`register_extension` — plus optional discovery through the
`ai.h2o.extensions` config property (comma-separated module paths imported
at init; each module calls register_extension at import time).

An extension may contribute:
  * estimators: {algo_name: EstimatorClass} merged into models.ESTIMATORS
    (and therefore the REST ModelBuilders surface + bindings codegen)
  * routes: [(regex_str, method, handler)] appended to api.server.ROUTES
  * rapids:  {prim_name: fn} merged into rapids.PRIMS
  * init(cloud) lifecycle hook (onLocalNodeStarted analog)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class H2OExtension:
    name: str
    estimators: dict = field(default_factory=dict)
    routes: list = field(default_factory=list)
    rapids: dict = field(default_factory=dict)
    init: object = None          # callable(cloud) | None


_EXTENSIONS: dict[str, H2OExtension] = {}


def register_extension(ext: H2OExtension) -> H2OExtension:
    """Idempotent by name (re-registering replaces — module reloads)."""
    _EXTENSIONS[ext.name] = ext
    # estimators → model registry (+ REST builders + codegen, live)
    if ext.estimators:
        from h2o3_tpu_torch import models as _m
        _m.ESTIMATORS.update(ext.estimators)
    if ext.routes:
        from h2o3_tpu_torch.api import server as _srv
        existing = {(p.pattern, m) for p, m, _ in _srv.ROUTES}
        for pat, method, fn in ext.routes:
            if (pat, method) not in existing:
                _srv.ROUTES.append((re.compile(pat), method, fn))
    if ext.rapids:
        from h2o3_tpu_torch.rapids.rapids import PRIMS
        PRIMS.update(ext.rapids)
    return ext


def extensions() -> list[H2OExtension]:
    return list(_EXTENSIONS.values())


_INIT_FIRED: set = set()


def load_configured_extensions(cloud=None):
    """Import modules named in `ai.h2o.extensions` (ServiceLoader analog)
    and fire init hooks ONCE per extension (onLocalNodeStarted fires once
    in the reference; mesh re-init must not duplicate extension
    resources). Called from h2o3_tpu_torch.init()."""
    import importlib
    from h2o3_tpu_torch.utils import config as _cfg
    spec = _cfg.get_property("extensions", "") or ""
    for mod in [m.strip() for m in str(spec).split(",") if m.strip()]:
        importlib.import_module(mod)
    for ext in _EXTENSIONS.values():
        if callable(ext.init) and ext.name not in _INIT_FIRED:
            _INIT_FIRED.add(ext.name)
            ext.init(cloud)
