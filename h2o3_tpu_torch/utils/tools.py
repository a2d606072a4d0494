"""The maintenance-tool registry of the port (h2o3_tpu/utils/tools.py):
AstRunTool (water/rapids/ast/prims/internal/AstRunTool.java) dispatches to
`water.tools.*` classes by name."""

from __future__ import annotations

_TOOLS: dict = {}


def register_tool(name: str):
    def deco(fn):
        _TOOLS[name] = fn
        return fn
    return deco


def run_tool(name: str, args: list):
    fn = _TOOLS.get(name)
    if fn is None:
        raise ValueError(
            f"unknown tool {name!r}; registered: {sorted(_TOOLS)}")
    return fn(*args)


@register_tool("GarbageCollect")
def _gc_tool():
    import gc
    gc.collect()
    return 0.0


@register_tool("MemoryInfo")
def _meminfo_tool():
    from h2o3_tpu_torch.core.memory import MANAGER
    return float(MANAGER.stats().get("resident_bytes", 0))
