"""The torch rules of the port (h2o3_tpu/analysis/rules_jax.py): R001 a
program built per call, R002 a host sync in the capture scope or a span,
R004 impurity under capture.

The JAX rules guard jax.jit's cache, which is keyed on the function
object. The port has no jit: a scorer runs eagerly on the CPU and as a
CUDA graph on the card (serving/scorer_cache.py), and its kernels are
shared libraries built once (ops/_build.py). The same three hazards
have torch shapes:

  * R001 — a program built per call. `torch.cuda.CUDAGraph()` /
    `torch.cuda.graph(...)` outside serving/scorer_cache.py, whose
    `_Program` is the one sanctioned graph cache (as `cached_jit` is for
    JAX); `torch.compile(...)` inside a function body (a fresh compiled
    function per call); `ctypes.CDLL(...)` outside ops/_build.py, whose
    loader keeps one handle per library.
  * R002 — a host sync in the CAPTURE SCOPE or inside a `timeline.span`
    block. The capture scope is the body of the scorer family
    (`_score_with_params` / `_score_matrix` and the defs nested in
    them) and the body of a graph capture (`with torch.cuda.graph(..)`,
    or the lines between `capture_begin()` and `capture_end()`). A sync
    there fails the capture (the program strikes and scores eagerly):
    `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `torch.cuda.
    synchronize()`, an event's or stream's `.synchronize()`, `float`/
    `int`/`bool` of a torch expression, `np.asarray`/`np.array` of a
    torch expression, and a host-to-device copy (`torch.tensor(...,
    device=)`, or `torch.as_tensor(..., device=)` of anything but a
    serving param: a `self.<attr>` that the class's
    `_serving_param_attrs` names arrives placed on the device, and
    as_tensor of it copies nothing). Inside a span block the explicit
    barriers are flagged (`synchronize`, `host_fetch`, a scalar of a
    torch expression): the span would measure the barrier.
  * R004 — impure under capture. `time.*`, `random.*`/`np.random.*`,
    `global` rebinding and `torch.rand*` without `generator=` in the
    capture scope run ONCE, when the graph is captured, and every
    replay repeats that one value.
"""

from __future__ import annotations

import ast

from h2o3_tpu_torch.analysis.engine import Finding, Module

RULES = {"R001", "R002", "R004"}

# the one module that may build CUDA graphs, and the one that loads
# shared libraries
_GRAPH_HOME = "h2o3_tpu_torch/serving/scorer_cache.py"
_CDLL_HOME = "h2o3_tpu_torch/ops/_build.py"
_GRAPH_CTORS = {"CUDAGraph", "graph", "make_graphed_callables"}

# the scorer family: a def of one of these names is the capture scope
_CAPTURE_ROOTS = {"_score_with_params", "_score_matrix"}

_NP_NAMES = {"np", "numpy", "_np", "onp"}
_MUT_NP = {"asarray", "array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_TIME_NAMES = {"time", "_time", "_time_mod"}
_TIME_FNS = {"time", "perf_counter", "monotonic", "process_time", "sleep",
             "time_ns", "monotonic_ns", "perf_counter_ns"}


def _terminal_name(fn: ast.AST):
    """'torch.compile' -> 'compile'; 'compile' -> 'compile'."""
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an Attribute/Name chain ('' when not a plain chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _enclosing_function(node: ast.AST, parents: dict):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = parents.get(cur)
    return None


def _contains_torch(node: ast.AST) -> bool:
    """True when the expression mentions a `torch.*` name (a tensor op)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                _attr_chain(sub).startswith("torch."):
            return True
    return False


def _is_graph_ctor(chain: str) -> bool:
    parts = chain.split(".")
    return len(parts) >= 2 and parts[-2] == "cuda" \
        and parts[-1] in _GRAPH_CTORS


def _capture_functions(nodes: list, parents: dict) -> set:
    """The scorer family's defs and every def/lambda nested in them."""
    fnlike = [n for n in nodes
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda))]
    scope = {n for n in fnlike
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n.name in _CAPTURE_ROOTS}
    changed = True
    while changed:
        changed = False
        for n in fnlike:
            if n not in scope and _enclosing_function(n, parents) in scope:
                scope.add(n)
                changed = True
    return scope


def _capture_blocks(nodes: list) -> list:
    """(first line, last line) of every graph-capture body: a `with
    torch.cuda.graph(...)` block, or the lines between a
    `capture_begin()` and the next `capture_end()` of one function."""
    out = []
    for node in nodes:
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and _is_graph_ctor(_attr_chain(it.context_expr.func))
                for it in node.items):
            out.append((node.body[0].lineno, node.end_lineno))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            begins, ends = [], []
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    term = _terminal_name(sub.func)
                    if term == "capture_begin":
                        begins.append(sub.lineno)
                    elif term == "capture_end":
                        ends.append(sub.lineno)
            for b in begins:
                later = [e for e in ends if e > b]
                if later:
                    out.append((b + 1, min(later) - 1))
    return out


def _span_blocks(nodes: list) -> list:
    """With-statements whose context manager is a timeline span() call."""
    out = []
    for node in nodes:
        if isinstance(node, ast.With):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) \
                        and _terminal_name(ctx.func) in ("span", "_span"):
                    out.append(node)
                    break
    return out


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


def _serving_attrs(nodes: list) -> dict:
    """{class node: the attribute names of its `_serving_param_attrs`}."""
    out = {}
    for cls in nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(tg, ast.Name)
                    and tg.id == "_serving_param_attrs"
                    for tg in stmt.targets):
                out[cls] = {c.value for c in ast.walk(stmt.value)
                            if isinstance(c, ast.Constant)
                            and isinstance(c.value, str)}
    return out


def _placed_param(arg, node, parents: dict, attrs: dict) -> bool:
    """True when `arg` is `self.<attr>` of a serving param of the class
    whose method holds `node`."""
    if not (isinstance(arg, ast.Attribute) and isinstance(arg.value,
                                                          ast.Name)
            and arg.value.id == "self"):
        return False
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, ast.ClassDef):
        cur = parents.get(cur)
    return cur is not None and arg.attr in attrs.get(cur, ())


def _capture_sync(node: ast.Call, placed):
    """What a call in the capture scope synchronises on, or None.
    `placed(arg)` says whether an as_tensor argument is a placed param."""
    fn = node.func
    term = _terminal_name(fn)
    chain = _attr_chain(fn)
    if isinstance(fn, ast.Attribute):
        base = _attr_chain(fn.value)
        if fn.attr in _MUT_NP and base in _NP_NAMES:
            if node.args and _contains_torch(node.args[0]):
                return f"{base}.{fn.attr}(<torch expression>)"
            return None
        if fn.attr in _SYNC_METHODS and not node.args:
            return f".{fn.attr}()"
        if fn.attr == "synchronize":
            return f"{chain or '.synchronize'}()"
        if chain in ("torch.tensor", "torch.as_tensor") \
                and _has_kw(node, "device") and not (
                    chain == "torch.as_tensor" and node.args
                    and placed(node.args[0])):
            return f"{chain}(..., device=) (a host-to-device copy)"
    elif isinstance(fn, ast.Name):
        if term == "host_fetch":
            return "host_fetch()"
        if term in ("float", "int", "bool") and node.args \
                and _contains_torch(node.args[0]):
            return f"{term}(<torch expression>)"
    return None


def _impure(node: ast.Call):
    """What a call in the capture scope fixes at capture time, or None."""
    chain = _attr_chain(node.func)
    term = _terminal_name(node.func)
    root = chain.split(".", 1)[0] if chain else ""
    if root in _TIME_NAMES and term in _TIME_FNS:
        return (f"{chain}()", "a wall-clock read is taken once, at "
                "capture, and every replay repeats it — pass timestamps "
                "in as arguments")
    if chain.startswith(("random.", "np.random.", "numpy.random.")):
        return (f"{chain}()", "a host RNG draw is made once, at capture, "
                "and every replay repeats it — draw on the device with "
                "a torch.Generator")
    if chain.startswith("torch.") and term and term.startswith("rand") \
            and not _has_kw(node, "generator"):
        return (f"{chain}() without generator=", "the draw advances the "
                "global generator only at capture; every replay repeats "
                "the captured offsets — pass an explicit torch.Generator")
    return None


def check(mod: Module) -> list:
    findings: list = []
    nodes = mod.walk()
    parents = mod.parents()
    rel = mod.rel.replace("\\", "/")
    scope = _capture_functions(nodes, parents)
    blocks = _capture_blocks(nodes)
    attrs = _serving_attrs(nodes)

    inside = {id(n) for fn in scope for n in ast.walk(fn) if n is not fn}

    def in_capture(node) -> bool:
        if id(node) in inside:
            return True
        ln = getattr(node, "lineno", 0)
        return any(lo <= ln <= hi for lo, hi in blocks)

    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        term = _terminal_name(node.func)

        # ---- R001: a program built per call ---------------------------
        if _is_graph_ctor(chain) and rel != _GRAPH_HOME:
            findings.append(Finding(
                "R001", mod.rel, node.lineno,
                f"{chain}(...) outside serving/scorer_cache.py: a CUDA "
                "graph made here is captured again on every call and "
                "its memory pool is never shared or trimmed — score "
                "through the scorer cache's programs"))
        elif chain == "torch.compile" \
                and _enclosing_function(node, parents) is not None:
            findings.append(Finding(
                "R001", mod.rel, node.lineno,
                "torch.compile(...) inside a function body: a fresh "
                "compiled function per call, so every call compiles "
                "again — compile once at module or instance level"))
        elif term == "CDLL" and chain.split(".")[0] in ("ctypes", "CDLL") \
                and rel != _CDLL_HOME:
            findings.append(Finding(
                "R001", mod.rel, node.lineno,
                "ctypes.CDLL(...) outside ops/_build.py: the library is "
                "loaded again per call and bypasses the build cache's "
                "one handle per library — load through ops/_build"))

        # ---- R002 / R004: the capture scope ---------------------------
        if in_capture(node):
            what = _capture_sync(
                node, lambda arg: _placed_param(arg, node, parents, attrs))
            if what is not None:
                findings.append(Finding(
                    "R002", mod.rel, node.lineno,
                    f"{what} in the capture scope: a device→host sync "
                    "(or a host copy) while a CUDA graph is captured "
                    "fails the capture, so the program strikes and "
                    "scores eagerly — keep the value on the device, or "
                    "move the readback out of the scorer"))
            imp = _impure(node)
            if imp is not None:
                findings.append(Finding(
                    "R004", mod.rel, node.lineno,
                    f"{imp[0]} in the capture scope: {imp[1]}"))

    # R004: global rebinding in the capture scope
    for node in nodes:
        if isinstance(node, ast.Global) and in_capture(node):
            findings.append(Finding(
                "R004", mod.rel, node.lineno,
                f"global {', '.join(node.names)} in the capture scope: "
                "the rebinding runs at capture only, never on a replay — "
                "thread state through arguments and outputs"))

    # R002: explicit barriers inside span-instrumented hot paths
    flagged = {f.line for f in findings if f.rule == "R002"}
    for block in _span_blocks(nodes):
        for node in ast.walk(block):
            if not isinstance(node, ast.Call) or node.lineno in flagged:
                continue
            term = _terminal_name(node.func)
            chain = _attr_chain(node.func)
            if term == "synchronize":
                findings.append(Finding(
                    "R002", mod.rel, node.lineno,
                    f"{chain or '.synchronize'}() inside a timeline.span "
                    "block: a device barrier on an instrumented hot path "
                    "— make it intentional (suppress with a reason) or "
                    "remove"))
            elif term == "host_fetch":
                findings.append(Finding(
                    "R002", mod.rel, node.lineno,
                    "host_fetch inside a timeline.span block: a device→"
                    "host sync on an instrumented hot path, so the span "
                    "measures the transfer, not the work — fetch outside "
                    "the span, or suppress with the reason the sync IS "
                    "the work"))
            elif isinstance(node.func, ast.Name) \
                    and term in ("float", "int", "bool") and node.args \
                    and _contains_torch(node.args[0]):
                findings.append(Finding(
                    "R002", mod.rel, node.lineno,
                    f"{term}(<torch expression>) inside a timeline.span "
                    "block: hidden device→host sync on an instrumented "
                    "hot path — fetch once outside the span or batch "
                    "the readback"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUT_NP \
                    and _attr_chain(node.func.value) in _NP_NAMES \
                    and node.args and _contains_torch(node.args[0]):
                findings.append(Finding(
                    "R002", mod.rel, node.lineno,
                    f"{chain}(<torch expression>) inside a timeline.span "
                    "block: hidden device→host sync on an instrumented "
                    "hot path — fetch once outside the span"))
    return findings


check.RULES = RULES


# ---------------------------------------------------------------------------
# the static capture verdict of each scorer family, held against the card
# (chip_smoke.py's capture cross-check, tests/test_torch_gpu.py)
FAMILY_MODULES = {
    "gbm": ("h2o3_tpu_torch/models/tree/",),
    "glm": ("h2o3_tpu_torch/models/glm.py",),
    "deeplearning": ("h2o3_tpu_torch/models/deeplearning.py",),
    "kmeans": ("h2o3_tpu_torch/models/kmeans.py",),
    "glrm": ("h2o3_tpu_torch/models/glrm.py",),
}
# every family's program runs through these: the scorer base class and
# DataInfo's design assembly, and the scorer cache's capture
SHARED_CAPTURE_MODULES = ("h2o3_tpu_torch/models/model.py",
                          "h2o3_tpu_torch/serving/scorer_cache.py")


def is_capture_finding(rule: str, message: str) -> bool:
    """A finding that says a program fails its capture: R025, or R002 in
    the capture scope (not R002's span barriers)."""
    return rule == "R025" or (rule == "R002"
                              and "in the capture scope" in message)


def capture_verdicts(findings) -> dict:
    """{family: its capture findings, waived or not} over `findings`
    (Finding objects or their to_dict() forms). A family with none must
    capture without a strike; one with any must strike, at a line that
    carries the finding."""
    out = {fam: [] for fam in FAMILY_MODULES}
    for f in findings:
        d = f if isinstance(f, dict) else f.to_dict()
        if not is_capture_finding(d["rule"], d["message"]):
            continue
        path = d["file"].replace("\\", "/")
        for fam, mods in FAMILY_MODULES.items():
            if path.startswith(mods + SHARED_CAPTURE_MODULES):
                out[fam].append(d)
    return out
