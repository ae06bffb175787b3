"""The torch-aware rules.

Counterpart of the reference's ``analysis/rules.py``.  Each rule is a
function over a :class:`~repro_torch.analysis.lint.LintContext`
registered with :func:`~repro_torch.analysis.lint.rule`; it yields
:class:`~repro_torch.analysis.lint.Finding` objects.  Three rules are
ported:

* ``host-sync-in-hot-path`` — the reference's rule in PyTorch's terms,
  with its ``tracer-unsafe-control-flow`` folded in: eager PyTorch has no
  tracer, so an ``if`` on a tensor is a hidden sync, not a trace error;
* ``implicit-float32`` — the stand-in for ``x64-scope``: a tensor factory
  without ``dtype=`` in a float64 module;
* ``unguarded-obs-in-hot-path`` — as the reference's.

``use-after-donation``, ``x64-scope`` and ``recompile-hazard`` have no
counterpart: the port donates no buffers, has no x64 switch, and its only
compiles are ``nvcc`` builds keyed by a hash of their sources.  Rules are
deliberately syntactic and trade exhaustive soundness for a low
false-positive rate on the package's idioms.
"""

from __future__ import annotations

import ast

from .lint import Finding, LintContext, rule
from .model import (HOST_CONVERTERS, FunctionInfo, ModuleModel, dotted_name,
                    is_device_expr, iter_scope, tail_name)

_NP_SYNC = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_FACTORIES = {"torch.tensor", "torch.full", "torch.zeros", "torch.ones",
              "torch.arange"}
# Modules whose math is float64 by contract (a trailing "/": every module
# of that package).
_FLOAT64_MODULES = ("sched/admission.py", "core/envelope.py",
                    "kernels/admission/")


def _hot_functions(ctx: LintContext):
    """``(module, function)`` of every function reachable from the entry
    points, outside the allowed paths and function prefixes."""
    reachable = _reachable_functions(ctx)
    cfg = ctx.config
    for m in ctx.models:
        if any(frag in m.path for frag in cfg.allow_paths):
            continue
        for fi in m.functions.values():
            if fi.name not in reachable:
                continue
            if any(fi.name.startswith(p) for p in cfg.allow_funcs):
                continue
            yield m, fi


def _reachable_functions(ctx: LintContext) -> set[str]:
    """Bare function names reachable from the configured entry points."""
    graph: dict[str, set[str]] = {}
    roots: set[str] = set()
    known = {fi.name for m in ctx.models for fi in m.functions.values()}
    for m in ctx.models:
        for fi in m.functions.values():
            # calls, plus bound-method references to known functions
            # (``program = self._drain_sharded; program(...)``)
            graph.setdefault(fi.name, set()).update(
                fi.calls | (fi.refs & known))
            for klass, fname in ctx.config.entry_points:
                if fi.name == fname and (klass is None
                                         or fi.class_name == klass):
                    roots.add(fi.name)
    seen = set(roots)
    frontier = list(roots)
    for _ in range(ctx.config.max_call_depth):
        nxt = []
        for name in frontier:
            for callee in graph.get(name, ()):
                if callee in graph and callee not in seen:
                    seen.add(callee)
                    nxt.append(callee)
        if not nxt:
            break
        frontier = nxt
    return seen


# ---------------------------------------------------------------------------
# rule 1: host-sync-in-hot-path


@rule("host-sync-in-hot-path")
def host_sync_in_hot_path(ctx: LintContext):
    """``.cpu()``, ``.item()``, ``.tolist()`` / ``.numpy()`` /
    ``np.asarray`` of a device value, ``int()`` / ``float()`` / ``bool()``
    of one, ``torch.cuda.synchronize()``, or a Python ``if`` / ``while`` on
    one, reachable from the event-loop entry points (``ClusterSim.run``,
    ``AdmissionState.drain``, the fleet replay, the micro-batcher).  Each
    one waits for the device: a device->host round trip per event."""
    for m, fi in _hot_functions(ctx):
        yield from _scan_syncs(m, fi)


def _finding(m: ModuleModel, node, message: str) -> Finding:
    return Finding(rule="host-sync-in-hot-path", path=m.path,
                   line=node.lineno, message=message)


def _scan_syncs(m: ModuleModel, fi: FunctionInfo):
    device = fi.device
    for node in iter_scope(fi.node):
        if isinstance(node, (ast.If, ast.While)):
            name = _bare_device_in_test(node.test, device)
            if name:
                kw = "if" if isinstance(node, ast.If) else "while"
                yield _finding(m, node, f"Python `{kw}` branches on "
                               f"`{name}`, a device tensor: a hidden "
                               f"device->host sync")
            continue
        if not isinstance(node, ast.Call):
            continue
        t = tail_name(node.func)
        dn = dotted_name(node.func)
        recv = node.func.value if isinstance(node.func, ast.Attribute) \
            else None
        if t in ("cpu", "item") and recv is not None and not node.args:
            yield _finding(m, node, f"`.{t}()` copies a device value to "
                           f"the host inside the event loop")
        elif (t in ("numpy", "tolist") and recv is not None
              and is_device_expr(recv, device)):
            yield _finding(m, node, f"`.{t}()` of a device value forces a "
                           f"device->host sync in the hot path")
        elif dn == "torch.cuda.synchronize":
            yield _finding(m, node, "`torch.cuda.synchronize()` stalls the "
                           "launch queue in the hot path")
        elif (dn in _NP_SYNC and node.args
              and is_device_expr(node.args[0], device)):
            yield _finding(m, node, f"`{dn}` of a device value blocks on "
                           f"the device in the hot path")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("int", "float", "bool")
              and len(node.args) == 1
              and is_device_expr(node.args[0], device)):
            yield _finding(m, node, f"`{node.func.id}()` of a device value "
                           f"forces a device->host sync in the hot path")


def _bare_device_in_test(test, device) -> str | None:
    """First device name in an ``if`` / ``while`` test not wrapped in a
    host conversion (a conversion is the call's own finding)."""
    stack = [test]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            t = tail_name(node.func)
            if t in HOST_CONVERTERS or t in ("asarray", "array", "cpu",
                                             "numpy", "tolist", "item"):
                continue
        if isinstance(node, (ast.Name, ast.Attribute)):
            dn = dotted_name(node)
            if dn in device:
                return dn
        stack.extend(ast.iter_child_nodes(node))
    return None


# ---------------------------------------------------------------------------
# rule 2: implicit float32 in the float64 modules


@rule("implicit-float32")
def implicit_float32(ctx: LintContext):
    """``torch.tensor`` / ``full`` / ``zeros`` / ``ones`` / ``arange``
    without ``dtype=`` in a module whose math is float64 by contract
    (``sched/admission.py``, ``core/envelope.py``, ``kernels/admission/``).
    PyTorch's default dtype is float32: a float fill or list silently drops
    to float32, and the admission decisions are held to float64 bit for
    bit."""
    for m in ctx.models:
        path = m.path.replace("\\", "/")
        if not any(path.endswith(mod) or (mod.endswith("/") and mod in path)
                   for mod in _FLOAT64_MODULES):
            continue
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Call)
                    and dotted_name(node.func) in _FACTORIES):
                continue
            if any(kw.arg == "dtype" for kw in node.keywords):
                continue
            yield Finding(
                rule="implicit-float32", path=m.path, line=node.lineno,
                message=f"`{dotted_name(node.func)}(...)` without dtype= "
                        f"takes PyTorch's default float32 in a float64 "
                        f"module")


# ---------------------------------------------------------------------------
# rule 3: unguarded obs in hot path


# Module aliases the instrumentation convention imports observability
# under (``from repro_torch.obs import trace as _obs`` / ``metrics as
# _met``) and the recording entry points that allocate when tracing is on.
_OBS_ROOTS = {"obs", "trace", "metrics", "_obs", "_met"}
_OBS_CALLS = {"span", "instant", "count", "counter", "gauge", "hist",
               "series"}


@rule("unguarded-obs-in-hot-path")
def unguarded_obs_in_hot_path(ctx: LintContext):
    """A span/metric call reachable from the hot-path entry points that
    is not behind the module-level ``enabled`` guard.  The observability
    contract is that the disabled path is ONE attribute check — an
    unguarded ``_obs.span(...)`` or ``_met.counter(...)`` allocates and
    locks on every event even with tracing off."""
    guarded_by: dict[str, set[int]] = {}
    for m, fi in _hot_functions(ctx):
        if "repro_torch/obs/" in m.path.replace("\\", "/"):
            continue  # the subsystem itself guards internally
        if m.path not in guarded_by:
            guarded_by[m.path] = _enabled_guarded_lines(m)
        guarded = guarded_by[m.path]
        for node in iter_scope(fi.node):
            if not isinstance(node, ast.Call):
                continue
            dn = dotted_name(node.func)
            if dn is None or "." not in dn:
                continue
            if (dn.split(".")[0] not in _OBS_ROOTS
                    or tail_name(node.func) not in _OBS_CALLS):
                continue
            if node.lineno in guarded:
                continue
            yield Finding(
                rule="unguarded-obs-in-hot-path", path=m.path,
                line=node.lineno,
                message=f"`{dn}(...)` in hot-path function `{fi.name}` is "
                        f"not behind the module-level enabled guard — wrap "
                        f"it in `if _obs.enabled:` so the disabled path "
                        f"stays a single attribute check")


def _enabled_guarded_lines(m: ModuleModel) -> set[int]:
    """Lines inside an ``if ...enabled...:`` guard (the obs convention:
    ``if _obs.enabled:`` around every hot-path span/metric call)."""
    guarded: set[int] = set()
    for node in ast.walk(m.tree):
        if isinstance(node, (ast.If, ast.IfExp)):
            test_names = {dotted_name(n) or "" for n in ast.walk(node.test)
                          if isinstance(n, (ast.Name, ast.Attribute))}
            if any(t.endswith("enabled") for t in test_names):
                guarded.update(range(
                    node.lineno, (node.end_lineno or node.lineno) + 1))
    return guarded
