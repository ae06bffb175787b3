"""AST facts shared by the lint rules.

Counterpart of the reference's ``analysis/model.py``, without its jit and
donation tables (the port has no ``jax.jit`` to resolve).  The rules in
:mod:`repro_torch.analysis.rules` never walk raw trees; they query a
:class:`ModuleModel` built here once per file:

* per-function call edges and bound-method references (bare names), for
  hot-path reachability;
* the names a function binds to device values (:func:`device_names`):
  assigned from a ``torch.*`` call, from a kernel wrapper's ``ops.*``
  call, or from a tensor method, operator or subscript of such a name;
* imports;
* inline ``# lint: allow[rule] reason`` suppressions.

Everything is a plain syntactic fact; no code of the analysed modules is
imported or run.
"""

from __future__ import annotations

import ast
import dataclasses
import re

_ALLOW_RE = re.compile(
    r"#\s*lint:\s*allow\[([a-z0-9-]+)\]\s*(.*?)\s*$")

# Calls whose result is a host value: the explicit conversions (the
# host-sync rule decides whether the conversion itself is a sync).
HOST_CONVERTERS = {"int", "float", "bool", "len"}
HOST_METHODS = {"cpu", "numpy", "tolist", "item"}
# ``torch.*`` callables that return host objects, not tensors.
_TORCH_HOST = ("torch.cuda.", "torch.distributed.", "torch.backends.",
               "torch.device", "torch.Generator", "torch.is_", "torch.get_",
               "torch.set_", "torch.no_grad", "torch.inference_mode",
               "torch.enable_grad", "torch.Size", "torch.finfo",
               "torch.iinfo", "torch.manual_seed", "torch.utils.",
               "torch.profiler.")
# Attributes of a tensor that are host values.
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "placements", "device_mesh"}


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def tail_name(node: ast.AST) -> str | None:
    """Last component of a Name/Attribute chain (``c`` for ``a.b.c``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def iter_scope(node: ast.AST):
    """Walk ``node`` without descending into nested function/class scopes.

    The root's own body is entered even when the root is itself a
    function; children that open a new scope (def/lambda/class) are
    yielded but not entered.
    """
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def _pos(node) -> tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


@dataclasses.dataclass
class FunctionInfo:
    """One def (module, method, or nested) plus its local facts."""

    name: str
    qualname: str
    class_name: str | None
    node: ast.FunctionDef
    path: str
    calls: set[str] = dataclasses.field(default_factory=set)
    # Name/Attribute loads that are not calls — bound-method dispatch
    # (``fn = self._run_fused; fn(...)``) shows up here, not in calls.
    refs: set[str] = dataclasses.field(default_factory=set)
    _device: set[str] | None = None

    @property
    def is_method(self) -> bool:
        return self.class_name is not None

    @property
    def device(self) -> set[str]:
        """The names this function binds to device values."""
        if self._device is None:
            self._device = device_names(self.node)
        return self._device


@dataclasses.dataclass
class ModuleModel:
    """All syntactic facts the rules need for one source file."""

    path: str
    tree: ast.Module
    source_lines: list[str]
    functions: dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict)
    imports: set[str] = dataclasses.field(default_factory=set)
    suppressions: dict[int, tuple[str, str]] = dataclasses.field(
        default_factory=dict)

    def function_of(self, qualtail: str) -> FunctionInfo | None:
        """Look up by bare name or qualname suffix (first match)."""
        if qualtail in self.functions:
            return self.functions[qualtail]
        for fi in self.functions.values():
            if fi.name == qualtail:
                return fi
        return None


def build_model(path: str, source: str) -> ModuleModel:
    tree = ast.parse(source, filename=path)
    model = ModuleModel(path=path, tree=tree,
                        source_lines=source.splitlines())
    _collect_imports(model)
    _collect_functions(model)
    _collect_suppressions(model)
    return model


def _collect_imports(model: ModuleModel) -> None:
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                model.imports.add(alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            model.imports.add(node.module.split(".")[0])


def _collect_functions(model: ModuleModel) -> None:
    def visit(node, qualstack: list[str], class_name: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, qualstack + [child.name], child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qualname = ".".join(qualstack + [child.name])
                info = FunctionInfo(
                    name=child.name, qualname=qualname,
                    class_name=class_name, node=child, path=model.path)
                for sub in iter_scope(child):
                    if isinstance(sub, ast.Call):
                        callee = tail_name(sub.func)
                        if callee:
                            info.calls.add(callee)
                    elif (isinstance(sub, (ast.Name, ast.Attribute))
                          and isinstance(getattr(sub, "ctx", None),
                                         ast.Load)):
                        ref = tail_name(sub)
                        if ref:
                            info.refs.add(ref)
                model.functions[qualname] = info
                visit(child, qualstack + [child.name], None)
            else:
                visit(child, qualstack, class_name)

    visit(model.tree, [], None)


def is_device_call(call: ast.Call, device: set[str]) -> bool:
    """A call whose result is a device value: a ``torch.*`` function
    (bar the host ones), a kernel wrapper's ``ops.*``, or a tensor method
    of a device value other than the host conversions."""
    dn = dotted_name(call.func) or ""
    if dn.startswith("torch."):
        return not dn.startswith(_TORCH_HOST)
    if dn.startswith("ops."):
        return True
    if isinstance(call.func, ast.Attribute):
        return (call.func.attr not in HOST_METHODS
                and is_device_expr(call.func.value, device))
    return False


def is_device_expr(expr: ast.AST, device: set[str]) -> bool:
    """Whether ``expr`` evaluates to a device value, given the names
    ``device`` already known to hold one."""
    if isinstance(expr, (ast.Name, ast.Attribute)):
        dn = dotted_name(expr)
        if dn is not None and dn in device:
            return True
        if isinstance(expr, ast.Attribute):
            return (expr.attr not in _HOST_ATTRS
                    and is_device_expr(expr.value, device))
        return False
    if isinstance(expr, ast.Subscript):
        return is_device_expr(expr.value, device)
    if isinstance(expr, ast.Call):
        return is_device_call(expr, device)
    if isinstance(expr, ast.BinOp):
        return (is_device_expr(expr.left, device)
                or is_device_expr(expr.right, device))
    if isinstance(expr, ast.UnaryOp):
        return is_device_expr(expr.operand, device)
    if isinstance(expr, ast.Compare):
        return any(is_device_expr(e, device)
                   for e in [expr.left] + expr.comparators)
    if isinstance(expr, ast.BoolOp):
        return any(is_device_expr(e, device) for e in expr.values)
    if isinstance(expr, ast.IfExp):
        return (is_device_expr(expr.body, device)
                or is_device_expr(expr.orelse, device))
    return False


def _targets(target: ast.AST):
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _targets(elt)
    elif isinstance(target, ast.Starred):
        yield from _targets(target.value)
    elif isinstance(target, (ast.Name, ast.Attribute)):
        dn = dotted_name(target)
        if dn:
            yield dn
    # a store into a subscript leaves its container's kind as it was: a
    # dict or list of tensors is a host object (``if key in d:``)


def device_names(fnode: ast.AST) -> set[str]:
    """Names (``x``, ``self._buf``) bound to a device value anywhere in the
    scope of ``fnode``: assignments in source order, twice over, so that a
    value carried round a loop counts from its first device binding."""
    assigns = sorted((n for n in iter_scope(fnode)
                      if isinstance(n, (ast.Assign, ast.AugAssign,
                                        ast.AnnAssign))
                      and n.value is not None), key=_pos)
    device: set[str] = set()
    for _ in range(2):
        for node in assigns:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if is_device_expr(node.value, device):
                device.update(n for t in targets for n in _targets(t))
    return device


def _collect_suppressions(model: ModuleModel) -> None:
    """``# lint: allow[rule] reason`` — same line, or a standalone
    comment line applying to the next line."""
    for i, line in enumerate(model.source_lines, start=1):
        m = _ALLOW_RE.search(line)
        if not m:
            continue
        rule, reason = m.group(1), m.group(2)
        target = i
        if line.lstrip().startswith("#"):
            target = i + 1
        model.suppressions[target] = (rule, reason)
