"""AST lint holding the port to its standing contracts (rules MG101-MG107,
the counterparts of the JAX package's rules of the same numbers).

    python -m repro_torch.analysis.lint src/repro_torch

Exits 0 when clean, 1 on a finding.  Standard library only.

    MG101  a host read or host wait inside a ``@hot_path`` function:
           ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
           ``.synchronize()``, ``torch.cuda.synchronize``, and
           ``np.asarray``/``np.array`` or ``int()``/``float()``/``bool()`` of
           a value not known to be a host one.  Each stalls the host on the
           device once per tick; the planned ones carry an allowance.
    MG102  ``torch.cuda.CUDAGraph()`` or a kernel-library load
           (``build.library``) inside a ``for``/``while`` loop: a capture or
           a library load per iteration.
    MG103  mutation of a frozen config dataclass instance (an attribute of
           ``cfg``/``plan``/``serve``/... assigned, or ``object.__setattr__``
           outside ``__init__``/``__post_init__``/``__new__``).
    MG104  inside ``@hot_path``, a cache tensor (``cache``, ``pool_k``,
           ``pool_v``, ``host_k``, ``host_v``, a carry) rebound to an
           out-of-place result (``torch.cat``/``stack``/``where``,
           ``.clone()``, ``+`` and the like): the captured graphs hold the
           old tensor, so the contract asks for an in-place write.
    MG105  a host-to-device copy outside ``serving/weights.py`` and
           ``serving/cache.py``, the modules that account for copies:
           ``.cuda()``; ``.to(<device>)``, unless it moves a value not known
           to be a host one to another tensor's device (``.to(x.device)``,
           a no-op for a tensor already there); ``torch.as_tensor(...,
           device=)`` of a value known to be a host one.

A value is known to be a host one when the function makes it so: a
constant or a display of them, a numpy call or ``torch.from_numpy``, the
result of ``.numpy()``/``.tolist()``/``.item()``, ``len``/``range``, a
shape, a parameter annotated as numpy or a Python number, or a name every
binding of which is one of these (loop and comprehension targets over
host values included).
    MG106  an allowance without a reason, or one that suppresses nothing.
    MG107  a ``torch.distributed`` collective in ``distributed/`` outside a
           function decorated ``@register_collective``.

An allowance sits on the first line of the flagged statement:

    mat = toks.cpu()  # lint: allow[MG101] the one planned token read a chunk

Several rules: ``allow[MG101,MG105]``.  The text after the bracket is the
reason and must not be empty.
"""
from __future__ import annotations

import argparse
import ast
import io
import re
import sys
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "MG101": "host read or host wait inside a @hot_path function",
    "MG102": "graph capture or kernel-library load inside a loop",
    "MG103": "mutation of a frozen config dataclass instance",
    "MG104": "cache tensor rebound to an out-of-place result in a @hot_path function",
    "MG105": "host-to-device copy outside the accounted copy modules",
    "MG106": "lint allowance without a reason, or a stale one",
    "MG107": "torch.distributed collective outside a @register_collective function",
}

HOT_PATH_NAMES = {"hot_path"}
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
HOST_READ_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                   "torch.cuda.synchronize"}
CAST_NAMES = {"int", "float", "bool"}
HOST_CALLS = {"len", "range", "torch.from_numpy"}
HOST_IF_ARGS = {"int", "float", "bool", "str", "min", "max", "sum", "abs", "round",
                "list", "tuple", "set", "sorted", "enumerate", "zip"}
HOST_RESULT_METHODS = {"numpy", "tolist", "item"}
HOST_ATTRS = {"shape", "ndim"}
HOST_ANNOTATIONS = {"int", "float", "bool", "str", "ndarray"}
LOOP_BUILDS = {"torch.cuda.CUDAGraph", "build.library"}
CACHE_NAMES = {"cache", "pool_k", "pool_v", "host_k", "host_v", "carry", "_carries"}
OUT_OF_PLACE = {"torch.cat", "torch.concat", "torch.stack", "torch.where",
                "torch.zeros_like", "torch.empty_like", "torch.clone"}
OUT_OF_PLACE_METHODS = {"clone", "contiguous", "to", "float", "detach"}
COPY_OK = ("serving/weights.py", "serving/cache.py")
COLLECTIVE_NAMES = {"all_to_all", "all_to_all_single", "all_reduce", "all_gather",
                    "all_gather_into_tensor", "reduce_scatter",
                    "reduce_scatter_tensor", "broadcast", "reduce", "send", "recv",
                    "isend", "irecv", "barrier"}
REGISTER_NAMES = {"register_collective"}
CONFIG_NAMES = {"cfg", "config", "plan", "serve", "serve_cfg", "stream",
                "stream_cfg", "cache_config", "cc", "sampling_params", "sp", "hw"}
SETATTR_OK_SCOPES = {"__init__", "__post_init__", "__new__"}

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\[([A-Za-z0-9_,\s]+)\]\s*(.*?)\s*$")


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _parse_allowances(text: str) -> Dict[int, Tuple[Set[str], str]]:
    """line -> (rules allowed, reason), from comments only (an example in a
    docstring is not an allowance)."""
    allow: Dict[int, Tuple[Set[str], str]] = {}
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        m = _ALLOW_RE.search(tok.string) if tok.type == tokenize.COMMENT else None
        if m:
            rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
            allow[tok.start[0]] = (rules, m.group(2).strip())
    return allow


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for the attribute chain; '' when not a
    plain chain of names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _names_in_target(node: ast.AST) -> Set[str]:
    """Every identifier along an assignment target's chain of attributes
    and subscripts (``self.pages.pool_k[li]`` -> {self, pages, pool_k})."""
    out: Set[str] = set()
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.add(node.id)
    return out


def _decorator_names(fn: ast.AST) -> List[str]:
    return [_dotted(d.func if isinstance(d, ast.Call) else d) for d in fn.decorator_list]


def _is_device(node: ast.AST) -> bool:
    """Whether an argument of ``.to(...)`` names a device: a name or
    attribute called ``device``/``dev``/``*_device``, ``torch.device(...)``
    or the string ``"cuda..."``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return _dotted(node.func) == "torch.device"
    leaf = _dotted(node).split(".")[-1]
    return leaf in ("device", "dev") or leaf.endswith("_device")


def _is_host(node: Optional[ast.AST], host: Set[str]) -> bool:
    """Whether ``node`` is known to be a host value (module docstring),
    given the names ``host`` known to hold one."""
    if node is None or isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        return all(_is_host(e, host) for e in node.elts)
    if isinstance(node, ast.Subscript):
        return _is_host(node.value, host)
    if isinstance(node, ast.Attribute):
        return node.attr in HOST_ATTRS or _is_host(node.value, host)
    if isinstance(node, ast.Compare):
        return all(_is_host(e, host) for e in [node.left] + node.comparators)
    if isinstance(node, ast.BinOp):
        return _is_host(node.left, host) and _is_host(node.right, host)
    if isinstance(node, ast.UnaryOp):
        return _is_host(node.operand, host)
    if isinstance(node, ast.BoolOp):
        return all(_is_host(e, host) for e in node.values)
    if isinstance(node, ast.IfExp):
        return _is_host(node.body, host) and _is_host(node.orelse, host)
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name.startswith(("np.", "numpy.")) or name in HOST_CALLS:
            return True
        if isinstance(node.func, ast.Attribute):
            return (node.func.attr in HOST_RESULT_METHODS
                    or _is_host(node.func.value, host))
        return name in HOST_IF_ARGS and all(_is_host(a, host) for a in node.args)
    return False


def _target_names(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _target_names(e)]
    return []


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    words = set(re.findall(r"[A-Za-z_]+", ast.unparse(ann)))
    return bool(words & HOST_ANNOTATIONS) and not words & {"Tensor", "torch", "Any"}


_UNKNOWN = ast.Pass()                     # a binding of no known kind


def _host_names(fn: ast.AST) -> Set[str]:
    """The names of ``fn`` known to hold host values: every binding of
    each (parameters, assignments, loop and comprehension targets) is one."""
    binds: Dict[str, List[Optional[ast.AST]]] = {}   # None: a host parameter
    a = fn.args
    for arg in a.posonlyargs + a.args + a.kwonlyargs:
        binds.setdefault(arg.arg, []).append(
            None if _host_annotation(arg.annotation) else _UNKNOWN)
    for node in ast.walk(fn):
        pairs = []
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                        node.value, (ast.Tuple, ast.List)) and len(t.elts) == len(
                        node.value.elts):
                    pairs += list(zip(t.elts, node.value.elts))
                else:
                    pairs.append((t, node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
            pairs.append((node.target, node.value))
        elif isinstance(node, (ast.For, ast.comprehension)):
            pairs.append((node.target, ast.Subscript(value=node.iter)))   # an element
        elif isinstance(node, ast.With):
            pairs += [(i.optional_vars, _UNKNOWN) for i in node.items if i.optional_vars]
        for target, value in pairs:
            for name in _target_names(target):
                binds.setdefault(name, []).append(value)
    host: Set[str] = set(binds)           # the greatest fixed point: ``e = int(e)``
    while True:
        now = {n for n in host if all(v is None or (v is not _UNKNOWN and _is_host(v, host))
                                      for v in binds[n])}
        if now == host:
            return host
        host = now


def _other_tensor_device(node: ast.AST) -> bool:
    """``x.device`` of a value other than ``self``: where another tensor lives."""
    return (isinstance(node, ast.Attribute) and node.attr == "device"
            and not (isinstance(node.value, ast.Name) and node.value.id == "self"))


def _out_of_place(node: ast.AST) -> Optional[str]:
    """What makes ``node`` a new tensor rather than an in-place write."""
    if isinstance(node, ast.BinOp):
        return "an arithmetic result"
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name in OUT_OF_PLACE:
            return name
        if isinstance(node.func, ast.Attribute) and node.func.attr in OUT_OF_PLACE_METHODS:
            return f".{node.func.attr}()"
    return None


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, relpath: str) -> None:
        self.path = path
        self.relpath = relpath.replace("\\", "/")
        self.findings: List[Finding] = []
        self._hot = 0
        self._registered = 0
        self._scope: List[str] = []
        self._host: List[Set[str]] = [set()]

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(self.path, getattr(node, "lineno", 0), rule, message))

    def _visit_function(self, node) -> None:
        names = [n.split(".")[-1] for n in _decorator_names(node)]
        hot = any(n in HOT_PATH_NAMES for n in names)
        reg = any(n in REGISTER_NAMES for n in names)
        self._hot += hot
        self._registered += reg
        self._scope.append(node.name)
        self._host.append(_host_names(node))
        self.generic_visit(node)
        self._host.pop()
        self._scope.pop()
        self._registered -= reg
        self._hot -= hot

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- calls: MG101, MG103, MG105, MG107 ---------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        host = self._host[-1]
        first = node.args[0] if node.args else None
        if self._hot:
            if name in HOST_READ_FUNCS and not (name.startswith(("np.", "numpy."))
                                                and _is_host(first, host)):
                self._flag(node, "MG101", f"{name}() inside a @hot_path function "
                           "waits for the device")
            elif attr in HOST_READ_METHODS:
                self._flag(node, "MG101", f".{attr}() inside a @hot_path function "
                           "is a host read or host wait")
            elif (isinstance(node.func, ast.Name) and node.func.id in CAST_NAMES
                  and first is not None and not _is_host(first, host)):
                self._flag(node, "MG101", f"{node.func.id}() of a value not known to be "
                           "a host one, inside a @hot_path function, reads a tensor back")
        if not self.relpath.endswith(COPY_OK):
            dev = ([a for a in node.args[:1] if _is_device(a)]
                   + [k.value for k in node.keywords if k.arg == "device"])
            receiver = node.func.value if attr is not None else None
            if attr == "cuda" or (attr == "to" and dev and (
                    _is_host(receiver, host) or not _other_tensor_device(dev[0]))):
                self._flag(node, "MG105", f".{attr}() copies to the device outside "
                           "serving/weights.py and serving/cache.py")
            elif (name in ("torch.as_tensor", "torch.tensor") and first is not None
                  and any(k.arg == "device" for k in node.keywords)
                  and _is_host(first, host)):
                self._flag(node, "MG105", f"{name}(<host value>, device=) copies to the "
                           "device outside serving/weights.py and serving/cache.py")
        if (self.relpath.startswith("distributed/") and attr in COLLECTIVE_NAMES
                and not self._registered):
            self._flag(node, "MG107", f"collective '{attr}' outside a "
                       "@register_collective function")
        if name == "object.__setattr__" and not (
                self._scope and self._scope[-1] in SETATTR_OK_SCOPES):
            self._flag(node, "MG103", "object.__setattr__ mutates a frozen dataclass "
                       "outside __init__/__post_init__")
        self.generic_visit(node)

    # -- MG102 -------------------------------------------------------------
    def _visit_loop(self, node) -> None:
        for stmt in node.body + getattr(node, "orelse", []):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and _dotted(sub.func) in LOOP_BUILDS:
                    self._flag(sub, "MG102", f"{_dotted(sub.func)}() inside a loop "
                               "runs once per iteration")
        self.generic_visit(node)

    visit_For = _visit_loop
    visit_While = _visit_loop

    # -- MG103 / MG104: assignments ------------------------------------------
    def _config_target(self, target: ast.AST) -> Optional[str]:
        if not isinstance(target, ast.Attribute):
            return None
        base = target.value
        if isinstance(base, ast.Name) and base.id in CONFIG_NAMES:
            return base.id
        if isinstance(base, ast.Attribute) and base.attr in CONFIG_NAMES:
            return base.attr
        return None

    def _check_targets(self, node, targets, value) -> None:
        for target in targets:
            name = self._config_target(target)
            if name:
                self._flag(node, "MG103", f"assignment into '{name}.{target.attr}': "
                           "config dataclasses are frozen; use dataclasses.replace")
            why = _out_of_place(value) if value is not None else None
            if (self._hot and why and not isinstance(target, ast.Name)
                    and _names_in_target(target) & CACHE_NAMES):
                self._flag(node, "MG104", f"a cache tensor rebound to {why}: write "
                           "it in place (the captured graphs hold the old one)")
            elif (self._hot and why and isinstance(target, ast.Name)
                  and target.id in CACHE_NAMES):
                self._flag(node, "MG104", f"'{target.id}' rebound to {why}: write "
                           "it in place (the captured graphs hold the old one)")

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_targets(node, node.targets, node.value)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        name = self._config_target(node.target)
        if name:
            self._flag(node, "MG103", f"augmented assignment into '{name}."
                       f"{node.target.attr}': config dataclasses are frozen")
        self.generic_visit(node)


def check_source(text: str, path: str = "<memory>",
                 relpath: Optional[str] = None) -> List[Finding]:
    """Lint one source text: the findings no allowance covers, plus MG106
    for every allowance without a reason or that covers nothing."""
    tree = ast.parse(text, filename=path)
    checker = _Checker(path, relpath if relpath is not None else path)
    checker.visit(tree)
    allow = _parse_allowances(text)
    findings: List[Finding] = []
    used: Set[Tuple[int, str]] = set()
    seen: Set[Tuple[int, str]] = set()
    for f in checker.findings:
        if (f.line, f.rule) in seen:
            continue
        seen.add((f.line, f.rule))
        entry = allow.get(f.line)
        if entry is not None and f.rule in entry[0]:
            used.add((f.line, f.rule))
            continue
        findings.append(f)
    for line, (rules, reason) in sorted(allow.items()):
        if not reason:
            findings.append(Finding(path, line, "MG106", f"allowance for "
                                    f"{','.join(sorted(rules))} has no reason"))
        stale = sorted(r for r in rules if (line, r) not in used)
        if stale:
            findings.append(Finding(path, line, "MG106", f"allowance for "
                                    f"{','.join(stale)} suppresses nothing"))
    return findings


def _iter_py_files(paths: Sequence[str]) -> Iterable[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def _relpath(path: Path) -> str:
    """The path relative to its ``repro_torch`` package root (MG105 and
    MG107 match package-relative module paths)."""
    parts = path.as_posix().split("/")
    if "repro_torch" in parts:
        idx = len(parts) - 1 - parts[::-1].index("repro_torch")
        return "/".join(parts[idx + 1:])
    return path.as_posix()


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in _iter_py_files(paths):
        findings += check_source(path.read_text(), path=str(path), relpath=_relpath(path))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description="The port's contract lint (MG101-MG107).")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths)
    for f in findings:
        print(f.render())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
