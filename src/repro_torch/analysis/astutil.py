"""Shared AST plumbing for the static analyzers.

Everything here is plain ``ast`` over source text — no imports of the
analyzed code.  It is the JAX package's ``repro.analysis.astutil``,
kept whole in the port (which imports nothing of that package): the
policy checker (``policy_check``) uses the module and call helpers, and
the counterparts of the host-sync and kernel-contract families (ROADMAP
Queue A.17) will use the rest:

  * :class:`Module` — one parsed file plus the helpers analyzers need
    (enclosing-symbol lookup, per-function assignment maps),
  * :func:`dotted` — best-effort dotted-name rendering of an expression
    (``torch.cuda.synchronize`` from the ``Attribute`` chain),
  * :class:`ConstEvaluator` — a tiny arithmetic evaluator for block
    shapes (``min(bm, d_in)``, ``d // block_d``) under an environment of
    known values plus a configurable assumption for unknown names.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import (AbstractSet, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

# Directory parts that are never analyzed (intentionally-bad fixture
# snippets live under a ``fixtures`` dir; see tests/test_analysis.py;
# ``build`` holds generated and unpacked copies).
EXCLUDED_PARTS = ("__pycache__", ".git", "fixtures", ".venv", "build")

# Attribute accesses that read static (trace-time) properties of an
# array, never its runtime values.
STATIC_ATTRS = ("shape", "ndim", "dtype", "size", "sharding", "weak_type")

# Attributes that reach static configuration objects in this codebase
# (``ctx.policy``, ``self.cfg``): the objects hanging off these names
# are frozen config dataclasses, never traced arrays, so reads through
# them do not propagate traced-value taint even when the carrier (a Ctx
# holding a traced key) does.
CONFIG_ATTRS = ("policy", "cfg", "config", "spec")

# Bare names that, by convention, bind config objects wherever they
# appear (``policy.config_for(t)`` inside a traced helper).
CONFIG_NAMES = ("cfg", "config", "policy", "spec")

# Calls whose results are static regardless of their arguments: type
# probes plus the functional forms of the static attrs (``np.ndim(x)``,
# ``np.shape(x)``).
_STATIC_CALL_NAMES = ("len", "isinstance", "type")
_STATIC_CALL_LEAVES = ("ndim", "shape", "size")

DTYPE_BYTES = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool_": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    """Yield .py files under ``paths`` (files or directories), sorted,
    skipping :data:`EXCLUDED_PARTS` directories."""
    seen = set()
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            if p not in seen:
                seen.add(p)
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in EXCLUDED_PARTS)
            for f in sorted(files):
                if f.endswith(".py"):
                    full = os.path.join(root, f)
                    if full not in seen:
                        seen.add(full)
                        yield full


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: str
    tree: ast.Module
    source: str

    _parents: Optional[Dict[int, ast.AST]] = None

    @classmethod
    def load(cls, path: str) -> "Module":
        with open(path, encoding="utf-8") as f:
            src = f.read()
        return cls(path=path, tree=ast.parse(src, filename=path),
                   source=src)

    # -- parent / symbol lookup ------------------------------------------

    def parents(self) -> Dict[int, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[id(child)] = node
        return self._parents

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents().get(id(node))

    def symbol_for(self, node: ast.AST) -> str:
        """Dotted enclosing Class.function name for a node."""
        names: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self.parent(cur)
        return ".".join(reversed(names)) or "<module>"

    def functions(self) -> List[ast.FunctionDef]:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, ast.FunctionDef)]


def load_modules(paths: Sequence[str]) -> Tuple[List[Module], List[str]]:
    """Parse every file; returns (modules, unparseable file paths)."""
    mods, broken = [], []
    for f in iter_py_files(paths):
        try:
            mods.append(Module.load(f))
        except SyntaxError:
            broken.append(f)
    return mods, broken


def own_scope_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn``'s own scope, nested function/class bodies
    excluded (their statements belong to the inner scope)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def is_config_chain(node: ast.AST) -> bool:
    """Whether an expression denotes a static config object — a bare
    :data:`CONFIG_NAMES` name or any attribute path passing through a
    :data:`CONFIG_ATTRS` link (``ctx.policy``, ``self.cfg.opt``)."""
    if isinstance(node, ast.Name):
        return node.id in CONFIG_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in CONFIG_ATTRS or is_config_chain(node.value)
    return False


def touches(node: ast.AST, names: AbstractSet[str]) -> bool:
    """Whether evaluating ``node`` reads runtime data of any name in
    ``names``.  Static accesses are escapes:

      * ``.shape``/``.ndim``/... (:data:`STATIC_ATTRS`) and their
        functional forms (``len()``/``np.ndim()``/``np.shape()``),
      * reads through config carriers (:data:`CONFIG_ATTRS`:
        ``ctx.policy.*`` is a frozen-dataclass read, not a value read),
      * the container side of an ``in`` test (``"k" in state`` is a
        structure probe),
      * ``x is None`` / ``x is not None`` (presence probe: under jit a
        traced value is never None, so the branch is structural),
      * ``.keys()`` of a dict pytree (static structure under jit).
    """
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in STATIC_ATTRS or node.attr in CONFIG_ATTRS:
            return False
        return touches(node.value, names)
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in _STATIC_CALL_NAMES:
            return False
        if (name and "." in name
                and name.rsplit(".", 1)[-1] in _STATIC_CALL_LEAVES):
            return False
        func_reads = False
        if isinstance(node.func, ast.Attribute):
            if node.func.attr == "keys" and not node.args:
                return False
            # methods OF a config object return config — the args only
            # select which entry (``ctx.policy.config_for(tag)``)
            if is_config_chain(node.func.value):
                return False
            # a method call on a traced value reads it
            # (``batch.sum()``), modulo the static-attr escapes above
            func_reads = touches(node.func, names)
        return func_reads or any(
            touches(a, names) for a in node.args) or any(
            touches(kw.value, names) for kw in node.keywords)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops) \
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in node.comparators):
            return False
        ops_in = [isinstance(op, (ast.In, ast.NotIn)) for op in node.ops]
        if any(ops_in):
            sides = [node.left] + list(node.comparators)
            checked = [sides[0]] + [
                c for c, is_in in zip(sides[1:], ops_in) if not is_in]
            return any(touches(s, names) for s in checked)
    for child in ast.iter_child_nodes(node):
        if touches(child, names):
            return True
    return False


def assignments(fn: ast.AST) -> Dict[str, ast.expr]:
    """Name -> value expr for simple assignments directly inside ``fn``
    (last one wins; tuple targets map each element when the value is a
    tuple of matching arity)."""
    out: Dict[str, ast.expr] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = node.value
            elif (isinstance(tgt, ast.Tuple)
                  and isinstance(node.value, ast.Tuple)
                  and len(tgt.elts) == len(node.value.elts)):
                for t, v in zip(tgt.elts, node.value.elts):
                    if isinstance(t, ast.Name):
                        out[t.id] = v
    return out


def param_defaults(fn: ast.FunctionDef) -> Dict[str, ast.expr]:
    """Parameter name -> default expr (positional + keyword-only)."""
    out: Dict[str, ast.expr] = {}
    args = fn.args
    pos = args.posonlyargs + args.args
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        out[a.arg] = d
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if d is not None:
            out[a.arg] = d
    return out


def dtype_bytes(node: Optional[ast.AST], default: int = 4) -> int:
    """Byte width of a dtype expression like ``torch.float32``."""
    if node is None:
        return default
    name = dotted(node)
    if name is None:
        return default
    return DTYPE_BYTES.get(name.rsplit(".", 1)[-1], default)


class ConstEvaluator:
    """Evaluate int-ish shape arithmetic under ``env``; unknown names
    fall back to ``assume`` (tracked in ``self.assumed``) so block
    geometry like ``min(bm, d_in)`` stays computable as an estimate."""

    def __init__(self, env: Dict[str, int], assume: Optional[int] = None):
        self.env = dict(env)
        self.assume = assume
        self.assumed: List[str] = []

    def eval(self, node: ast.AST) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if self.assume is not None:
                self.assumed.append(node.id)
                return self.assume
            return None
        if isinstance(node, ast.BinOp):
            left, right = self.eval(node.left), self.eval(node.right)
            if left is None or right is None:
                return None
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.FloorDiv) and right:
                return left // right
            if isinstance(node.op, ast.Mod) and right:
                return left % right
            return None
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in ("min", "max") and node.args:
                vals = [self.eval(a) for a in node.args]
                if any(v is None for v in vals):
                    return None
                return (min if name == "min" else max)(*vals)
            return None
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = self.eval(node.operand)
            return None if v is None else -v
        return None
