"""Shared AST plumbing for the static analyzers.

Everything here is plain ``ast`` over source text — no imports of the
analyzed code.  It is the part of the JAX package's
``repro.analysis.astutil`` the port's families use (the port imports
nothing of that package):

  * :class:`Module` — one parsed file plus the helpers analyzers need
    (enclosing-symbol lookup, its function definitions),
  * :func:`dotted` — best-effort dotted-name rendering of an expression
    (``torch.cuda.synchronize`` from the ``Attribute`` chain),
  * :func:`own_scope_nodes`, :func:`assignments`, :func:`keyword_arg`,
    :func:`is_config_chain`.

The reference's ``touches`` / ``ConstEvaluator`` have their port's
counterparts where the port reads values: device-tensor taint in
``dataflow.Program.is_device`` and the C evaluator in ``csrc``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# Directory parts that are never analyzed (intentionally-bad fixture
# snippets live under a ``fixtures`` dir; see tests/test_analysis.py;
# ``build`` holds generated and unpacked copies).
EXCLUDED_PARTS = ("__pycache__", ".git", "fixtures", ".venv", "build")

# Attributes that reach static configuration objects in this codebase
# (``ctx.policy``, ``self.cfg``): the objects hanging off these names
# are frozen config dataclasses, never tensors, so a call on them does
# not carry device-tensor taint even when the carrier (a Ctx holding
# device tensors) does.
CONFIG_ATTRS = ("policy", "cfg", "config", "spec")

# Bare names that, by convention, bind config objects wherever they
# appear (``policy.config_for(t)`` inside a traced helper).
CONFIG_NAMES = ("cfg", "config", "policy", "spec")


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
    _functions: Optional[List[ast.FunctionDef]] = None

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
        if self._functions is None:
            self._functions = [n for n in ast.walk(self.tree)
                               if isinstance(n, ast.FunctionDef)]
        return list(self._functions)


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
