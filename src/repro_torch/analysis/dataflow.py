"""Dataflow layer: def-use chains, call/closure graph, device-tensor taint.

The port's counterpart of ``repro.analysis.dataflow``, kept whole where
the machinery carries over and re-aimed where JAX's notions have no
eager-torch meaning.  Still pure ``ast`` — analyzed code is never
imported.

  1. **Abstract values** (:class:`AVal`): every expression evaluates to
     the set of *function definitions* it may reference (and the
     analyzed *classes* it may name), with enough container structure
     (tuple elements, constant dict keys, a ``*`` wildcard slot) to
     survive packing and unpacking.  Depth- and width-capped.
  2. **Module/function environments**: statements are interpreted in
     order per scope; ``import``/``from-import`` link environments
     across modules of the analyzed set, and ``self.x = ...``
     assignments accumulate into a per-class attribute environment.
     Calling an analyzed class binds the arguments to its ``__init__``
     and yields an instance, which, called, is the class's ``__call__``
     (an ``nn.Module`` subclass: its ``forward``).
  3. **Step scopes** take the place of the reference's traced scopes:
     eager torch has no trace, but it has the functions a training or
     serving loop calls once a step, where one host read drains the
     device queue every step.  A function is a step scope when it is
     reachable in the *return value* of a ``make_*`` builder (through
     dicts, tuples, ``functools.partial``, re-binding, call returns and
     class instances — ``make_scheduled_train_step`` returns a
     ``ScheduledStepFn`` whose ``__call__`` is the step), when it is
     nested inside a step scope, or when a step scope *calls* it
     (call-graph closure, through ``Function.apply`` and
     ``checkpoint`` too).
  4. **Recompute scopes** take the place of the reference's
     closure-capture scopes: the functions that run twice and must
     agree — ``forward`` / ``backward`` of every ``torch.autograd.
     Function`` subclass, and every function handed to
     ``torch.utils.checkpoint.checkpoint`` (by call or through
     ``partial``) — with what they nest and call.
  5. **Taint = device tensors.**  Positional parameters are *not*
     tainted wholesale (a train state mixes tensors and Python
     numbers: ``int(state["step"])`` is a host read of a host int).
     Taint starts from values known to be device tensors: results of
     ``torch.*`` / ``F.*`` calls that build (with a ``device=``) or
     transform tensors, tensor methods and arithmetic on tainted
     values, parameters annotated ``torch.Tensor``, and values returned
     by calls to a builder's step or to an ``nn.Module``.  A callee's
     parameters are tainted exactly where tainted arguments flow in.
     ``.cpu()``, ``.to("cpu")``, ``.numpy()``, ``.tolist()`` and
     ``.item()`` end the taint; static reads (``.shape``, ``.size()``,
     ``.dim()``, ``.numel()``, ``.dtype``, ``.device``, ``.is_cuda``,
     ``len()``, the reference's ``in`` / ``is None`` probes) never
     carry it.

The solver is the reference's bounded fixpoint (``MAX_ROUNDS``,
``MAX_DEPTH``, ``MAX_FUNCS``).  Dynamic flow the lattice cannot
represent (``getattr`` dispatch, ``**kwargs`` forwarding) is not
resolved; inner defs of ``make_*`` builders left unproven are scanned
at NOTE severity (:meth:`Program.fallback_functions`).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import astutil

MAX_ROUNDS = 4          # whole-program fixpoint rounds
MAX_DEPTH = 5           # AVal structure depth cap
MAX_FUNCS = 64          # AVal function-set width cap
WILDCARD = "*"          # items slot for non-constant container keys

# torch factories: a device tensor only with a device= other than "cpu"
# (their default device is the CPU)
_FACTORIES = frozenset((
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
    "empty_strided", "scalar_tensor", "normal", "bernoulli"))
# torch calls whose result is no tensor, or a host one
_HOST_TORCH = frozenset((
    "from_numpy", "device", "Generator", "dtype", "Size", "finfo",
    "iinfo", "is_tensor", "is_grad_enabled", "get_default_dtype",
    "no_grad", "enable_grad", "inference_mode", "set_grad_enabled",
    "manual_seed", "use_deterministic_algorithms", "set_num_threads",
    "get_num_threads", "is_floating_point", "is_complex", "numel",
    "set_default_dtype", "promote_types", "result_type", "can_cast",
    "is_nonzero", "get_rng_state", "set_rng_state", "initial_seed",
    "save", "load", "set_printoptions", "broadcast_shapes"))
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.distributed.",
                        "torch.backends.", "torch.profiler.",
                        "torch.multiprocessing.", "torch.testing.",
                        "torch.utils.data.", "torch.library.",
                        "torch.jit.", "torch._C.")
# tensor methods that read host-side metadata only
STATIC_METHODS = frozenset((
    "size", "dim", "numel", "nelement", "stride", "data_ptr",
    "element_size", "is_contiguous", "get_device", "storage_offset",
    "is_floating_point", "is_complex", "ndimension"))
# a tensor's tensor-valued attributes (``.shape``, ``.dtype``,
# ``.device``, ``.requires_grad`` and the rest are host metadata)
TENSOR_ATTRS = frozenset(("T", "mT", "H", "mH", "data", "grad", "real",
                          "imag"))
# builtins that, applied to a bare name, list a dict's keys in this
# codebase (a tensor's rows go through ``unbind``)
_KEY_LISTS = frozenset(("list", "sorted", "set", "tuple", "frozenset"))
# methods that end the taint: a host value comes out (the sync ones
# are JL001's subject)
HOST_METHODS = frozenset(("cpu", "numpy", "tolist", "item"))


def _torch_head(name: str) -> bool:
    return (name.startswith("torch.") or name.startswith("F.")
            or name.startswith("nn.functional."))


def _is_cpu_literal(node: Optional[ast.expr]) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` (or ``"meta"``: a meta tensor
    holds no values to read)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] in ("cpu", "meta")
    if isinstance(node, ast.Call) and node.args \
            and (astutil.call_name(node) or "").endswith("device"):
        return _is_cpu_literal(node.args[0])
    return False


def is_recompute_consumer(name: Optional[str]) -> bool:
    """``torch.utils.checkpoint.checkpoint`` (however imported): it runs
    the function it is handed once more in the backward."""
    if not name:
        return False
    head, _, leaf = name.rpartition(".")
    if leaf not in ("checkpoint", "checkpoint_sequential"):
        return False
    return not head or head.endswith("checkpoint") \
        or head.endswith("utils")


def _is_partial(name: Optional[str]) -> bool:
    return bool(name) and name.rsplit(".", 1)[-1] == "partial"


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------

class AVal:
    """Abstract value: the function defs (and analyzed classes) an
    expression may reference, plus container structure for
    packing/unpacking.  Immutable-by-convention — every operation builds
    a new instance."""

    __slots__ = ("funcs", "mods", "classes", "elems", "items")

    def __init__(self, funcs: Iterable[int] = (),
                 mods: Iterable[str] = (),
                 elems: Optional[Tuple["AVal", ...]] = None,
                 items: Optional[Dict[object, "AVal"]] = None,
                 classes: Iterable[int] = ()):
        self.funcs: FrozenSet[int] = frozenset(funcs)
        self.mods: FrozenSet[str] = frozenset(mods)
        self.classes: FrozenSet[int] = frozenset(classes)
        self.elems = elems
        self.items: Dict[object, "AVal"] = dict(items) if items else {}

    def is_empty(self) -> bool:
        return (not self.funcs and not self.mods and not self.classes
                and self.elems is None and not self.items)

    def all_funcs(self) -> Set[int]:
        """Every function id reachable anywhere in the structure."""
        out: Set[int] = set(self.funcs)
        for sub in (self.elems or ()):
            out |= sub.all_funcs()
        for sub in self.items.values():
            out |= sub.all_funcs()
        return out

    def member(self) -> "AVal":
        """Join of everything an unknown index/key could yield."""
        parts = list(self.elems or ()) + list(self.items.values())
        return merge_all(parts)

    def index(self, key: object) -> "AVal":
        """Constant subscript: ``aval[key]``."""
        if isinstance(key, int) and self.elems is not None \
                and 0 <= key < len(self.elems):
            out = self.elems[key]
        elif key in self.items:
            out = self.items[key]
        else:
            return self.member() if WILDCARD not in self.items \
                else merge(self.member(), self.items[WILDCARD])
        if WILDCARD in self.items:
            out = merge(out, self.items[WILDCARD])
        return out

    def with_item(self, key: object, val: "AVal") -> "AVal":
        items = dict(self.items)
        k = key if isinstance(key, (str, int, bool)) else WILDCARD
        items[k] = merge(items.get(k, AVal()), val)
        return AVal(self.funcs, self.mods, self.elems, items, self.classes)

    def key(self) -> object:
        """Hashable structural signature (fixpoint change detection)."""
        return (tuple(sorted(self.funcs)), tuple(sorted(self.mods)),
                tuple(sorted(self.classes)),
                None if self.elems is None
                else tuple(e.key() for e in self.elems),
                tuple(sorted(((repr(k), v.key())
                              for k, v in self.items.items()))))

    def __repr__(self) -> str:  # debugging aid
        bits = []
        if self.funcs:
            bits.append(f"funcs={sorted(self.funcs)}")
        if self.classes:
            bits.append(f"classes={sorted(self.classes)}")
        if self.mods:
            bits.append(f"mods={sorted(self.mods)}")
        if self.elems is not None:
            bits.append(f"elems={list(self.elems)}")
        if self.items:
            bits.append(f"items={self.items}")
        return f"AVal({', '.join(bits)})"


def _flat(a: AVal, b: AVal) -> AVal:
    return AVal(funcs=a.all_funcs() | b.all_funcs(), mods=a.mods | b.mods,
                classes=a.classes | b.classes)


def merge(a: AVal, b: AVal, depth: int = 0) -> AVal:
    if a.is_empty():
        return b
    if b.is_empty():
        return a
    if depth >= MAX_DEPTH:
        return _flat(a, b)
    funcs = a.funcs | b.funcs
    if len(funcs) > MAX_FUNCS:
        return _flat(a, b)
    elems: Optional[Tuple[AVal, ...]]
    items = dict(a.items)
    if a.elems is not None and b.elems is not None \
            and len(a.elems) == len(b.elems):
        elems = tuple(merge(x, y, depth + 1)
                      for x, y in zip(a.elems, b.elems))
    elif a.elems is None and b.elems is None:
        elems = None
    else:
        # arity conflict: collapse positional structure into the
        # wildcard slot so unpacking stays conservative
        elems = None
        spill = merge_all([*(a.elems or ()), *(b.elems or ())],
                          depth + 1)
        items[WILDCARD] = merge(items.get(WILDCARD, AVal()), spill,
                                depth + 1)
    for k, v in b.items.items():
        items[k] = merge(items.get(k, AVal()), v, depth + 1) \
            if k in items else v
    return AVal(funcs=funcs, mods=a.mods | b.mods, elems=elems,
                items=items, classes=a.classes | b.classes)


def merge_all(vals: Iterable[AVal], depth: int = 0) -> AVal:
    out = AVal()
    for v in vals:
        out = merge(out, v, depth)
    return out


# ---------------------------------------------------------------------------
# program index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncInfo:
    """One function definition in the analyzed set."""

    index: int
    module: astutil.Module
    node: ast.FunctionDef
    qualname: str
    parent: Optional[int]          # enclosing FunctionDef's index
    cls: Optional[ast.ClassDef]    # immediately enclosing class

    @property
    def is_method(self) -> bool:
        return self.cls is not None

    def positional_params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        if self.is_method and names and names[0] in ("self", "cls"):
            names = names[1:]
        return names


@dataclasses.dataclass
class ClassInfo:
    """One class definition in the analyzed set."""

    index: int
    module: astutil.Module
    node: ast.ClassDef
    methods: Dict[str, int]        # direct method name -> FuncInfo index

    def _based_on(self, suffix: str) -> bool:
        return any((astutil.dotted(b) or "").endswith(suffix)
                   for b in self.node.bases)

    @property
    def is_autograd_function(self) -> bool:
        return self._based_on("autograd.Function")

    @property
    def is_module(self) -> bool:
        return self._based_on("nn.Module")


class _Scope:
    """One lexical scope's bindings, chained to the enclosing scope."""

    __slots__ = ("bindings", "parent", "owner")

    def __init__(self, parent: Optional["_Scope"] = None,
                 owner: Optional[FuncInfo] = None):
        self.bindings: Dict[str, AVal] = {}
        self.parent = parent
        self.owner = owner

    def get(self, name: str) -> AVal:
        scope: Optional[_Scope] = self
        while scope is not None:
            if name in scope.bindings:
                return scope.bindings[name]
            scope = scope.parent
        return AVal()

    def bind(self, name: str, val: AVal) -> None:
        self.bindings[name] = merge(self.bindings.get(name, AVal()), val)


def _module_dotted(path: str) -> List[str]:
    """All dotted-name suffixes a file could be imported as
    (``repro_torch.launch.train_steps`` -> also ``launch.train_steps``,
    ``train_steps``)."""
    norm = os.path.normpath(path).replace(os.sep, "/")
    if norm.endswith("/__init__.py"):
        norm = norm[: -len("/__init__.py")]
    elif norm.endswith(".py"):
        norm = norm[:-3]
    parts = [p for p in norm.split("/") if p and p != "."]
    out = []
    for i in range(max(0, len(parts) - 4), len(parts)):
        out.append(".".join(parts[i:]))
    return out


# A call edge: (callee index, shift) — ``call.args[i]`` binds the
# callee's positional parameter ``i + shift`` (``Function.apply`` skips
# ``ctx``: +1; ``checkpoint(fn, *args)`` hands ``args[1:]``: -1).
Edge = Tuple[int, int]
BACKWARD = 99           # the shift of the edge apply -> backward: no args


class Program:
    """Whole-program dataflow index over a set of parsed modules.

    Build once with :meth:`build`; query:

      * :meth:`step_functions` — the step scopes of a module,
      * :meth:`recompute_functions` — its recompute scopes,
      * :meth:`fallback_functions` — builder-idiom candidates the
        lattice could NOT prove steps (analyzed at NOTE severity),
      * :meth:`tainted_names` — device-tensor names within a function,
      * :meth:`is_device` — whether an expression is a device tensor,
      * :meth:`eval_in` / :meth:`resolve_functions` — abstract value of
        an expression in a function/module scope.
    """

    def __init__(self, modules: List[astutil.Module]):
        self.modules = list(modules)
        self.funcs: List[FuncInfo] = []
        self.classes: List[ClassInfo] = []
        self._by_node: Dict[int, int] = {}
        self._class_by_node: Dict[int, int] = {}
        self._mod_scopes: Dict[str, _Scope] = {}
        self._fn_scopes: Dict[int, _Scope] = {}
        self._class_envs: Dict[int, Dict[str, AVal]] = {}
        self._summaries: Dict[int, AVal] = {}
        self._param_vals: Dict[Tuple[int, str], AVal] = {}
        self._call_edges: Dict[int, Set[Edge]] = {}
        self._class_calls: Set[int] = set()      # ids of class calls
        self._recompute_roots: Set[int] = set()
        self._step_roots: Set[int] = set()
        self._module_calls: Set[int] = set()     # nn.Module forwards
        self.steps: Set[int] = set()
        self.recompute: Set[int] = set()
        self._taints: Dict[int, Set[str]] = {}
        # function -> (returns a device tensor whatever its arguments,
        # the parameters whose device tensors reach its return)
        self._return_deps: Dict[int, Tuple[bool, FrozenSet[str]]] = {}
        self._taint_seeds: Dict[int, Set[str]] = {}
        self._import_table: Dict[str, str] = {}
        # filled once the fixpoint has fixed the call edges
        self._callsite_cache: Dict[int, List[Tuple[ast.Call, Edge]]] = {}
        self._index()

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, modules: List[astutil.Module]) -> "Program":
        prog = cls(modules)
        prog._solve()
        return prog

    def _index(self) -> None:
        ambiguous: Set[str] = set()
        for mod in self.modules:
            for name in _module_dotted(mod.path):
                if name in self._import_table:
                    ambiguous.add(name)
                self._import_table[name] = mod.path
            for fn in mod.functions():
                idx = len(self.funcs)
                parent: Optional[int] = None
                cls_node: Optional[ast.ClassDef] = None
                cur = mod.parent(fn)
                while cur is not None:
                    if cls_node is None and isinstance(cur, ast.ClassDef):
                        cls_node = cur
                    if isinstance(cur, ast.FunctionDef):
                        parent = self._by_node.get(id(cur))
                        break
                    cur = mod.parent(cur)
                self.funcs.append(FuncInfo(
                    index=idx, module=mod, node=fn,
                    qualname=mod.symbol_for(fn), parent=parent,
                    cls=cls_node))
                self._by_node[id(fn)] = idx
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    methods = {s.name: self._by_node[id(s)]
                               for s in node.body
                               if isinstance(s, ast.FunctionDef)
                               and id(s) in self._by_node}
                    self._class_by_node[id(node)] = len(self.classes)
                    self.classes.append(ClassInfo(
                        index=len(self.classes), module=mod, node=node,
                        methods=methods))
        for name in ambiguous:
            # two analyzed files claim the same dotted suffix — only
            # drop the short alias, fully-qualified suffixes stay
            if "." not in name:
                self._import_table.pop(name, None)
        for c in self.classes:
            if c.is_autograd_function:
                self._recompute_roots.update(
                    c.methods[m] for m in ("forward", "backward")
                    if m in c.methods)
            if c.is_module and "forward" in c.methods:
                self._module_calls.add(c.methods["forward"])

    # -- fixpoint --------------------------------------------------------

    def _solve(self) -> None:
        last_sig: object = None
        for _ in range(MAX_ROUNDS):
            self._pass()
            sig = (frozenset(self._recompute_roots),
                   tuple(sorted((i, v.key())
                                for i, v in self._summaries.items())))
            if sig == last_sig:
                break
            last_sig = sig
        self._close_steps()
        self._compute_taints()
        self._close_recompute()

    def _pass(self) -> None:
        for mod in self.modules:
            scope = _Scope()
            self._mod_scopes[mod.path] = scope
            self._exec_body(mod.tree.body, scope, mod, None)
        # class envs: method defs + self.attr assignments (all methods)
        for info in self.funcs:
            if info.cls is None or info.parent is not None:
                continue
            env = self._class_envs.setdefault(id(info.cls), {})
            env[info.node.name] = merge(
                env.get(info.node.name, AVal()),
                AVal(funcs={info.index}))
        for info in self.funcs:
            scope = self._function_scope(info)
            self._fn_scopes[info.index] = scope
            summary = self._exec_body(info.node.body, scope,
                                      info.module, info)
            self._summaries[info.index] = merge(
                self._summaries.get(info.index, AVal()), summary)

    def _function_scope(self, info: FuncInfo) -> _Scope:
        parent_scope = (self._fn_scopes.get(info.parent)
                        if info.parent is not None else None)
        if parent_scope is None:
            parent_scope = self._mod_scopes.get(info.module.path)
        scope = _Scope(parent=parent_scope, owner=info)
        a = info.node.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        for p in params + [x for x in (a.vararg,) if x is not None]:
            bound = self._param_vals.get((info.index, p.arg))
            scope.bindings[p.arg] = bound if bound is not None else AVal()
        return scope

    # -- statement interpretation ---------------------------------------

    def _exec_body(self, body: List[ast.stmt], scope: _Scope,
                   mod: astutil.Module,
                   info: Optional[FuncInfo]) -> AVal:
        summary = AVal()
        for stmt in body:
            summary = merge(summary,
                            self._exec_stmt(stmt, scope, mod, info))
        return summary

    def _exec_stmt(self, stmt: ast.stmt, scope: _Scope,
                   mod: astutil.Module,
                   info: Optional[FuncInfo]) -> AVal:
        summary = AVal()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            idx = self._by_node.get(id(stmt))
            if idx is not None:
                scope.bind(stmt.name, AVal(funcs={idx}))
                for dec in stmt.decorator_list:
                    self._eval(dec, scope, mod)
            return summary
        if isinstance(stmt, ast.ClassDef):
            env = self._class_envs.setdefault(id(stmt), {})
            for sub in stmt.body:
                if isinstance(sub, ast.Assign):
                    val = self._eval(sub.value, scope, mod)
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            env[t.id] = merge(env.get(t.id, AVal()), val)
            cidx = self._class_by_node.get(id(stmt))
            if cidx is not None:
                scope.bind(stmt.name, AVal(classes={cidx}))
            return summary
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            self._exec_import(stmt, scope)
            return summary
        if isinstance(stmt, ast.Assign):
            val = self._eval(stmt.value, scope, mod)
            for t in stmt.targets:
                self._bind_target(t, val, scope, mod)
            return summary
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._bind_target(stmt.target,
                              self._eval(stmt.value, scope, mod),
                              scope, mod)
            return summary
        if isinstance(stmt, ast.AugAssign):
            self._eval(stmt.value, scope, mod)
            return summary
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                return self._eval(stmt.value, scope, mod)
            return summary
        if isinstance(stmt, ast.Expr):
            self._eval(stmt.value, scope, mod)
            return summary
        if isinstance(stmt, (ast.If, ast.While)):
            self._eval(stmt.test, scope, mod)
            summary = merge(summary, self._exec_body(stmt.body, scope,
                                                     mod, info))
            return merge(summary, self._exec_body(stmt.orelse, scope,
                                                  mod, info))
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self._eval(stmt.iter, scope, mod)
            self._bind_target(stmt.target, it.member(), scope, mod)
            summary = merge(summary, self._exec_body(stmt.body, scope,
                                                     mod, info))
            return merge(summary, self._exec_body(stmt.orelse, scope,
                                                  mod, info))
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self._eval(item.context_expr, scope, mod)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, v, scope, mod)
            return self._exec_body(stmt.body, scope, mod, info)
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, stmt.orelse, stmt.finalbody):
                summary = merge(summary,
                                self._exec_body(part, scope, mod, info))
            for h in stmt.handlers:
                summary = merge(summary, self._exec_body(h.body, scope,
                                                         mod, info))
            return summary
        return summary

    def _exec_import(self, stmt: ast.stmt, scope: _Scope) -> None:
        if isinstance(stmt, ast.ImportFrom):
            if stmt.module is None:
                return
            target = self._import_table.get(stmt.module)
            for alias in stmt.names:
                if alias.name == "*":
                    continue
                bound = alias.asname or alias.name
                submod = self._import_table.get(
                    f"{stmt.module}.{alias.name}")
                if submod is not None:
                    scope.bind(bound, AVal(mods={submod}))
                elif target is not None:
                    member = self._module_member(target, alias.name)
                    if not member.is_empty():
                        scope.bind(bound, member)
        elif isinstance(stmt, ast.Import):
            for alias in stmt.names:
                target = self._import_table.get(alias.name)
                if target is None:
                    continue
                bound = alias.asname or alias.name.split(".")[0]
                if alias.asname is not None or "." not in alias.name:
                    scope.bind(bound, AVal(mods={target}))

    def _module_member(self, path: str, name: str) -> AVal:
        scope = self._mod_scopes.get(path)
        if scope is not None and name in scope.bindings:
            return scope.bindings[name]
        return AVal()

    def _bind_target(self, target: ast.expr, val: AVal, scope: _Scope,
                     mod: astutil.Module) -> None:
        if isinstance(target, ast.Name):
            scope.bind(target.id, val)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, val.member(), scope, mod)
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            if val.elems is not None and len(val.elems) == len(elts):
                for t, v in zip(elts, val.elems):
                    self._bind_target(t, v, scope, mod)
            else:
                spread = val.member()
                for t in elts:
                    self._bind_target(t, spread, scope, mod)
        elif isinstance(target, ast.Subscript):
            base = target.value
            key: object = WILDCARD
            if isinstance(target.slice, ast.Constant):
                key = target.slice.value
            if isinstance(base, ast.Name):
                scope.bind(base.id,
                           scope.get(base.id).with_item(key, val))
            elif (isinstance(base, ast.Attribute)
                  and isinstance(base.value, ast.Name)
                  and base.value.id == "self"):
                env = self._self_env(scope)
                if env is not None:
                    cur = env.get(base.attr, AVal())
                    env[base.attr] = cur.with_item(key, val)
        elif isinstance(target, ast.Attribute):
            if isinstance(target.value, ast.Name) \
                    and target.value.id == "self":
                env = self._self_env(scope)
                if env is not None:
                    env[target.attr] = merge(
                        env.get(target.attr, AVal()), val)

    def _self_env(self, scope: _Scope) -> Optional[Dict[str, AVal]]:
        cur: Optional[_Scope] = scope
        while cur is not None:
            if cur.owner is not None and cur.owner.cls is not None:
                return self._class_envs.setdefault(
                    id(cur.owner.cls), {})
            cur = cur.parent
        return None

    # -- expression evaluation ------------------------------------------

    def _eval(self, node: ast.expr, scope: _Scope,
              mod: astutil.Module) -> AVal:
        if isinstance(node, ast.Name):
            return scope.get(node.id)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                env = self._self_env(scope)
                if env is not None and node.attr in env:
                    return env[node.attr]
                return AVal()
            base = self._eval(node.value, scope, mod)
            out = AVal()
            for m in base.mods:
                out = merge(out, self._module_member(m, node.attr))
            for c in base.classes:
                env = self._class_envs.get(id(self.classes[c].node), {})
                if node.attr in env:
                    out = merge(out, env[node.attr])
            return out
        if isinstance(node, (ast.Tuple, ast.List)):
            return AVal(elems=tuple(self._eval(e, scope, mod)
                                    for e in node.elts))
        if isinstance(node, ast.Dict):
            items: Dict[object, AVal] = {}
            for k, v in zip(node.keys, node.values):
                val = self._eval(v, scope, mod)
                key: object = WILDCARD
                if isinstance(k, ast.Constant) \
                        and isinstance(k.value, (str, int, bool)):
                    key = k.value
                items[key] = merge(items.get(key, AVal()), val)
            return AVal(items=items)
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, scope, mod)
            if isinstance(node.slice, ast.Constant):
                return base.index(node.slice.value)
            self._eval_children(node.slice, scope, mod)
            return base.member()
        if isinstance(node, ast.Call):
            return self._eval_call(node, scope, mod)
        if isinstance(node, ast.IfExp):
            self._eval(node.test, scope, mod)
            return merge(self._eval(node.body, scope, mod),
                         self._eval(node.orelse, scope, mod))
        if isinstance(node, ast.BoolOp):
            return merge_all(self._eval(v, scope, mod)
                             for v in node.values)
        if isinstance(node, ast.NamedExpr):
            val = self._eval(node.value, scope, mod)
            self._bind_target(node.target, val, scope, mod)
            return val
        if isinstance(node, ast.Starred):
            return self._eval(node.value, scope, mod).member()
        self._eval_children(node, scope, mod)
        return AVal()

    def _eval_children(self, node: ast.AST, scope: _Scope,
                       mod: astutil.Module) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._eval(child, scope, mod)

    def _edge(self, node: ast.Call, fidx: int, shift: int,
              arg_vals: List[AVal],
              kw_vals: List[Tuple[Optional[str], AVal]]) -> AVal:
        """Record a resolved call and its argument flow; the callee's
        summary is the call's value (builder products survive it)."""
        self._call_edges.setdefault(id(node), set()).add((fidx, shift))
        self._bind_args(fidx, shift, arg_vals, kw_vals)
        return self._summaries.get(fidx, AVal())

    def _eval_call(self, node: ast.Call, scope: _Scope,
                   mod: astutil.Module) -> AVal:
        name = astutil.call_name(node)
        arg_vals = [self._eval(a, scope, mod) for a in node.args]
        kw_vals = [(kw.arg, self._eval(kw.value, scope, mod))
                   for kw in node.keywords]
        # positions are known only up to the first *args
        arg_vals = arg_vals[:len(self._positional(node))]

        # functools.partial(f, ...) keeps referencing f
        if _is_partial(name) and arg_vals:
            return arg_vals[0]

        # checkpoint(fn, *args): fn is a recompute scope, called with
        # args[1:]; the call's value is tensors, no function
        if is_recompute_consumer(name) and arg_vals:
            for fidx in arg_vals[0].all_funcs():
                self._recompute_roots.add(fidx)
                self._edge(node, fidx, -1, arg_vals, kw_vals)
            return AVal()

        # Function.apply(*args): forward(ctx, *args), then backward
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "apply":
            base = self._eval(node.func.value, scope, mod)
            hit = False
            for c in base.classes:
                cls = self.classes[c]
                if not cls.is_autograd_function:
                    continue
                hit = True
                for m in ("forward", "backward"):
                    if m in cls.methods:
                        self._edge(node, cls.methods[m],
                                   1 if m == "forward" else BACKWARD,
                                   arg_vals if m == "forward" else [],
                                   [])
            if hit:
                return AVal()

        fval = self._eval(node.func, scope, mod)
        result = AVal()
        for fidx in fval.funcs:
            result = merge(result,
                           self._edge(node, fidx, 0, arg_vals, kw_vals))
        # an analyzed class called: __init__ takes the arguments, and the
        # instance, called, is its __call__ (an nn.Module's forward)
        if fval.classes and not fval.funcs:
            self._class_calls.add(id(node))
        for c in fval.classes:
            cls = self.classes[c]
            if "__init__" in cls.methods:
                self._edge(node, cls.methods["__init__"], 0, arg_vals,
                           kw_vals)
            call = cls.methods.get("__call__")
            if call is None and cls.is_module:
                call = cls.methods.get("forward")
            if call is not None:
                result = merge(result, AVal(funcs={call}))
        return result

    def _bind_args(self, fidx: int, shift: int, arg_vals: List[AVal],
                   kw_vals: List[Tuple[Optional[str], AVal]]) -> None:
        info = self.funcs[fidx]
        params = info.positional_params()
        for i, v in enumerate(arg_vals):
            j = i + shift
            if v.is_empty() or not 0 <= j < len(params):
                continue
            key = (fidx, params[j])
            self._param_vals[key] = merge(
                self._param_vals.get(key, AVal()), v)
        a = info.node.args
        kw_ok = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        for kwname, v in kw_vals:
            if kwname is None or v.is_empty() or kwname not in kw_ok:
                continue
            key = (fidx, kwname)
            self._param_vals[key] = merge(
                self._param_vals.get(key, AVal()), v)

    # -- step / recompute closures + taint -------------------------------

    def _nested_in(self, idx: int, scopes: Set[int]) -> bool:
        p = self.funcs[idx].parent
        while p is not None:
            if p in scopes:
                return True
            p = self.funcs[p].parent
        return False

    def _close_nesting(self, scopes: Set[int]) -> None:
        for info in self.funcs:
            if info.index not in scopes \
                    and self._nested_in(info.index, scopes):
                scopes.add(info.index)

    def _close_steps(self) -> None:
        for info in self.funcs:
            if info.node.name.startswith("make_"):
                self._step_roots |= self._summaries.get(
                    info.index, AVal()).all_funcs()
        self.steps = set(self._step_roots)
        self._close_nesting(self.steps)
        # call-graph closure happens inside the taint worklist: a callee
        # becomes a step scope exactly when a step scope reaches it, and
        # its params are tainted only where device tensors flow in.

    def _close_recompute(self) -> None:
        self.recompute = set(self._recompute_roots)
        while True:
            before = len(self.recompute)
            self._close_nesting(self.recompute)
            for idx in list(self.recompute):
                for _, (fidx, _s) in self._callsites(self.funcs[idx]):
                    self.recompute.add(fidx)
            if len(self.recompute) == before:
                return

    def _callsites(self, info: FuncInfo
                   ) -> List[Tuple[ast.Call, Edge]]:
        got = self._callsite_cache.get(info.index)
        if got is None:
            got = []
            for node in astutil.own_scope_nodes(info.node):
                if isinstance(node, ast.Call):
                    for edge in self._call_edges.get(id(node), ()):
                        got.append((node, edge))
            self._callsite_cache[info.index] = got
        return got

    def _annotated_tensors(self, info: FuncInfo) -> Set[str]:
        a = info.node.args
        return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                if p.annotation is not None
                and any((astutil.dotted(n) or "").endswith("Tensor")
                        for n in ast.walk(p.annotation))}

    def _compute_taints(self) -> None:
        for idx in self.steps:
            self._taint_seeds.setdefault(idx, set())
        worklist = list(self.steps)
        guard = 0
        while worklist and guard < 20000:
            guard += 1
            idx = worklist.pop()
            info = self.funcs[idx]
            seeds = (self._taint_seeds.setdefault(idx, set())
                     | self._annotated_tensors(info))
            # inherit the enclosing chain's taint (closures read device
            # tensors of the scope they were defined in)
            p = info.parent
            while p is not None:
                seeds |= self._taints.get(p, set())
                p = self.funcs[p].parent
            taint = self._local_taint(info, seeds)
            if taint == self._taints.get(idx):
                continue
            self._taints[idx] = taint
            for sub in self.funcs:
                if sub.parent == idx and sub.index in self.steps:
                    worklist.append(sub.index)
            for call, (fidx, shift) in self._callsites(info):
                callee = self.funcs[fidx]
                params = callee.positional_params()
                grew = False
                tgt = self._taint_seeds.setdefault(fidx, set())
                for i, a in enumerate(self._positional(call)):
                    j = i + shift
                    if 0 <= j < len(params) and params[j] not in tgt \
                            and self.is_device(a, taint):
                        tgt.add(params[j])
                        grew = True
                for kw in call.keywords:
                    if kw.arg and kw.arg not in tgt \
                            and self.is_device(kw.value, taint):
                        tgt.add(kw.arg)
                        grew = True
                if fidx not in self.steps:
                    self.steps.add(fidx)
                    worklist.append(fidx)
                elif grew:
                    worklist.append(fidx)

    @staticmethod
    def _positional(call: ast.Call) -> List[ast.expr]:
        """The arguments whose position is known: those before the first
        ``*args``."""
        out = []
        for a in call.args:
            if isinstance(a, ast.Starred):
                break
            out.append(a)
        return out

    def _local_taint(self, info: FuncInfo,
                     seeds: Set[str]) -> Set[str]:
        """Def-use closure of ``seeds`` (and of the device tensors the
        scope makes itself) over ``info``'s own scope."""
        taint = set(seeds)
        for _ in range(8):
            before = len(taint)
            for node in astutil.own_scope_nodes(info.node):
                if isinstance(node, ast.Assign):
                    if self._value_taints(node.value, taint):
                        for t in node.targets:
                            self._taint_target(t, taint)
                elif isinstance(node, ast.AnnAssign):
                    if node.value is not None \
                            and self._value_taints(node.value, taint):
                        self._taint_target(node.target, taint)
                elif isinstance(node, ast.AugAssign):
                    if self._value_taints(node.value, taint):
                        self._taint_target(node.target, taint)
                elif isinstance(node, ast.NamedExpr):
                    if self._value_taints(node.value, taint):
                        self._taint_target(node.target, taint)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    self._taint_loop_target(node.iter, node.target,
                                            taint)
                elif isinstance(node, ast.comprehension):
                    self._taint_loop_target(node.iter, node.target,
                                            taint)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is not None \
                                and self.is_device(item.context_expr,
                                                   taint):
                            self._taint_target(item.optional_vars,
                                               taint)
            if len(taint) == before:
                break
        return taint

    def _value_taints(self, value: ast.expr, taint: Set[str]) -> bool:
        """Whether an assigned value is a device tensor (or holds one).
        A comprehension's result is tainted by what flows into its
        element; filter clauses select but do not flow into it."""
        if isinstance(value, (ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp)):
            inner = set(taint)
            for gen in value.generators:
                self._taint_loop_target(gen.iter, gen.target, inner)
            parts = ([value.key, value.value]
                     if isinstance(value, ast.DictComp)
                     else [value.elt])
            return any(self.is_device(p, inner) for p in parts)
        return self.is_device(value, taint)

    def _taint_loop_target(self, it: ast.expr, target: ast.expr,
                           taint: Set[str]) -> None:
        """The reference's loop-target rule: direct iteration of a dict
        yields its (static) keys; ``.values()`` / ``.items()`` (value
        half) / ``zip`` / a display / a tensor's rows carry taint."""
        if isinstance(it, ast.Call) and isinstance(it.func,
                                                   ast.Attribute):
            if it.func.attr in ("values", "items"):
                if not self.is_device(it.func.value, taint):
                    return
                if it.func.attr == "items" \
                        and isinstance(target, ast.Tuple) \
                        and len(target.elts) == 2:
                    self._taint_target(target.elts[1], taint)
                else:
                    self._taint_target(target, taint)
                return
        if isinstance(it, ast.Call):
            name = astutil.dotted(it.func)
            if name == "zip":
                elts = (target.elts if isinstance(target, ast.Tuple)
                        and len(target.elts) == len(it.args)
                        else None)
                for i, a in enumerate(it.args):
                    if self.is_device(a, taint):
                        self._taint_target(
                            elts[i] if elts else target, taint)
                return
            if name == "enumerate" and it.args:
                if self.is_device(it.args[0], taint):
                    self._taint_target(
                        target.elts[1] if isinstance(target, ast.Tuple)
                        and len(target.elts) == 2 else target, taint)
                return
        if isinstance(it, (ast.Tuple, ast.List)) \
                and self.is_device(it, taint):
            self._taint_target(target, taint)
        elif isinstance(it, ast.Name) and it.id in taint:
            # iterating a tensor (or a list of them) yields tensors; a
            # dict of them yields keys, but a tainted name bound to a
            # dict display is rare and the rows are the common case
            self._taint_target(target, taint)

    def _taint_target(self, target: ast.expr, taint: Set[str]) -> None:
        if isinstance(target, ast.Name):
            taint.add(target.id)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value, taint)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e, taint)
        # a subscript store taints nothing: a train state holds device
        # tensors beside Python numbers (``state["step"]``), and its
        # other entries stay what they were

    # -- the device judgement --------------------------------------------

    def is_device(self, node: ast.AST, taint: Set[str]) -> bool:
        """Whether evaluating ``node`` yields (or holds) a device tensor,
        given the device-tensor names ``taint``."""
        if isinstance(node, ast.Name):
            return node.id in taint
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            # a tensor's tensor-valued attributes; any other attribute
            # of a tainted name reads an object that holds tensors
            # (``ctx.mesh``, ``state.cfg``), not a tensor
            return node.attr in TENSOR_ATTRS \
                and self.is_device(node.value, taint)
        if isinstance(node, ast.Call):
            return self._call_is_device(node, taint)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            ops_in = [isinstance(op, (ast.In, ast.NotIn))
                      for op in node.ops]
            sides = [node.left] + list(node.comparators)
            if any(ops_in):
                checked = [sides[0]] + [
                    c for c, is_in in zip(sides[1:], ops_in) if not is_in]
                return any(self.is_device(s, taint) for s in checked)
            return any(self.is_device(s, taint) for s in sides)
        if isinstance(node, (ast.Lambda, ast.JoinedStr)):
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            return self._value_taints(node, taint)
        if isinstance(node, ast.Dict):
            return any(self.is_device(v, taint) for v in node.values)
        return any(self.is_device(c, taint)
                   for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def _call_is_device(self, node: ast.Call, taint: Set[str]) -> bool:
        name = astutil.call_name(node) or ""
        leaf = name.rsplit(".", 1)[-1]
        func = node.func
        if _is_cpu_literal(astutil.keyword_arg(node, "device")):
            # any builder asked for host (or meta) tensors:
            # ``init_params(cfg, 0, device="meta")``
            return False
        if isinstance(func, ast.Name) and func.id in (
                "len", "isinstance", "type", "int", "float", "bool",
                "str", "repr", "hash", "id", "callable", "hasattr",
                "getattr", "print", "range"):
            return False
        if isinstance(func, ast.Name) and func.id in _KEY_LISTS \
                and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Name):
            # ``list(taps)`` / ``sorted(sub.znorms)``: a dict's keys
            return False
        if name.startswith(("np.", "numpy.", "math.")) \
                or name in ("dataclasses.replace", "replace"):
            # a dataclass holding tensors is an object, not a tensor
            # (``dataclasses.replace(ctx, znorms=...)``)
            return False
        if isinstance(func, ast.Attribute):
            recv_dev = self.is_device(func.value, taint)
            if func.attr == "keys" and not node.args:
                return False
            if recv_dev:
                if func.attr in HOST_METHODS or func.attr in \
                        STATIC_METHODS:
                    return False
                if func.attr == "to" and (
                        (node.args and _is_cpu_literal(node.args[0]))
                        or _is_cpu_literal(
                            astutil.keyword_arg(node, "device"))):
                    return False
                return True
            if astutil.is_config_chain(func.value):
                return False
        if _torch_head(name):
            if leaf in _HOST_TORCH or name.startswith(_HOST_TORCH_PREFIXES):
                return False
            if leaf in _FACTORIES:
                dev = astutil.keyword_arg(node, "device")
                if dev is not None:
                    return not _is_cpu_literal(dev)
                return leaf == "as_tensor" and bool(node.args) \
                    and self.is_device(node.args[0], taint)
            return True
        if id(node) in self._class_calls:
            return False            # an analyzed class's instance
        edges = [f for f, shift in self._call_edges.get(id(node), ())
                 if shift != BACKWARD]
        if edges:
            # an analyzed callee: whether a device tensor comes back,
            # given which of these arguments are device tensors
            return any(self._returns_device(node, e, taint) for e in
                       self._call_edges[id(node)] if e[1] != BACKWARD)
        return any(self.is_device(a, taint) for a in node.args) or any(
            self.is_device(kw.value, taint) for kw in node.keywords)

    def _returns_device(self, node: ast.Call, edge: Edge,
                        taint: Set[str]) -> bool:
        fidx, shift = edge
        if fidx in self._step_roots or fidx in self._module_calls:
            return True
        always, deps = self._deps(fidx)
        if always:
            return True
        if not deps:
            return False
        params = self.funcs[fidx].positional_params()
        for i, a in enumerate(self._positional(node)):
            j = i + shift
            if 0 <= j < len(params) and params[j] in deps \
                    and self.is_device(a, taint):
                return True
        return any(kw.arg in deps and self.is_device(kw.value, taint)
                   for kw in node.keywords)

    def _deps(self, fidx: int) -> Tuple[bool, FrozenSet[str]]:
        """(whether ``fidx`` returns a device tensor whatever its
        arguments, the parameters whose device tensors reach its
        return): a context-sensitive return summary, so a helper fed a
        tensor at one call site (``fold_seed``) does not make every
        other call's result a tensor.  Recursion reads as 'no'."""
        got = self._return_deps.get(fidx)
        if got is not None:
            return got
        self._return_deps[fidx] = (False, frozenset())
        info = self.funcs[fidx]
        rets = [n.value for n in astutil.own_scope_nodes(info.node)
                if isinstance(n, ast.Return) and n.value is not None]
        base = self._annotated_tensors(info)
        p = info.parent
        while p is not None:
            base |= self._taints.get(p, set())
            p = self.funcs[p].parent

        def reaches(seeds: Set[str]) -> bool:
            taint = self._local_taint(info, seeds)
            return any(self.is_device(r, taint) for r in rets)

        out: Tuple[bool, FrozenSet[str]] = (False, frozenset())
        if rets:
            if reaches(set(base)):
                out = (True, frozenset())
            else:
                a = info.node.args
                params = [x.arg for x in a.posonlyargs + a.args
                          + a.kwonlyargs]
                out = (False, frozenset(
                    x for x in params if reaches(base | {x})))
        self._return_deps[fidx] = out
        return out

    # -- public queries --------------------------------------------------

    def is_step(self, fn: ast.FunctionDef) -> bool:
        idx = self._by_node.get(id(fn))
        return idx is not None and idx in self.steps

    def step_functions(self, mod: astutil.Module
                       ) -> List[ast.FunctionDef]:
        return [f for f in mod.functions() if self.is_step(f)]

    def recompute_functions(self, mod: astutil.Module
                            ) -> List[ast.FunctionDef]:
        return [f for f in mod.functions()
                if self._by_node.get(id(f)) in self.recompute]

    def fallback_functions(self, mod: astutil.Module
                           ) -> List[ast.FunctionDef]:
        """Builder-idiom candidates the lattice could not prove steps:
        inner defs of ``make_*`` builders whose flow is dynamic
        (``getattr``, computed dispatch, ...).  Analyzed at NOTE
        severity — a human should look, the tool cannot prove."""
        out = []
        for fn in mod.functions():
            if self.is_step(fn):
                continue
            parent = mod.parent(fn)
            if isinstance(parent, ast.FunctionDef) \
                    and parent.name.startswith("make_"):
                out.append(fn)
        return out

    def tainted_names(self, fn: ast.FunctionDef) -> Set[str]:
        """Device-tensor names within ``fn``.  For a function outside
        the step scopes (a fallback, a recompute scope), the same
        closure from its annotated parameters, its enclosing chain's
        taint and the tensors it makes itself."""
        idx = self._by_node.get(id(fn))
        if idx is None:
            return set()
        got = self._taints.get(idx)
        if got is not None:
            return set(got)
        info = self.funcs[idx]
        seeds = self._annotated_tensors(info)
        p = info.parent
        while p is not None:
            seeds |= self._taints.get(p, set())
            p = self.funcs[p].parent
        return self._local_taint(info, seeds)

    def eval_in(self, scope_node: Optional[ast.FunctionDef],
                mod: astutil.Module, expr: ast.expr) -> AVal:
        """Abstract value of ``expr`` as seen from inside
        ``scope_node`` (or module scope when None)."""
        scope: Optional[_Scope] = None
        if scope_node is not None:
            idx = self._by_node.get(id(scope_node))
            if idx is not None:
                scope = self._fn_scopes.get(idx)
        if scope is None:
            scope = self._mod_scopes.get(mod.path)
        if scope is None:
            return AVal()
        return self._eval(expr, scope, mod)

    def resolve_functions(self, scope_node: Optional[ast.FunctionDef],
                          mod: astutil.Module,
                          expr: ast.expr) -> List[FuncInfo]:
        """Function definitions an expression may reference, resolved
        through the dataflow lattice (same-module candidates first)."""
        val = self.eval_in(scope_node, mod, expr)
        infos = [self.funcs[i] for i in sorted(val.all_funcs())]
        infos.sort(key=lambda fi: (fi.module.path != mod.path,
                                   fi.index))
        return infos
