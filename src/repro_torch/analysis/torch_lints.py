"""Host-sync and recompute lints for eager torch (rule family JL).

The port's counterpart of ``repro.analysis.jax_lints``: the same ids and
severities, each rule re-read in the port's terms.  Eager torch has no
trace; what it has instead (``repro_torch.analysis.dataflow``):

  * **Step scopes** — the functions a loop calls once a step: a
    ``make_*`` builder's products (dicts, tuples, ``partial``, re-binds,
    a returned class instance's ``__call__``), what they nest and what
    they call.  Every kernel launch is queued on the card, so one host
    read of a device tensor there drains the queue every step; taint
    is the set of device tensors (never a positional parameter as such:
    ``int(state["step"])`` reads a Python int).
  * **Recompute scopes** — ``forward`` / ``backward`` of
    ``torch.autograd.Function`` subclasses and the functions
    ``torch.utils.checkpoint`` runs again: the forward and its
    recompute must agree, bit for bit where the remat contract says so.
  * **Tick paths** — methods of a class that defines ``tick`` (the
    serving scheduler): one explicit ``.cpu()`` a tick is the contract,
    an implicit read of a step's result is a hidden sync.

Rules:

  JL001  host sync (``.item()``/``.tolist()``/``.numpy()``/
         ``float``/``int``/``bool(t)``/``np.asarray``/``np.array``) on
         a device tensor inside a step scope; an explicit ``.cpu()`` is
         not an implicit sync
  JL002  implicit device->host transfer on a step's result in a tick
         path (read it once with an explicit ``.cpu()``)
  JL003  mutable closure capture read inside a recompute scope (the
         forward and the recompute may disagree)
  JL004  one seed (a ``fold_seed`` result) fed to ``manual_seed`` /
         ``torch.Generator`` more than once without a further
         ``fold_seed``: two linears draw the same plan stream
  JL005  Python ``if`` / ``while`` / ``assert`` / conditional
         expression on a device tensor in a step scope (a hidden sync)
  JL006  ``hash()`` feeds ``fold_seed``, ``manual_seed`` or
         ``torch.Generator`` (PYTHONHASHSEED makes streams differ
         across processes; use zlib.crc32)
  JL007  a device tensor that may carry autograd history (not
         ``.detach()``ed) stored, in a step scope, into a container
         that outlives it: it keeps the graph and its saved
         activations alive — the memory WTA-CRS exists to save
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import astutil, dataflow
from repro_torch.analysis.findings import (ERROR, NOTE, WARNING, Finding,
                                           register_rule)

JL001 = register_rule("JL001", ERROR,
                      "host sync on a device tensor inside a step scope")
JL002 = register_rule("JL002", WARNING,
                      "implicit device->host transfer in tick path")
JL003 = register_rule("JL003", WARNING,
                      "mutable closure capture in a recompute scope")
JL004 = register_rule("JL004", ERROR,
                      "seed fed to a generator more than once")
JL005 = register_rule("JL005", WARNING,
                      "Python branch on a device tensor")
JL006 = register_rule("JL006", ERROR,
                      "hash() feeds seed derivation")
JL007 = register_rule("JL007", WARNING,
                      "device tensor escapes to host state")

_SYNC_BUILTINS = ("float", "int", "bool")
_SYNC_CALLS = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")
_SYNC_METHODS = ("item", "tolist", "numpy")
_SEED_DERIVERS = ("fold_seed",)
_SEED_CONSUMERS = ("manual_seed", "Generator")
_SEED_PARAM_PREFIXES = ("key", "seed", "rng")

_HEURISTIC_TAG = " [heuristic: dynamic flow unresolved]"


def _leaf(node: ast.Call) -> str:
    return (astutil.call_name(node) or "").rsplit(".", 1)[-1]


# ---------------------------------------------------------------------------
# JL001 / JL005 — inside step scopes
# ---------------------------------------------------------------------------

def _check_step_scopes(mod: astutil.Module,
                       program: dataflow.Program) -> List[Finding]:
    out: List[Finding] = []
    for fn in program.step_functions(mod):
        out.extend(_scan_step(mod, fn, program, severity=""))
    # lattice-unresolved builder products: scan anyway, demoted to NOTE
    for fn in program.fallback_functions(mod):
        out.extend(_scan_step(mod, fn, program, severity=NOTE))
    return out


def _container_names(fn: ast.FunctionDef) -> Set[str]:
    """Names only ever bound to a display or a comprehension: their
    truth value is a length test on the host, whatever they hold."""
    kinds: Dict[str, bool] = {}
    displays = (ast.List, ast.Dict, ast.Set, ast.Tuple, ast.ListComp,
                ast.DictComp, ast.SetComp)
    for node in astutil.own_scope_nodes(fn):
        if isinstance(node, ast.Assign):
            made = isinstance(node.value, displays) or (
                isinstance(node.value, ast.Call)
                and astutil.call_name(node.value) in ("dict", "list"))
            for t in node.targets:
                if isinstance(t, ast.Name):
                    kinds[t.id] = kinds.get(t.id, True) and made
    return {n for n, ok in kinds.items() if ok}


def _device_test(test: ast.expr, taint: Set[str], containers: Set[str],
                 program: dataflow.Program) -> bool:
    if isinstance(test, ast.Name) and test.id in containers:
        return False
    if isinstance(test, ast.BoolOp):
        return any(_device_test(v, taint, containers, program)
                   for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _device_test(test.operand, taint, containers, program)
    return program.is_device(test, taint)


def _scan_step(mod: astutil.Module, fn: ast.FunctionDef,
               program: dataflow.Program, severity: str) -> List[Finding]:
    out: List[Finding] = []
    tag = _HEURISTIC_TAG if severity == NOTE else ""
    taint = program.tainted_names(fn)
    containers = _container_names(fn)
    for node in astutil.own_scope_nodes(fn):
        if isinstance(node, ast.Call):
            flagged = _sync_call(node, taint, program)
            if flagged:
                out.append(Finding(
                    rule="JL001", path=mod.path, line=node.lineno,
                    col=node.col_offset + 1,
                    symbol=mod.symbol_for(node), severity=severity,
                    message=f"{flagged} on a device tensor inside a step "
                            f"scope blocks the host until the card's "
                            f"queue drains, every step; keep it on the "
                            f"device, or read once with an explicit "
                            f".cpu(){tag}"))
        test = (node.test if isinstance(node, (ast.If, ast.While,
                                               ast.Assert, ast.IfExp))
                else None)
        if test is not None and _device_test(test, taint, containers,
                                             program):
            kind = {ast.If: "if", ast.While: "while", ast.Assert: "assert",
                    ast.IfExp: "conditional expression"}[type(node)]
            out.append(Finding(
                rule="JL005", path=mod.path, line=node.lineno,
                col=node.col_offset + 1, symbol=mod.symbol_for(node),
                severity=severity,
                message=f"Python `{kind}` on a device tensor reads it "
                        f"on the host: a hidden sync every step; use "
                        f"torch.where, or decide from host state{tag}"))
    return out


def _sync_call(node: ast.Call, taint: Set[str],
               program: dataflow.Program) -> Optional[str]:
    """The sync-ing callable's rendering, if this call reads a device
    tensor on the host."""
    name = astutil.call_name(node)
    if (isinstance(node.func, ast.Name)
            and node.func.id in _SYNC_BUILTINS and node.args
            and program.is_device(node.args[0], taint)):
        return f"{node.func.id}()"
    if name in _SYNC_CALLS and node.args \
            and program.is_device(node.args[0], taint):
        return name
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and program.is_device(node.func.value, taint)):
        return f".{node.func.attr}()"
    return None


# ---------------------------------------------------------------------------
# JL002 — tick-path implicit transfers
# ---------------------------------------------------------------------------

def _stepfn_call(node: ast.AST) -> bool:
    """Calls of self._*fn / *_fn attributes — the cached step functions
    by naming convention (fallback when dataflow cannot resolve)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr.endswith("_fn"):
        return True
    if isinstance(fn, ast.Name) and fn.id.endswith("_fn"):
        return True
    # self._prefill_fn(n)(...) — call of a getter's result
    if isinstance(fn, ast.Call):
        return _stepfn_call(fn)
    return False


def _resolved_step_call(node: ast.AST, mod: astutil.Module,
                        method: ast.FunctionDef,
                        program: dataflow.Program) -> bool:
    """Dataflow resolution: does this call's callee reference a step
    scope (a builder product, however the attribute holding it is
    named)?"""
    if not isinstance(node, ast.Call):
        return False
    for info in program.resolve_functions(method, mod, node.func):
        if info.index in program.steps:
            return True
    if isinstance(node.func, ast.Call):
        return _resolved_step_call(node.func, mod, method, program)
    return False


def _check_tick_paths(mod: astutil.Module,
                      program: dataflow.Program) -> List[Finding]:
    out: List[Finding] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        if not any(m.name == "tick" for m in methods):
            continue
        for m in methods:
            out.extend(_scan_tick_method(mod, m, program))
    return out


def _scan_tick_method(mod: astutil.Module, fn: ast.FunctionDef,
                      program: dataflow.Program) -> List[Finding]:
    device: Set[str] = set()
    out: List[Finding] = []

    def bind(target: ast.expr, from_step: bool) -> None:
        if isinstance(target, ast.Name):
            (device.add if from_step else device.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                bind(e, from_step)

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Assign):
            visit(node.value)
            from_step = (_stepfn_call(node.value)
                         or _resolved_step_call(node.value, mod, fn,
                                                program))
            for t in node.targets:
                bind(t, from_step)
            return
        if isinstance(node, ast.Call):
            hit = _sync_call(node, device, program)
            if hit:
                out.append(Finding(
                    rule="JL002", path=mod.path, line=node.lineno,
                    col=node.col_offset + 1,
                    symbol=mod.symbol_for(node),
                    message=f"{hit} on a step's result hides a blocking "
                            f"device->host sync in the tick path; fetch "
                            f"once with an explicit .cpu()"))
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in fn.body:
        visit(stmt)
    return out


# ---------------------------------------------------------------------------
# JL003 / JL007 — recompute captures and host-state escapes
# ---------------------------------------------------------------------------

_MUTATORS = ("append", "extend", "add", "update", "setdefault", "pop",
             "insert", "remove", "clear")
_ESCAPE_STORES = ("append", "extend", "add", "update", "setdefault",
                  "insert")
_MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)


def _detached(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "detach"
               for n in ast.walk(node))


def _check_escapes(mod: astutil.Module,
                   program: dataflow.Program) -> List[Finding]:
    out: List[Finding] = []
    imported = _imported_names(mod)
    for fn in program.step_functions(mod):
        out.extend(_scan_escapes(mod, fn, program, imported, severity=""))
    for fn in program.fallback_functions(mod):
        out.extend(_scan_escapes(mod, fn, program, imported,
                                 severity=NOTE))
    return out


def _scan_escapes(mod: astutil.Module, fn: ast.FunctionDef,
                  program: dataflow.Program, imported: Set[str],
                  severity: str) -> List[Finding]:
    """JL007: a device tensor with its history stored into an outliving
    container (an enclosing scope's mutable binding, a name the function
    does not bind, or ``self.<attr>``)."""
    out: List[Finding] = []
    tag = _HEURISTIC_TAG if severity == NOTE else ""
    mutable = _ancestor_mutable_bindings(mod, fn)
    local = _local_names(fn)
    taint = program.tainted_names(fn)
    for node in astutil.own_scope_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in _ESCAPE_STORES):
            continue
        if isinstance(f.value, ast.Name) and f.value.id in imported:
            continue  # a module's function (``optim_lib.update``)
        stored = list(node.args) + [kw.value for kw in node.keywords]
        if not any(program.is_device(a, taint) and not _detached(a)
                   for a in stored):
            continue
        target = f.value
        tgt_name: Optional[str] = None
        if isinstance(target, ast.Name):
            if target.id in local and target.id not in mutable:
                continue  # fn-local scratch container: dies with the step
            tgt_name = target.id
        elif not (isinstance(target, ast.Attribute)
                  and isinstance(target.value, ast.Name)
                  and target.value.id == "self"):
            continue
        where = tgt_name or astutil.dotted(target) or "container"
        out.append(Finding(
            rule="JL007", path=mod.path, line=node.lineno,
            col=node.col_offset + 1, symbol=mod.symbol_for(node),
            severity=severity,
            message=f".{f.attr}() stores a device tensor with its "
                    f"autograd history into {where!r}, host state that "
                    f"outlives the step: it keeps the graph and its saved "
                    f"activations alive; store .detach() (or return it "
                    f"from the step){tag}"))
    return out


def _imported_names(mod: astutil.Module) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def _check_captures(mod: astutil.Module,
                    program: dataflow.Program) -> List[Finding]:
    out: List[Finding] = []
    for fn in program.recompute_functions(mod):
        out.extend(_scan_captures(mod, fn))
    return out


def _scan_captures(mod: astutil.Module,
                   fn: ast.FunctionDef) -> List[Finding]:
    """JL003: a mutable binding of an enclosing function scope read
    inside a recompute scope (one finding per name)."""
    out: List[Finding] = []
    mutable = _ancestor_mutable_bindings(mod, fn)
    local = _local_names(fn)
    seen: Set[str] = set()
    for node in sorted((n for n in astutil.own_scope_nodes(fn)
                        if isinstance(n, ast.Name)),
                       key=lambda n: (n.lineno, n.col_offset)):
        if not (isinstance(node.ctx, ast.Load)
                and node.id in mutable
                and node.id not in local
                and node.id not in seen):
            continue
        seen.add(node.id)
        out.append(Finding(
            rule="JL003", path=mod.path, line=node.lineno,
            col=node.col_offset + 1, symbol=mod.symbol_for(node),
            message=f"recompute scope captures mutable state "
                    f"{node.id!r} ({mutable[node.id]}); the backward runs "
                    f"it again, and a change in between makes the "
                    f"recompute disagree with the forward; capture an "
                    f"immutable snapshot (a tuple)"))
    return out


def _ancestor_mutable_bindings(mod: astutil.Module,
                               fn: ast.FunctionDef) -> Dict[str, str]:
    """Mutable bindings of every enclosing function scope (module-level
    tables are the codebase's static-config idiom)."""
    out: Dict[str, str] = {}
    cur = mod.parent(fn)
    while cur is not None:
        if isinstance(cur, ast.FunctionDef):
            for name, why in _mutable_bindings(cur).items():
                out.setdefault(name, why)
        cur = mod.parent(cur)
    return out


def _mutable_bindings(scope: ast.FunctionDef) -> Dict[str, str]:
    """Scope-level names bound to mutable displays or mutated."""
    out: Dict[str, str] = {}
    for sub in astutil.own_scope_nodes(scope):
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name) and isinstance(
                        sub.value, _MUTABLE_DISPLAYS):
                    out[t.id] = "a mutable literal"
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATORS
                and isinstance(sub.func.value, ast.Name)):
            out[sub.func.value.id] = "mutated in the enclosing scope"
        if isinstance(sub, ast.AugAssign) and isinstance(
                sub.target, ast.Name):
            out.setdefault(sub.target.id, "mutated in the enclosing scope")
    return out


def _local_names(fn: ast.FunctionDef) -> Set[str]:
    names = {a.arg for a in fn.args.posonlyargs + fn.args.args
             + fn.args.kwonlyargs}
    for extra in (fn.args.vararg, fn.args.kwarg):
        if extra is not None:
            names.add(extra.arg)
    for node in astutil.own_scope_nodes(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
    return names


# ---------------------------------------------------------------------------
# JL004 — seed reuse
# ---------------------------------------------------------------------------

def _branch_path(mod: astutil.Module,
                 node: ast.AST) -> Tuple[Tuple[int, str], ...]:
    """(if-node id, arm) ancestry — used to prove mutual exclusion."""
    path = []
    child, cur = node, mod.parent(node)
    while cur is not None:
        if isinstance(cur, ast.If):
            arm = "body"
            for n in cur.orelse:
                if child is n or any(id(child) == id(x)
                                     for x in ast.walk(n)):
                    arm = "orelse"
                    break
            path.append((id(cur), arm))
        child, cur = cur, mod.parent(cur)
    return tuple(reversed(path))


def _exclusive(mod, a: ast.AST, b: ast.AST) -> bool:
    pa, pb = _branch_path(mod, a), _branch_path(mod, b)
    for (ia, arma), (ib, armb) in zip(pa, pb):
        if ia == ib and arma != armb:
            return True
    return False


def _seed_name(arg: ast.expr) -> Optional[str]:
    """The seed a consumer's argument names: ``k`` or ``int(k)``."""
    while (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
           and arg.func.id == "int" and len(arg.args) == 1):
        arg = arg.args[0]
    return arg.id if isinstance(arg, ast.Name) else None


def _check_seed_reuse(mod: astutil.Module) -> List[Finding]:
    out: List[Finding] = []
    for fn in mod.functions():
        seeds = {a.arg for a in fn.args.args + fn.args.kwonlyargs
                 if a.arg.startswith(_SEED_PARAM_PREFIXES)}
        binds: Dict[str, List[int]] = {}
        for sub in astutil.own_scope_nodes(fn):
            if isinstance(sub, ast.Assign):
                derived = (isinstance(sub.value, ast.Call)
                           and _leaf(sub.value) in _SEED_DERIVERS)
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        binds.setdefault(t.id, []).append(sub.lineno)
                        if derived:
                            seeds.add(t.id)
        if not seeds:
            continue
        uses: Dict[str, List[ast.Call]] = {}
        for sub in astutil.own_scope_nodes(fn):
            if not isinstance(sub, ast.Call) \
                    or _leaf(sub) not in _SEED_CONSUMERS or not sub.args:
                continue
            name = _seed_name(sub.args[0])
            if name in seeds:
                uses.setdefault(name, []).append(sub)
        for key, calls in uses.items():
            calls.sort(key=lambda c: (c.lineno, c.col_offset))
            conflicting = [
                (a, b) for i, a in enumerate(calls) for b in calls[i + 1:]
                if not _exclusive(mod, a, b)
                and not any(a.lineno < ln <= b.lineno
                            for ln in binds.get(key, ()))]
            if conflicting:
                a, b = conflicting[0]
                out.append(Finding(
                    rule="JL004", path=mod.path, line=b.lineno,
                    col=b.col_offset + 1, symbol=mod.symbol_for(b),
                    message=f"seed {key!r} seeds a generator here and at "
                            f"line {a.lineno} without a fold_seed in "
                            f"between: the two draw the same stream "
                            f"(two linears, one plan)"))
    return out


# ---------------------------------------------------------------------------
# JL006 — hash() into seed derivation
# ---------------------------------------------------------------------------

def _check_hash_seeds(mod: astutil.Module) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or _leaf(node) not in (
                _SEED_DERIVERS + _SEED_CONSUMERS):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id == "hash"):
                    out.append(Finding(
                        rule="JL006", path=mod.path, line=sub.lineno,
                        col=sub.col_offset + 1,
                        symbol=mod.symbol_for(node),
                        message="hash() feeds a seed: str/bytes hashes "
                                "are randomized per process "
                                "(PYTHONHASHSEED), so the stream is not "
                                "reproducible across runs or ranks; use "
                                "zlib.crc32 of the encoded string"))
    return out


def check(modules: Iterable[astutil.Module],
          program: Optional[dataflow.Program] = None) -> List[Finding]:
    mods = list(modules)
    if program is None:
        program = dataflow.Program.build(mods)
    out: List[Finding] = []
    for mod in mods:
        out.extend(_check_step_scopes(mod, program))
        out.extend(_check_tick_paths(mod, program))
        out.extend(_check_escapes(mod, program))
        out.extend(_check_captures(mod, program))
        out.extend(_check_seed_reuse(mod))
        out.extend(_check_hash_seeds(mod))
    return out
