"""CUDA kernel contract checker (rule family PK).

The port's counterpart of ``repro.analysis.pallas_contracts``: the same
ids and severities, each contract read off the hand-written CUDA C++
kernels (``kernels/csrc``) through the source model of
:mod:`repro_torch.analysis.csrc` — launch sites instead of
``pl.pallas_call``, ``__shared__`` instead of VMEM, PTX instead of
``jnp.dot``.  Calls are followed through ``#include``d headers, so a
contract kept in a ``__device__`` helper of ``hopper.cuh`` (the async
copies, the tensor-core products) counts for the kernel that calls it.

  PK001  an ``extern "C"`` entry point's arity or parameter types
         differ from its entry in ``kernels/_build.py::_SIGNATURES``
         (pointer <-> ``c_void_p``, ``int`` <-> ``c_int``): ctypes
         would pass the arguments in the wrong slots or cut a pointer
  PK002  a launch's threads a block exceed the kernel's
         ``__launch_bounds__`` at that instance: the launch is refused
  PK003  a grid from a truncating ``/`` of a dimension by a tile with
         no ``%`` check that returns an error in the launcher or the
         entry points above it: the remainder rows are silently dropped
         (a biased estimator)
  PK004  static + dynamic shared bytes at a launch exceed the budget
         (default 232,448: the opt-in limit a block on sm_90), or more
         than 48 KB dynamic with no ``cudaFuncSetAttribute(...,
         cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` for that
         kernel
  PK005  ``wmma::fragment<wmma::accumulator, ..., T>`` with ``T`` not
         ``float``, or ``mma.sync`` / ``wgmma.mma_async`` PTX whose D
         type is not ``.f32``: the f32-accumulation contract of the
         estimator path
  PK006  unpaired asynchronous operations in a kernel, after following
         its calls: ``mbarrier.arrive.expect_tx`` without
         ``mbarrier.try_wait`` / ``test_wait``, ``cp.async.commit_group``
         without ``cp.async.wait_group`` / ``wait_all``,
         ``cp.async.bulk.commit_group`` without
         ``cp.async.bulk.wait_group``, ``wgmma.commit_group`` without
         ``wgmma.wait_group`` — and each converse
  PK007  a ceil-div grid (``(n + B - 1) / B`` or a ``cdiv`` helper)
         whose kernel has no bound test against that dimension, or a
         kernel that zeroes a tail by multiplying with a 0/1 mask
         instead of selecting (0 * garbage can be NaN)

Numbers are evaluated at every instance a launcher is called with
(template arguments substituted); a size that stays a runtime value is
counted unresolved, never guessed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import astutil, csrc
from repro_torch.analysis.findings import (ERROR, WARNING, Finding,
                                           register_rule)

PK001 = register_rule("PK001", ERROR,
                      "extern \"C\" entry point mismatches its ctypes "
                      "signature")
PK002 = register_rule("PK002", ERROR,
                      "launch block exceeds the kernel's __launch_bounds__")
PK003 = register_rule("PK003", ERROR,
                      "/-derived grid without divisibility guard")
PK004 = register_rule("PK004", WARNING,
                      "shared memory at a launch exceeds budget")
PK005 = register_rule("PK005", ERROR,
                      "kernel matmul without f32 accumulation")
PK006 = register_rule("PK006", ERROR,
                      "unpaired async copy / wgmma commit and wait in "
                      "kernel")
PK007 = register_rule("PK007", ERROR,
                      "cdiv (ragged) grid without kernel tail guards")

# the opt-in shared memory a block on sm_90 (227 KB)
DEFAULT_SMEM_BUDGET = 232448
DEFAULT_DYNAMIC_LIMIT = 48 * 1024
_CMP = frozenset(("<", "<=", ">", ">="))
_CTYPES = {"pointer": "c_void_p", "int": "c_int", "unsigned": "c_uint",
           "float": "c_float", "double": "c_double",
           "long long": "c_longlong", "int64_t": "c_int64",
           "size_t": "c_size_t", "bool": "c_bool"}
_CTYPES_SAME = {"c_int32": "c_int", "c_int64": "c_longlong",
                "c_uint32": "c_uint", "c_long": "c_longlong"}
# (start, its completions): an async operation and the waits that end it
_PAIRS = (
    ("mbarrier.arrive.expect_tx", ("mbarrier.try_wait",
                                   "mbarrier.test_wait")),
    ("cp.async.commit_group", ("cp.async.wait_group",
                               "cp.async.wait_all")),
    ("cp.async.bulk.commit_group", ("cp.async.bulk.wait_group",)),
    ("wgmma.commit_group", ("wgmma.wait_group",)),
)
_CEIL = re.compile(r"\(\s*([^()]+?)\s*\+\s*([^()]+?)\s*-\s*1\s*\)\s*/")


def _text(toks: Sequence[csrc.Token]) -> str:
    return " ".join(t.text for t in toks)


# ---------------------------------------------------------------------------
# launch instances
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaunchInstance:
    """One launch site at one instance of its launcher."""

    launcher: csrc.Function
    launch: csrc.Launch
    kernel: Optional[csrc.Function]
    desc: str                      # kernel<dtype, ints...>
    threads: Optional[int]
    bound: Optional[int]           # __launch_bounds__ max threads
    static: Optional[int]
    dynamic: Optional[int]


def instances(prog: csrc.Program, fn: csrc.Function,
              depth: int = 0) -> List[csrc.Evaluator]:
    """Evaluators for ``fn``'s body at every instance its callers name
    (explicit template arguments, evaluated in each caller instance)."""
    if not fn.tparams:
        return [csrc.Evaluator(prog, fn.path, fn=fn)]
    if depth > 5:
        return []
    out: Dict[tuple, csrc.Evaluator] = {}
    for caller, call in prog.callers(fn):
        if len(call.targs) != len(fn.tparams):
            continue
        for cev in instances(prog, caller, depth + 1):
            ev = cev.bind(fn, call.targs)
            key = (tuple(sorted(ev.types.items())),
                   tuple(sorted((k, v) for k, v in ev.ints.items()
                                if isinstance(v, int))))
            out.setdefault(key, ev)
    return list(out.values())


def _threads(ev: csrc.Evaluator, toks: List[csrc.Token]) -> Optional[int]:
    """Threads of a block expression (an int or a ``dim3(...)``)."""
    if len(toks) > 2 and toks[0].text == "dim3" and toks[1].text == "(":
        total = 1
        for part in csrc._split_commas(toks[2:-1]):
            v = ev.eval(part)
            if v is None:
                return None
            total *= v
        return total
    return ev.eval(toks)


def _instance_desc(kernel: csrc.Function, kev: csrc.Evaluator) -> str:
    parts = []
    for kind, name in kernel.tparams:
        if kind == "type":
            ctype = kev.types.get(name, name)
            parts.append({v: k for k, v in csrc.DTYPES.items()
                          if len(k) <= 4}.get(ctype, ctype))
        else:
            v = kev.ints.get(name)
            parts.append(str(v) if isinstance(v, int) else name)
    return f"{kernel.name}<{', '.join(parts)}>" if parts else kernel.name


def resolve_launches(prog: csrc.Program) -> List[LaunchInstance]:
    out = []
    for fn in prog.functions():
        if not fn.launches:
            continue
        for ev in instances(prog, fn):
            for ln in fn.launches:
                kernel = prog.kernel(ln.kernel)
                if kernel is None:
                    out.append(LaunchInstance(fn, ln, None, ln.kernel,
                                              None, None, None, None))
                    continue
                kev = ev.bind(kernel, ln.targs)
                bound = None
                if kernel.launch_bounds:
                    lb = csrc._split_commas(kernel.launch_bounds)
                    bound = kev.eval(lb[0]) if lb else None
                static = csrc.shared_bytes(kev, kernel)
                if static is not None:
                    for g in prog.reached(kernel)[1:]:
                        if g.shared:
                            sub = csrc.shared_bytes(csrc.Evaluator(
                                prog, g.path, kev.types), g)
                            static = None if sub is None else static + sub
                out.append(LaunchInstance(
                    fn, ln, kernel, _instance_desc(kernel, kev),
                    _threads(ev, ln.block), bound, static,
                    ev.eval(ln.smem) if ln.smem else 0))
    return out


# ---------------------------------------------------------------------------
# PK001 — entry points against their ctypes signatures
# ---------------------------------------------------------------------------

def _ctype_of(ty: List[csrc.Token]) -> str:
    words = [t.text for t in ty if t.text not in ("const", "volatile",
                                                  "__restrict__")]
    if "*" in words or "&" in words:
        return "c_void_p"
    spelled = " ".join(words)
    return _CTYPES.get(spelled, _CTYPES.get(words[-1] if words else "",
                                            spelled))


def extract_signatures(modules: Iterable[astutil.Module]
                       ) -> Dict[str, Tuple[astutil.Module, int, List[str]]]:
    """``_SIGNATURES`` tables: C name -> (module, line, ctypes leaves),
    resolving module-level aliases (``_P, _I = ctypes.c_void_p, ...``)."""
    out: Dict[str, Tuple[astutil.Module, int, List[str]]] = {}
    for mod in modules:
        alias: Dict[str, str] = {}
        table = None
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "_SIGNATURES" \
                        and isinstance(node.value, ast.Dict):
                    table = node.value
                elif isinstance(tgt, ast.Name):
                    name = astutil.dotted(node.value)
                    if name:
                        alias[tgt.id] = name
                elif isinstance(tgt, ast.Tuple) and isinstance(
                        node.value, ast.Tuple):
                    for t, v in zip(tgt.elts, node.value.elts):
                        name = astutil.dotted(v)
                        if isinstance(t, ast.Name) and name:
                            alias[t.id] = name
        if table is None:
            continue
        for k, v in zip(table.keys, table.values):
            if not (isinstance(k, ast.Constant) and isinstance(
                    v, (ast.Tuple, ast.List))):
                continue
            leaves = []
            for e in v.elts:
                name = astutil.dotted(e) or "?"
                name = alias.get(name, name)
                leaf = name.rsplit(".", 1)[-1]
                leaves.append(_CTYPES_SAME.get(leaf, leaf))
            out[k.value] = (mod, k.lineno, leaves)
    return out


def _check_signatures(prog: csrc.Program,
                      signatures: Dict[str, Tuple[astutil.Module, int,
                                                  List[str]]]
                      ) -> List[Finding]:
    out: List[Finding] = []
    for fn in prog.functions():
        if not fn.extern_c or fn.name not in signatures:
            continue
        mod, line, want = signatures[fn.name]
        got = [_ctype_of(ty) for ty, _ in fn.params]
        if got == want:
            continue
        if len(got) != len(want):
            what = (f"takes {len(got)} arguments but "
                    f"{mod.path}:{line} declares {len(want)}")
        else:
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            what = (f"argument {i} ({fn.params[i][1]!r}) is {got[i]} but "
                    f"{mod.path}:{line} declares {want[i]}")
        out.append(Finding(
            rule="PK001", path=fn.path, line=fn.line, col=1, symbol=fn.name,
            message=f"extern \"C\" {fn.name} {what}: ctypes passes the "
                    f"arguments by the declared types, so a wrong slot "
                    f"or a cut pointer reaches the kernel"))
    return out


# ---------------------------------------------------------------------------
# PK002 / PK004 — block size and shared memory at each launch
# ---------------------------------------------------------------------------

def _check_launches(prog: csrc.Program, launches: List[LaunchInstance],
                    budget: int) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()

    def emit(rule: str, li: LaunchInstance, message: str) -> None:
        key = (li.launch.path, li.launch.line, rule)
        if key in seen:
            return
        seen.add(key)
        out.append(Finding(rule=rule, path=li.launch.path,
                           line=li.launch.line, col=1,
                           symbol=li.launcher.name, message=message))

    for li in launches:
        if li.kernel is None:
            continue
        if li.threads is not None and li.bound is not None \
                and li.threads > li.bound:
            emit("PK002", li,
                 f"{li.desc} is launched with {li.threads} threads a "
                 f"block but its __launch_bounds__ allow {li.bound}: the "
                 f"launch fails (too many resources requested)")
        if li.static is not None and li.dynamic is not None \
                and li.static + li.dynamic > budget:
            emit("PK004", li,
                 f"{li.desc} needs {li.static} static + {li.dynamic} "
                 f"dynamic = {li.static + li.dynamic} bytes of shared "
                 f"memory a block, over the {budget}-byte budget; "
                 f"shrink the tile or the ring")
        if li.dynamic is not None and li.dynamic > DEFAULT_DYNAMIC_LIMIT \
                and not any(k == li.kernel.name
                            for k, _, _ in li.launcher.smem_attrs):
            emit("PK004", li,
                 f"{li.desc} asks for {li.dynamic} bytes of dynamic shared "
                 f"memory, over the 48 KB default, and {li.launcher.name} "
                 f"sets no cudaFuncAttributeMaxDynamicSharedMemorySize "
                 f"for it: the launch is refused")
    return out


# ---------------------------------------------------------------------------
# PK003 / PK007 — grids and their guards
# ---------------------------------------------------------------------------

def _resolved_grid(fn: csrc.Function, toks: List[csrc.Token],
                   depth: int = 0) -> List[csrc.Token]:
    """The grid expression with the launcher's local names (``grid``,
    ``blocks``, ``geo.items``) replaced by their definitions."""
    if depth > 4:
        return toks
    out: List[csrc.Token] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        dotted = None
        if i + 2 < len(toks) and toks[i + 1].text == "." \
                and t.kind == "id":
            dotted = f"{t.text}.{toks[i + 2].text}"
        if dotted and dotted in fn.locals and (
                i == 0 or toks[i - 1].text != "."):
            out.append(csrc.Token("op", "(", t.line))
            out.extend(_resolved_grid(fn, fn.locals[dotted], depth + 1))
            out.append(csrc.Token("op", ")", t.line))
            i += 3
            continue
        if t.kind == "id" and t.text in fn.locals and (
                i == 0 or toks[i - 1].text not in (".", "->")):
            out.append(csrc.Token("op", "(", t.line))
            out.extend(_resolved_grid(fn, fn.locals[t.text], depth + 1))
            out.append(csrc.Token("op", ")", t.line))
            i += 1
            continue
        out.append(t)
        i += 1
    return out


def _ceil_dims(prog: csrc.Program, fn: csrc.Function,
               grid: List[csrc.Token]) -> List[str]:
    """Dimensions a grid ceil-divides: ``cdiv(n, B)`` or
    ``(n + B - 1) / B``."""
    dims = []
    for i, t in enumerate(grid):
        if t.kind == "id" and re.search(r"cdiv|ceil_div|div_up", t.text) \
                and i + 1 < len(grid) and grid[i + 1].text == "(":
            end = csrc._match(grid, i + 1)
            args = csrc._split_commas(grid[i + 2:end - 1])
            if args:
                dims.append(_text(args[0]))
    dims += [m.group(1) for m in _CEIL.finditer(_text(grid))]
    return dims


def _floor_dims(grid: List[csrc.Token]) -> List[str]:
    """Numerators of truncating ``/`` (not a ceil-div's)."""
    text = _CEIL.sub("CEIL", _text(grid))
    return [m.group(1) for m in re.finditer(
        r"([A-Za-z_][\w. ]*?)\s*/\s*[A-Za-z_0-9(]", text)
        if "CEIL" not in m.group(1)]


def _has_mod_guard(prog: csrc.Program, fn: csrc.Function) -> bool:
    """An ``if (... % ...) return ...;`` (or a call of a helper whose
    body tests ``%``) in ``fn`` or any function above it in its unit."""
    todo, seen = [fn], set()
    while todo:
        f = todo.pop()
        if id(f) in seen:
            continue
        seen.add(id(f))
        body = f.body
        for i, t in enumerate(body):
            if t.text != "if" or i + 1 >= len(body) \
                    or body[i + 1].text != "(":
                continue
            end = csrc._match(body, i + 1)
            cond = body[i + 2:end - 1]
            if end < len(body) and body[end].text == "{":
                stmt = body[end:csrc._match(body, end, "{", "}")]
            else:
                j = end
                while j < len(body) and body[j].text != ";":
                    j += 1
                stmt = body[end:j]
            if "return" not in [s.text for s in stmt]:
                continue
            if "%" in [c.text for c in cond]:
                return True
            for c in cond:
                if c.kind == "id" and any(
                        "%" in [x.text for x in g.body]
                        for g in prog.functions(f.path, c.text)):
                    return True
        todo.extend(g for g, _ in prog.callers(f))
    return False


def _bound_tested(prog: csrc.Program, fn: csrc.Function, param: str,
                  depth: int = 0) -> bool:
    """Whether ``param`` of ``fn`` meets a comparison in ``fn`` or in a
    helper it is handed to."""
    body = fn.body
    for i, t in enumerate(body):
        if t.text != param or t.kind != "id" or (
                i > 0 and body[i - 1].text in (".", "->")):
            continue
        after = i + 1
        while after + 1 < len(body) and body[after].text in (".", "->"):
            after += 2
        if (i > 0 and body[i - 1].text in _CMP) or (
                after < len(body) and body[after].text in _CMP):
            return True
    if depth >= 3:
        return False
    for call in fn.calls:
        for j, arg in enumerate(call.args):
            if param not in [a.text for a in arg]:
                continue
            for g in prog.functions(fn.path, call.name):
                if j < len(g.params) and _bound_tested(
                        prog, g, g.params[j][1], depth + 1):
                    return True
    return False


def _tensor_map_extent(prog: csrc.Program, fn: csrc.Function,
                       ids: Set[str]) -> bool:
    """Whether ``fn`` hands the dimension to a tensor-map encoder: a TMA
    copy through that map reads zeros and writes nothing past it."""
    for call in fn.calls:
        if not any(ids & {a.text for a in arg} for arg in call.args):
            continue
        for g in prog.functions(fn.path, call.name):
            if any(c.name in ("tensor_map_encoder", "cuTensorMapEncodeTiled")
                   for c in g.calls):
                return True
    return False


def _mask_multiply(body: List[csrc.Token]) -> Optional[int]:
    """Line of a multiply by a 0/1 mask (``x * (i < n)``,
    ``(float)(ok) * x``, ``x * (ok ? 1.f : 0.f)``)."""

    def is_mask(group: List[csrc.Token]) -> bool:
        depth, top = 0, []
        for t in group:
            if t.text in ("(", "["):
                depth += 1
            elif t.text in (")", "]"):
                depth -= 1
            elif depth == 0:
                top.append(t)
        words = [t.text for t in top]
        if "?" in words:
            q = words.index("?")
            arms = [t for t in top[q + 1:] if t.text != ":"]
            return len(arms) == 2 and all(
                t.kind == "num" and re.fullmatch(r"[01](\.0*)?[fF]?", t.text)
                for t in arms)
        return any(w in _CMP or w in ("==", "!=") for w in words)

    for i, t in enumerate(body):
        if t.text != "*" or i == 0 or not (
                body[i - 1].kind in ("id", "num")
                or body[i - 1].text in (")", "]")):
            continue
        j = i + 1
        if j < len(body) and body[j].text == "(":
            end = csrc._match(body, j)
            inner = [x.text for x in body[j + 1:end - 1]]
            if inner and all(w in csrc._CASTS for w in inner) \
                    and end < len(body) and body[end].text == "(":
                j = end
            end = csrc._match(body, j)
            if is_mask(body[j + 1:end - 1]):
                return t.line
        if body[i - 1].text == ")":
            depth, k = 0, i - 1
            while k >= 0:
                if body[k].text == ")":
                    depth += 1
                elif body[k].text == "(":
                    depth -= 1
                    if depth == 0:
                        break
                k -= 1
            if k >= 0 and is_mask(body[k + 1:i - 1]):
                return t.line
    return None


def _check_grids(prog: csrc.Program) -> List[Finding]:
    out: List[Finding] = []
    for fn in prog.functions():
        for ln in fn.launches:
            kernel = prog.kernel(ln.kernel)
            grid = _resolved_grid(fn, ln.grid)
            floors = _floor_dims(grid)
            if floors and not _has_mod_guard(prog, fn):
                out.append(Finding(
                    rule="PK003", path=ln.path, line=ln.line, col=1,
                    symbol=fn.name,
                    message=f"the grid of {ln.kernel} truncates "
                            f"{', '.join(floors)} by a tile, and neither "
                            f"{fn.name} nor an entry point above it "
                            f"returns an error on a % remainder: the "
                            f"last rows are silently dropped (a biased "
                            f"estimator)"))
            if kernel is None:
                continue
            missing = []
            for dim in dict.fromkeys(_ceil_dims(prog, fn, grid)):
                ids = set(re.findall(r"[A-Za-z_]\w*", dim))
                if _tensor_map_extent(prog, fn, ids):
                    continue          # TMA clips at the map's extent
                params = [kernel.params[j][1]
                          for j, arg in enumerate(ln.args)
                          if j < len(kernel.params)
                          and ids & {a.text for a in arg}]
                if not any(_bound_tested(prog, kernel, p) for p in params):
                    missing.append(dim)
            if missing:
                out.append(Finding(
                    rule="PK007", path=ln.path, line=ln.line, col=1,
                    symbol=fn.name,
                    message=f"the grid of {ln.kernel} ceil-divides "
                            f"{', '.join(missing)}, but the kernel tests "
                            f"no index against it: the tail block reads "
                            f"and writes out of bounds"))
    for kernel in prog.kernels():
        for g in prog.reached(kernel):
            line = _mask_multiply(g.body)
            if line is not None:
                out.append(Finding(
                    rule="PK007", path=g.path, line=line, col=1,
                    symbol=g.name,
                    message=f"{g.name} (reached from {kernel.name}) "
                            f"zeroes a tail by multiplying with a 0/1 "
                            f"mask: 0 * garbage can be NaN; select the "
                            f"value (a ternary or a predicated load) "
                            f"instead"))
    return out


# ---------------------------------------------------------------------------
# PK005 / PK006 — what a kernel reaches
# ---------------------------------------------------------------------------

def _mma_dtype(ptx: str) -> Optional[Tuple[str, str]]:
    """(instruction, D type) of an ``mma.sync`` / ``wgmma.mma_async``."""
    # no word boundary: an asm string's escapes run into the mnemonic
    # ("...;\\nwgmma.mma_async...")
    m = re.search(r"(wgmma\.mma_async|mma\.sync)[\w.]*?\.(m\d+n\d+k\d+)"
                  r"((?:\.\w+)+)", ptx)
    if m is None:
        return None
    parts = [p for p in m.group(3).split(".") if p and p not in (
        "row", "col", "satfinite")]
    return m.group(1), (parts[0] if parts else "?")


def _check_reached(prog: csrc.Program) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for kernel in prog.kernels():
        reached = prog.reached(kernel)
        ptx = [(s, line, g) for g in reached for s, line in g.asm]
        for s, line, g in ptx:
            got = _mma_dtype(s)
            if got is None or got[1] == "f32" or (g.path, line) in seen:
                continue
            seen.add((g.path, line))
            out.append(Finding(
                rule="PK005", path=g.path, line=line, col=1, symbol=g.name,
                message=f"{got[0]} in {g.name} (reached from "
                        f"{kernel.name}) accumulates in .{got[1]}, not "
                        f".f32: the estimator path's f32-accumulation "
                        f"contract"))
        for g in reached:
            b = g.body
            for i, t in enumerate(b):
                if t.text != "accumulator" or i < 2 \
                        or b[i - 1].text != "::":
                    continue
                j = i
                while j < len(b) and b[j].text not in (">", ">>"):
                    j += 1
                ty = b[j - 1].text if j < len(b) else "?"
                if ty != "float" and (g.path, t.line) not in seen:
                    seen.add((g.path, t.line))
                    out.append(Finding(
                        rule="PK005", path=g.path, line=t.line, col=1,
                        symbol=g.name,
                        message=f"a wmma accumulator fragment of {ty} in "
                                f"{g.name}: products accumulate in {ty}, "
                                f"not float"))
        text = "\n".join(s for s, _, _ in ptx)
        for start, waits in _PAIRS:
            has_start = _count(text, start) > 0
            has_wait = any(_count(text, w) > 0 for w in waits)
            if has_start == has_wait:
                continue
            present, missing = ((start, " / ".join(waits)) if has_start
                                else (" / ".join(waits), start))
            out.append(Finding(
                rule="PK006", path=kernel.path, line=kernel.line, col=1,
                symbol=kernel.name,
                message=f"kernel {kernel.name} issues {present} but never "
                        f"{missing} (following its calls): an unawaited "
                        f"copy or product races the code that reads its "
                        f"result; a wait with nothing started hangs"))
    return out


def _count(text: str, op: str) -> int:
    return len(re.findall(re.escape(op) + r"(?![\w])", text)) + len(
        re.findall(re.escape(op) + r"\.", text))


def check(modules: Iterable[astutil.Module], sources: csrc.Program,
          smem_budget: Optional[int] = None) -> List[Finding]:
    if smem_budget is None:
        smem_budget = DEFAULT_SMEM_BUDGET
    out = _check_signatures(sources, extract_signatures(modules))
    out.extend(_check_launches(sources, resolve_launches(sources),
                               smem_budget))
    out.extend(_check_grids(sources))
    out.extend(_check_reached(sources))
    return out
