"""A pure-Python model of the CUDA C++ sources (``.cu`` / ``.cuh``).

The kernel-contract family (``kernel_contracts``) reads the port's
hand-written kernels the way the reference's ``pallas_contracts`` reads
``pl.pallas_call`` sites (its ``extract_pallas_calls`` / ``_shape_env``
/ ``_tuple_bytes``): no compiler, no libclang — tokens and a little
structure.

  * **Tokens.**  Comments are dropped; string literals are kept, and
    adjacent ones concatenated once macros are expanded.  ``#define``
    macros (object-like and function-like, ``#undef`` honoured) are
    expanded as far as their bodies are tokens, so a PTX string built
    by concatenation with a macro parameter (``"...f32." TY "." TY``)
    reads as one literal.  ``#include "..."`` resolves among the
    analyzed files: a translation unit sees its headers' macros and
    functions.  A file that cannot be balanced (an unterminated
    comment or string, unbalanced braces) is reported as broken.
  * **Declarations.**  ``__global__`` / ``__device__`` / host
    functions with their template parameters, ``__launch_bounds__``,
    parameters and ``extern "C"`` linkage; static ``__shared__`` arrays
    and ``extern __shared__`` buffers; ``constexpr`` integers at file
    scope, in function bodies and as ``static constexpr`` members of
    (template) structs; ``enum`` values; ``using`` aliases; local
    variables (a grid's ``dim3``); each function's calls, launch sites
    (``name<args><<<grid, block, smem, stream>>>(...)`` and
    ``cudaLaunchKernelEx`` through a ``cudaLaunchConfig_t``),
    ``cudaFuncSetAttribute`` calls, and ``asm`` strings.
  * **An integer evaluator** for constexpr arithmetic under template
    substitution (``DwLayout<kTile>::kThreads``, ``L::kBytes``,
    ``sizeof(T)``: 2 for ``__nv_bfloat16`` / ``__half``, 4 for
    ``float``).  What it cannot resolve (a runtime value) is ``None``,
    and callers label it unresolved — as the reference labels its
    assumed 128.

:func:`static_smem_bytes` gives a kernel instance's static shared
memory, which the on-card check holds equal to ptxas's own count.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

SOURCE_SUFFIXES = (".cu", ".cuh")

# sizeof of the scalar types the kernels use
TYPE_BYTES = {
    "float": 4, "int": 4, "unsigned": 4, "uint32_t": 4, "int32_t": 4,
    "uint64_t": 8, "int64_t": 8, "double": 8, "char": 1,
    "uint8_t": 1, "int8_t": 1, "uint16_t": 2, "int16_t": 2, "short": 2,
    "__nv_bfloat16": 2, "__half": 2, "half": 2, "bool": 1,
    "uint4": 16, "float4": 16, "int4": 16, "float2": 8, "uint2": 8,
    "long": 8,
}
# the dtype spellings of ptxas instance names and the C interface
DTYPES = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half",
          "float": "float", "__nv_bfloat16": "__nv_bfloat16",
          "__half": "__half"}

_PUNCT = sorted((
    "<<<", ">>>", "<<=", ">>=", "...", "->", "::", "<<", ">>", "<=", ">=",
    "==", "!=", "&&", "||", "++", "--", "+=", "-=", "*=", "/=", "%=",
    "&=", "|=", "^=", "##",
    "{", "}", "(", ")", "[", "]", ";", ",", ".", "<", ">", "+", "-", "*",
    "/", "%", "&", "|", "^", "!", "~", "?", ":", "=", "#"),
    key=len, reverse=True)
_KEYWORDS = frozenset((
    "if", "for", "while", "switch", "return", "sizeof", "static_cast",
    "reinterpret_cast", "const_cast", "dynamic_cast", "do", "else", "case",
    "new", "delete", "throw", "catch", "alignof", "decltype", "asm",
    "__launch_bounds__", "__align__", "defined", "static_assert",
    "__attribute__", "typeid", "noexcept"))


class ParseError(ValueError):
    """The file cannot be balanced (analyzers report AN001)."""


@dataclasses.dataclass
class Token:
    kind: str          # "id" | "num" | "str" | "chr" | "op"
    text: str
    line: int
    path: str = ""

    def __repr__(self) -> str:  # debugging aid
        return f"{self.text}@{self.line}"


@dataclasses.dataclass
class Macro:
    name: str
    params: Optional[List[str]]          # None: object-like
    body: List[Token]


# ---------------------------------------------------------------------------
# tokens and directives
# ---------------------------------------------------------------------------

_NUM = re.compile(r"(0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+"
                  r"(?:[eE][+-]?\d+)?)[uUlLfF]*")
_ID = re.compile(r"[A-Za-z_]\w*")


def _lex(src: str, path: str, line0: int = 1) -> List[Token]:
    """Tokens of code text with no directives; comments dropped."""
    out: List[Token] = []
    i, n, line = 0, len(src), line0
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
        elif c in " \t\r\f\v\\":
            i += 1
        elif src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise ParseError(f"{path}:{line}: unterminated comment")
            line += src.count("\n", i, j)
            i = j + 2
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                if src[j] == "\\":
                    j += 1
                elif src[j] == "\n":
                    break
                j += 1
            if j >= n or src[j] != c:
                raise ParseError(f"{path}:{line}: unterminated literal")
            out.append(Token("str" if c == '"' else "chr", src[i + 1:j],
                             line, path))
            i = j + 1
        elif c.isdigit() or (c == "." and i + 1 < n
                             and src[i + 1].isdigit()):
            m = _NUM.match(src, i)
            out.append(Token("num", m.group(0), line, path))
            i = m.end()
        elif c.isalpha() or c == "_":
            m = _ID.match(src, i)
            out.append(Token("id", m.group(0), line, path))
            i = m.end()
        else:
            for p in _PUNCT:
                if src.startswith(p, i):
                    out.append(Token("op", p, line, path))
                    i += len(p)
                    break
            else:
                i += 1            # a stray character: nothing to model
    return out


def _split_directives(src: str) -> Iterator[Tuple[str, int, str]]:
    """("code" | "pp", first line, text) pieces of a file, directives
    joined across backslash-newlines.  Comments that span lines are kept
    in the code pieces (the lexer drops them)."""
    lines = src.split("\n")
    code: List[str] = []
    start, i, in_comment = 1, 0, False
    while i < len(lines):
        ln = lines[i]
        if not in_comment and ln.lstrip().startswith("#"):
            if code:
                yield "code", start, "\n".join(code)
            first = i + 1
            text = ln
            while text.endswith("\\") and i + 1 < len(lines):
                i += 1
                text = text[:-1] + " " + lines[i]
            yield "pp", first, text.strip()[1:].strip()
            code, start = [], i + 2
        else:
            code.append(ln)
            # track /* ... */ spanning lines (a '#' inside is not a
            # directive)
            stripped = re.sub(r'"(\\.|[^"\\])*"', '""', ln)
            stripped = re.sub(r"//.*", "", stripped)
            opens = stripped.rfind("/*")
            closes = stripped.rfind("*/")
            if opens > closes:
                in_comment = True
            elif closes > opens:
                in_comment = False
        i += 1
    if code:
        yield "code", start, "\n".join(code)


# ---------------------------------------------------------------------------
# macro expansion
# ---------------------------------------------------------------------------

def _parse_define(text: str, line: int, path: str) -> Optional[Macro]:
    m = re.match(r"define\s+([A-Za-z_]\w*)(\([^)]*\))?\s*(.*)$", text,
                 re.S)
    if m is None:
        return None
    params = None
    if m.group(2) is not None:
        params = [p.strip() for p in m.group(2)[1:-1].split(",")
                  if p.strip()]
    body = _lex(m.group(3), path, line)
    for t in body:
        t.line = line
    return Macro(m.group(1), params, body)


def _macro_args(toks: List[Token], i: int
                ) -> Tuple[Optional[List[List[Token]]], int]:
    """Arguments of a function-like macro call whose ``(`` is at
    ``toks[i]``; (None, i) if there is none."""
    if i >= len(toks) or toks[i].text != "(":
        return None, i
    args: List[List[Token]] = [[]]
    depth = 0
    j = i
    while j < len(toks):
        t = toks[j]
        if t.text in ("(", "[", "{"):
            depth += 1
            if depth > 1:
                args[-1].append(t)
        elif t.text in (")", "]", "}"):
            depth -= 1
            if depth == 0:
                return ([] if args == [[]] else args), j + 1
            args[-1].append(t)
        elif t.text == "," and depth == 1:
            args.append([])
        else:
            args[-1].append(t)
        j += 1
    return None, i


def expand(toks: List[Token], macros: Dict[str, Macro],
           hide: frozenset = frozenset()) -> List[Token]:
    """Macro-expanded tokens (``#`` / ``##`` are not modelled)."""
    out: List[Token] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        mac = macros.get(t.text) if t.kind == "id" else None
        if mac is None or t.text in hide:
            out.append(t)
            i += 1
            continue
        if mac.params is None:
            out.extend(expand(list(mac.body), macros, hide | {mac.name}))
            i += 1
            continue
        args, end = _macro_args(toks, i + 1)
        if args is None:
            out.append(t)
            i += 1
            continue
        bind = {p: expand(a, macros, hide)
                for p, a in zip(mac.params, args)}
        body: List[Token] = []
        for b in mac.body:
            body.extend(bind.get(b.text, [b]) if b.kind == "id" else [b])
        out.extend(expand(body, macros, hide | {mac.name}))
        i = end
    return out


def _join_strings(toks: List[Token]) -> List[Token]:
    out: List[Token] = []
    for t in toks:
        if t.kind == "str" and out and out[-1].kind == "str":
            out[-1] = Token("str", out[-1].text + t.text, out[-1].line,
                            out[-1].path)
        else:
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SharedArray:
    name: str
    elem: str                      # element type spelling
    dims: List[List[Token]]        # one expression a dimension
    align: Optional[List[Token]]
    line: int


@dataclasses.dataclass
class Call:
    name: str                      # last component (``hopper::f`` -> f)
    targs: List[List[Token]]       # explicit template arguments
    args: List[List[Token]]
    line: int


@dataclasses.dataclass
class Launch:
    kernel: str
    targs: List[List[Token]]
    grid: List[Token]
    block: List[Token]
    smem: List[Token]
    args: List[List[Token]]        # the kernel's arguments
    line: int
    path: str


@dataclasses.dataclass
class Function:
    name: str
    path: str
    line: int
    tparams: List[Tuple[str, str]]         # (kind, name): kind 'type'/'int'
    params: List[Tuple[List[Token], str]]  # (type tokens, name)
    quals: frozenset
    launch_bounds: Optional[List[Token]]
    body: List[Token]
    extern_c: bool = False
    shared: List[SharedArray] = dataclasses.field(default_factory=list)
    dynamic_shared: List[str] = dataclasses.field(default_factory=list)
    constexprs: Dict[str, List[Token]] = dataclasses.field(
        default_factory=dict)
    aliases: Dict[str, List[Token]] = dataclasses.field(
        default_factory=dict)
    locals: Dict[str, List[Token]] = dataclasses.field(default_factory=dict)
    calls: List[Call] = dataclasses.field(default_factory=list)
    launches: List[Launch] = dataclasses.field(default_factory=list)
    asm: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    # cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes)
    smem_attrs: List[Tuple[str, List[Token], int]] = dataclasses.field(
        default_factory=list)

    @property
    def is_kernel(self) -> bool:
        return "__global__" in self.quals


@dataclasses.dataclass
class Struct:
    name: str
    tparams: List[Tuple[str, str]]
    constexprs: Dict[str, List[Token]]


@dataclasses.dataclass
class SourceFile:
    """One ``.cu`` / ``.cuh`` file, macro-expanded in its translation
    unit's context."""

    path: str
    includes: List[str]
    functions: List[Function]
    structs: Dict[str, Struct]
    constexprs: Dict[str, List[Token]]


def _match(toks: List[Token], i: int, open_: str = "(",
           close: str = ")") -> int:
    """Index just past the group opened at ``toks[i]``."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j].text == open_:
            depth += 1
        elif toks[j].text == close:
            depth -= 1
            if depth == 0:
                return j + 1
    raise ParseError(f"{toks[i].path}:{toks[i].line}: unbalanced "
                     f"{open_!r}")


def _angle_end(toks: List[Token], i: int) -> int:
    """Index past the template argument list opened by ``<`` at
    ``toks[i]`` (``>>`` closes two levels)."""
    depth = 0
    j = i
    while j < len(toks):
        t = toks[j].text
        if t == "<":
            depth += 1
        elif t == ">":
            depth -= 1
        elif t == ">>":
            depth -= 2
        elif t in ("(", "[", "{"):
            j = _match(toks, j, t, {"(": ")", "[": "]", "{": "}"}[t]) - 1
        elif t in (";", "{", "}"):
            return i + 1
        if depth <= 0:
            return j + 1
        j += 1
    return i + 1


def _split_commas(toks: List[Token]) -> List[List[Token]]:
    out: List[List[Token]] = [[]]
    depth = 0
    for t in toks:
        if t.text in ("(", "[", "{", "<"):
            depth += 1
        elif t.text in (")", "]", "}", ">"):
            depth -= 1
        elif t.text == ">>":
            depth -= 2
        if t.text == "," and depth == 0:
            out.append([])
        else:
            out[-1].append(t)
    return [] if out == [[]] else out


def _template_params(head: List[Token]) -> List[Tuple[str, str]]:
    for i, t in enumerate(head):
        if t.text == "template" and i + 1 < len(head) \
                and head[i + 1].text == "<":
            end = _angle_end(head, i + 1)
            out = []
            for part in _split_commas(head[i + 2:end - 1]):
                ids = [x.text for x in part if x.kind == "id"]
                if not ids:
                    continue
                kind = "type" if ids[0] in ("typename", "class") else "int"
                out.append((kind, ids[-1] if "=" not in [x.text for x in part]
                            else ids[1 if kind == "type" else -2]))
            return out
    return []


def _strip_template(head: List[Token]) -> List[Token]:
    for i, t in enumerate(head):
        if t.text == "template" and i + 1 < len(head) \
                and head[i + 1].text == "<":
            return head[_angle_end(head, i + 1):]
    return head


def _parse_params(toks: List[Token]) -> List[Tuple[List[Token], str]]:
    out = []
    for part in _split_commas(toks):
        if len(part) == 1 and part[0].text == "void":
            continue
        ids = [j for j, x in enumerate(part) if x.kind == "id"]
        if not ids:
            continue
        # the last identifier, in `float (&d)[32]` as in `const T* x`
        name_j = ids[-1]
        out.append((part[:name_j], part[name_j].text))
    return out


def _statements(body: List[Token]) -> Iterator[List[Token]]:
    """Flat statements of a body (``{`` / ``}`` end one, so a block's
    statements come out one by one)."""
    cur: List[Token] = []
    i = 0
    while i < len(body):
        t = body[i]
        if t.text == "(":
            end = _match(body, i)
            cur.extend(body[i:end])
            i = end
            continue
        cur.append(t)
        if t.text in (";", "{", "}"):
            yield cur
            cur = []
        i += 1
    if cur:
        yield cur


def _read_body(fn: Function) -> None:
    body = fn.body
    for st in _statements(body):
        words = [t.text for t in st]
        if "__shared__" in words:
            _read_shared(fn, st)
        if words[:1] == ["using"] and "=" in words:
            eq = words.index("=")
            fn.aliases[words[1]] = st[eq + 1:-1]
        elif "constexpr" in words and "=" in words:
            # `constexpr int BM = kTile, BN = kTile;`: each declarator
            for part in _split_commas(st[:-1]):
                pw = [t.text for t in part]
                if "=" in pw:
                    eq = pw.index("=")
                    if eq >= 1 and part[eq - 1].kind == "id":
                        fn.constexprs[part[eq - 1].text] = part[eq + 1:]
        elif st and st[-1].text == ";":
            _read_local(fn, st)
    _read_calls(fn)


def _read_local(fn: Function, st: List[Token]) -> None:
    """``T name = expr;`` / ``dim3 name(a, b);`` / ``cfg.field = expr;``"""
    words = [t.text for t in st]
    if "=" in words:
        eq = words.index("=")
        if eq >= 2 and st[eq - 1].kind == "id" and st[eq - 2].kind == "id" \
                and words[0] not in ("return",):
            fn.locals[st[eq - 1].text] = st[eq + 1:-1]
        elif eq == 3 and words[1] == ".":
            fn.locals[f"{words[0]}.{words[2]}"] = st[eq + 1:-1]
    elif len(st) >= 4 and st[0].kind == "id" and st[-2].text == ")":
        for j in range(1, len(st) - 1):
            if st[j].text == "(" and st[j - 1].kind == "id" and (
                    st[0].text in ("dim3", "const")
                    and j >= 2 and st[j - 2].kind == "id"):
                fn.locals[st[j - 1].text] = [Token("id", "dim3", st[j].line,
                                                   st[j].path)] + st[j:-1]
                break


def _read_shared(fn: Function, st: List[Token]) -> None:
    words = [t.text for t in st]
    if "extern" in words:
        names = [t.text for t in st if t.kind == "id"]
        fn.dynamic_shared.append(names[-1] if names else "?")
        return
    align = None
    toks = [t for t in st if t.text != "__shared__"]
    j = 0
    out: List[Token] = []
    while j < len(toks):
        if toks[j].text == "__align__":
            end = _match(toks, j + 1)
            align = toks[j + 2:end - 1]
            j = end
            continue
        out.append(toks[j])
        j += 1
    if "[" not in [t.text for t in out]:
        name_i = max(i for i, t in enumerate(out) if t.kind == "id")
        dims: List[List[Token]] = []
    else:
        br = [t.text for t in out].index("[")
        name_i = br - 1
        dims = []
        k = br
        while k < len(out) and out[k].text == "[":
            end = _match(out, k, "[", "]")
            dims.append(out[k + 1:end - 1])
            k = end
    elem = " ".join(t.text for t in out[:name_i]
                    if t.text not in ("static", "volatile", "const"))
    fn.shared.append(SharedArray(out[name_i].text, elem, dims, align,
                                 out[name_i].line))


def _read_calls(fn: Function) -> None:
    body = fn.body
    i = 0
    while i < len(body):
        t = body[i]
        if t.text == "asm":
            j = i + 1
            while j < len(body) and body[j].text in ("volatile",
                                                       "__volatile__"):
                j += 1
            if j < len(body) and body[j].text == "(":
                end = _match(body, j)
                for s in body[j + 1:end]:
                    if s.kind == "str":
                        fn.asm.append((s.text, s.line))
                        break
                i = end
                continue
        if t.kind == "id" and t.text not in _KEYWORDS:
            j = i + 1
            targs: List[List[Token]] = []
            if j < len(body) and body[j].text == "<":
                end = _angle_end(body, j)
                if end > j + 1 and end <= len(body) \
                        and body[end - 1].text in (">", ">>"):
                    targs = _split_commas(body[j + 1:end - 1])
                    j = end
                else:
                    j = i + 1
            if j < len(body) and body[j].text == "<<<":
                close = j
                while close < len(body) and body[close].text != ">>>":
                    close += 1
                cfg = _split_commas(body[j + 1:close])
                aend = _match(body, close + 1)
                fn.launches.append(Launch(
                    t.text, targs, *(cfg + [[]] * 4)[:3],
                    args=_split_commas(body[close + 2:aend - 1]),
                    line=t.line, path=t.path))
                i = aend
                continue
            if j < len(body) and body[j].text == "(" and not (
                    i > 0 and body[i - 1].text in ("struct", "class")):
                end = _match(body, j)
                args = _split_commas(body[j + 1:end - 1])
                name = t.text
                fn.calls.append(Call(name, targs, args, t.line))
                if name == "cudaFuncSetAttribute" and len(args) == 3 and \
                        any(x.text == "cudaFuncAttributeMaxDynamicShared"
                            "MemorySize" for x in args[1]):
                    fn.smem_attrs.append((_kernel_name(fn, args[0]),
                                          args[2], t.line))
                if name == "cudaLaunchKernelEx" and len(args) >= 2:
                    cfg = args[0][-1].text if args[0] else "cfg"
                    fn.launches.append(Launch(
                        _kernel_name(fn, args[1]),
                        _kernel_targs(fn, args[1]),
                        fn.locals.get(f"{cfg}.gridDim", []),
                        fn.locals.get(f"{cfg}.blockDim", []),
                        fn.locals.get(f"{cfg}.dynamicSmemBytes", []),
                        args=args[2:], line=t.line, path=t.path))
                i = j + 1
                continue
        i += 1


def _kernel_ref(fn: Function, toks: List[Token]) -> List[Token]:
    if len(toks) == 1 and toks[0].text in fn.locals:
        return fn.locals[toks[0].text]
    return toks


def _kernel_name(fn: Function, toks: List[Token]) -> str:
    ref = _kernel_ref(fn, toks)
    ids = [t.text for t in ref if t.kind == "id"]
    return ids[0] if ids else "?"


def _kernel_targs(fn: Function, toks: List[Token]) -> List[List[Token]]:
    ref = _kernel_ref(fn, toks)
    for i, t in enumerate(ref):
        if t.text == "<":
            end = _angle_end(ref, i)
            return _split_commas(ref[i + 1:end - 1])
    return []


def _parse(path: str, toks: List[Token]) -> Tuple[
        List[Function], Dict[str, Struct], Dict[str, List[Token]]]:
    """Functions, structs and file-scope constants of expanded tokens."""
    funcs: List[Function] = []
    structs: Dict[str, Struct] = {}
    consts: Dict[str, List[Token]] = {}
    head: List[Token] = []
    i = 0
    stack: List[str] = []          # enclosing "ns" / "struct:<name>"
    while i < len(toks):
        t = toks[i]
        if t.text == ";":
            _file_const(head, consts, structs, stack)
            head = []
            i += 1
            continue
        if t.text == "}":
            if not stack:
                raise ParseError(f"{path}:{t.line}: unbalanced '}}'")
            stack.pop()
            head = []
            i += 1
            continue
        if t.text == "(":
            end = _match(toks, i)
            head.extend(toks[i:end])
            i = end
            continue
        if t.text != "{":
            head.append(t)
            i += 1
            continue
        words = [h.text for h in head]
        core = _strip_template(head)
        cwords = [h.text for h in core]
        if "namespace" in words or (len(head) == 2 and words[0] == "extern"
                                    and head[1].kind == "str"):
            stack.append("ns")
            head = []
            i += 1
            continue
        if cwords[:1] and cwords[0] in ("struct", "class", "union") \
                and "(" not in cwords[:3]:
            name = core[1].text if len(core) > 1 else "?"
            stack.append("struct:" + name)
            structs.setdefault(name, Struct(name, _template_params(head), {}))
            head = []
            i += 1
            continue
        if cwords[:1] == ["enum"]:
            end = _match(toks, i, "{", "}")
            for part in _split_commas(toks[i + 1:end - 1]):
                if len(part) >= 3 and part[1].text == "=":
                    consts[part[0].text] = part[2:]
            head = []
            i = end
            continue
        fn = _function_head(path, head)
        end = _match(toks, i, "{", "}")
        if fn is not None:
            fn.body = toks[i + 1:end - 1]
            _read_body(fn)
            funcs.append(fn)
            head = []
        else:
            head.extend(toks[i:end])      # an initializer / a lambda
        i = end
    if stack:
        raise ParseError(f"{path}: unbalanced '{{' at end of file")
    return funcs, structs, consts


def _file_const(head: List[Token], consts: Dict[str, List[Token]],
                structs: Dict[str, Struct], stack: List[str]) -> None:
    words = [h.text for h in head]
    if "constexpr" not in words or "=" not in words:
        return
    eq = words.index("=")
    if eq < 1 or head[eq - 1].kind != "id":
        return
    name, expr = head[eq - 1].text, head[eq + 1:]
    if stack and stack[-1].startswith("struct:"):
        structs[stack[-1][7:]].constexprs[name] = expr
    else:
        consts[name] = expr


def _function_head(path: str, head: List[Token]) -> Optional[Function]:
    if not head or "=" in [h.text for h in head]:
        return None
    tparams = _template_params(head)
    core = _strip_template(head)
    extern_c = any(a.text == "extern" and b.kind == "str" and b.text == "C"
                   for a, b in zip(core, core[1:]))
    lb: Optional[List[Token]] = None
    params_at = None
    j = 0
    while j < len(core):
        t = core[j]
        if t.text in ("__launch_bounds__", "__align__", "__attribute__",
                      "decltype", "alignas") and j + 1 < len(core) \
                and core[j + 1].text == "(":
            end = _match(core, j + 1)
            if t.text == "__launch_bounds__":
                lb = core[j + 2:end - 1]
            j = end
            continue
        if t.text == "(" and j >= 1 and core[j - 1].kind == "id" \
                and params_at is None:
            params_at = j
            j = _match(core, j)
            continue
        j += 1
    if params_at is None:
        return None
    name = core[params_at - 1].text
    if name in _KEYWORDS:
        return None
    end = _match(core, params_at)
    quals = frozenset(t.text for t in core[:params_at]
                      if t.text.startswith("__") or t.text in (
                          "inline", "static", "extern"))
    return Function(
        name=name, path=path, line=core[params_at - 1].line,
        tparams=tparams,
        params=_parse_params(core[params_at + 1:end - 1]),
        quals=quals, launch_bounds=lb, body=[], extern_c=extern_c)


# ---------------------------------------------------------------------------
# files and translation units
# ---------------------------------------------------------------------------

def iter_source_files(paths: Sequence[str],
                      excluded: Sequence[str]) -> Iterator[str]:
    seen = set()
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(SOURCE_SUFFIXES) and p not in seen:
                seen.add(p)
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in excluded)
            for f in sorted(files):
                full = os.path.join(root, f)
                if f.endswith(SOURCE_SUFFIXES) and full not in seen:
                    seen.add(full)
                    yield full


class Program:
    """Every analyzed source file, each macro-expanded within its
    translation unit (its ``#include "..."`` chain among the analyzed
    files, each header once)."""

    def __init__(self, paths: Sequence[str]):
        self.raw: Dict[str, str] = {}
        self.files: Dict[str, SourceFile] = {}
        self.broken: Dict[str, str] = {}
        for p in paths:
            with open(p, encoding="utf-8") as f:
                self.raw[p] = f.read()
        for p in paths:
            try:
                self.files[p] = self._load(p)
            except (ParseError, RecursionError, ValueError,
                    IndexError) as e:
                self.broken[p] = str(e)

    @classmethod
    def load(cls, paths: Sequence[str], excluded: Sequence[str] = ()
             ) -> "Program":
        return cls(list(iter_source_files(paths, excluded)))

    def _resolve_include(self, src: str, name: str) -> Optional[str]:
        cand = os.path.normpath(os.path.join(os.path.dirname(src), name))
        for p in self.raw:
            if os.path.normpath(p) == cand:
                return p
        for p in self.raw:
            if os.path.basename(p) == os.path.basename(name):
                return p
        return None

    def _load(self, path: str) -> SourceFile:
        macros: Dict[str, Macro] = {}
        includes: List[str] = []
        toks = self._unit_tokens(path, macros, includes, set(), own=True)
        toks = _join_strings(toks)
        funcs, structs, consts = _parse(path, toks)
        for name, mac in macros.items():
            if mac.params is None and mac.body:
                consts.setdefault(name, mac.body)
        return SourceFile(path, includes, funcs, structs, consts)

    def _unit_tokens(self, path: str, macros: Dict[str, Macro],
                     includes: List[str], seen: set, own: bool
                     ) -> List[Token]:
        """``path``'s expanded tokens (``own``) after its headers'
        macros are defined; a header's own tokens are not returned."""
        seen.add(path)
        out: List[Token] = []
        for kind, line, text in _split_directives(self.raw[path]):
            if kind == "code":
                toks = _lex(text, path, line)
                if own:
                    out.extend(expand(toks, macros))
                continue
            m = re.match(r'include\s+"([^"]+)"', text)
            if m:
                inc = self._resolve_include(path, m.group(1))
                if inc is not None and inc not in seen:
                    includes.append(inc)
                    self._unit_tokens(inc, macros, includes, seen,
                                      own=False)
                continue
            if text.startswith("define"):
                mac = _parse_define(text, line, path)
                if mac is not None:
                    macros[mac.name] = mac
            elif text.startswith("undef"):
                macros.pop(text.split()[1] if len(text.split()) > 1
                           else "", None)
        return out

    # -- lookups ---------------------------------------------------------

    def unit(self, path: str) -> List[SourceFile]:
        """The file and every analyzed header it includes."""
        f = self.files.get(path)
        if f is None:
            return []
        return [f] + [self.files[i] for i in f.includes if i in self.files]

    def functions(self, path: Optional[str] = None,
                  name: Optional[str] = None) -> List[Function]:
        files = self.unit(path) if path else list(self.files.values())
        return [fn for sf in files for fn in sf.functions
                if name is None or fn.name == name]

    def kernels(self) -> List[Function]:
        return [fn for sf in self.files.values() for fn in sf.functions
                if fn.is_kernel]

    def kernel(self, name: str) -> Optional[Function]:
        for fn in self.kernels():
            if fn.name == name:
                return fn
        return None

    def reached(self, fn: Function, depth: int = 8) -> List[Function]:
        """``fn`` and every function its calls reach in its unit (by
        name; all overloads)."""
        out, seen = [fn], {id(fn)}
        frontier = [fn]
        for _ in range(depth):
            nxt = []
            for f in frontier:
                for c in f.calls:
                    for g in self.functions(fn.path, c.name):
                        if id(g) not in seen:
                            seen.add(id(g))
                            out.append(g)
                            nxt.append(g)
            frontier = nxt
        return out

    def callers(self, fn: Function) -> List[Tuple[Function, Call]]:
        return [(g, c) for g in self.functions(fn.path) for c in g.calls
                if c.name == fn.name]


# ---------------------------------------------------------------------------
# the integer evaluator
# ---------------------------------------------------------------------------

def _c_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def type_bytes(spelling: str, types: Dict[str, str]) -> Optional[int]:
    words = [w for w in spelling.replace("*", " * ").split()
             if w not in ("const", "volatile", "struct", "signed")]
    if "*" in words:
        return 8
    words = [types.get(w, w) for w in words]
    if words in (["unsigned", "char"], ["char"]):
        return 1
    if words in (["long", "long"], ["unsigned", "long", "long"]):
        return 8
    if words and words[0] == "unsigned" and len(words) == 1:
        return 4
    key = words[-1] if words else ""
    return TYPE_BYTES.get(key)


class Evaluator:
    """Integer constant expressions of one translation unit, under
    ``types`` (template type parameter -> C type) and ``ints`` (template
    int parameter / local constant -> value or token expression)."""

    def __init__(self, prog: Program, path: str,
                 types: Optional[Dict[str, str]] = None,
                 ints: Optional[Dict[str, object]] = None,
                 fn: Optional[Function] = None, depth: int = 0):
        self.prog = prog
        self.path = path
        self.types = dict(types or {})
        self.ints: Dict[str, object] = dict(ints or {})
        self.fn = fn
        self.depth = depth

    def bind(self, fn: Function, targs: Sequence[object]) -> "Evaluator":
        """An evaluator for ``fn``'s body at the instance ``targs``
        (ints, C type names, or token lists evaluated here)."""
        types, ints = {}, {}
        for (kind, name), a in zip(fn.tparams, targs):
            if kind == "type":
                spelled = (" ".join(t.text for t in a)
                           if isinstance(a, list) else str(a))
                types[name] = DTYPES.get(spelled,
                                         self.types.get(spelled, spelled))
            else:
                v = self.eval(a) if isinstance(a, list) else a
                if v is not None:
                    ints[name] = v
        return Evaluator(self.prog, fn.path, types, ints, fn,
                         self.depth + 1)

    def _lookup(self, name: str) -> Optional[int]:
        if name in self.ints:
            v = self.ints[name]
            if isinstance(v, list):
                v = self.eval(v)
                self.ints[name] = v if v is not None else []
            return v if isinstance(v, int) else None
        if name in ("true", "false"):
            return int(name == "true")
        if self.fn is not None:
            for table in (self.fn.constexprs, self.fn.locals):
                if name in table:
                    v = self._sub(table[name])
                    self.ints[name] = v if v is not None else []
                    return v
        for sf in self.prog.unit(self.path):
            if name in sf.constexprs:
                return self._sub(sf.constexprs[name])
        return None

    def _sub(self, toks: List[Token]) -> Optional[int]:
        if self.depth > 12:
            return None
        ev = Evaluator(self.prog, self.path, self.types, self.ints,
                       self.fn, self.depth + 1)
        return ev.eval(toks)

    def _struct_member(self, struct: str, targs: List[List[Token]],
                       member: str) -> Optional[int]:
        if self.fn is not None and struct in self.fn.aliases and not targs:
            alias = self.fn.aliases[struct]
            ids = [t for t in alias if t.kind == "id"]
            if not ids:
                return None
            struct = ids[0].text
            k = [t.text for t in alias].index("<") if "<" in [
                t.text for t in alias] else -1
            targs = (_split_commas(alias[k + 1:_angle_end(alias, k) - 1])
                     if k >= 0 else [])
        for sf in self.prog.unit(self.path):
            st = sf.structs.get(struct)
            if st is None or member not in st.constexprs:
                continue
            types, ints = dict(self.types), {}
            for (kind, name), a in zip(st.tparams, targs):
                if kind == "type":
                    spelled = " ".join(t.text for t in a)
                    types[name] = self.types.get(spelled, spelled)
                else:
                    v = self.eval(a)
                    if v is None:
                        return None
                    ints[name] = v
            for k2, expr in st.constexprs.items():
                ints.setdefault(k2, expr)
            ev = Evaluator(self.prog, self.path, types, ints, None,
                           self.depth + 1)
            return ev.eval(st.constexprs[member])
        return None

    def sizeof(self, toks: List[Token]) -> Optional[int]:
        spelled = " ".join(t.text for t in toks)
        return type_bytes(spelled, self.types)

    def eval(self, toks: List[Token]) -> Optional[int]:
        if not toks:
            return None
        try:
            p = _ExprParser(self, toks)
            v = p.ternary()
            return v if p.i == len(toks) else None
        except (IndexError, ZeroDivisionError, _Unknown):
            return None


class _Unknown(Exception):
    pass


_BINARY = [("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
           ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"),
           ("*", "/", "%")]
_CASTS = frozenset(("int", "unsigned", "long", "float", "double", "size_t",
                    "uint32_t", "uint64_t", "int64_t", "short", "char",
                    "bool", "signed", "const"))


class _ExprParser:
    def __init__(self, ev: Evaluator, toks: List[Token]):
        self.ev, self.toks, self.i = ev, toks, 0

    def peek(self) -> str:
        return self.toks[self.i].text if self.i < len(self.toks) else ""

    def take(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def ternary(self) -> Optional[int]:
        c = self.binary(0)
        if self.peek() == "?":
            self.take()
            a = self.ternary()
            if self.take().text != ":":
                raise _Unknown
            b = self.ternary()
            if c is None:
                return None
            return a if c else b
        return c

    def binary(self, level: int) -> Optional[int]:
        if level == len(_BINARY):
            return self.unary()
        left = self.binary(level + 1)
        while self.peek() in _BINARY[level]:
            op = self.take().text
            right = self.binary(level + 1)
            if left is None or right is None:
                left = None
                continue
            left = _apply(op, left, right)
        return left

    def unary(self) -> Optional[int]:
        t = self.peek()
        if t in ("-", "+", "!", "~"):
            self.take()
            v = self.unary()
            if v is None:
                return None
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[t]
        if t == "(" and self._is_cast():
            self.i = _match(self.toks, self.i)
            return self.unary()
        return self.postfix()

    def _is_cast(self) -> bool:
        end = _match(self.toks, self.i)
        inner = [x.text for x in self.toks[self.i + 1:end - 1]]
        return bool(inner) and all(w in _CASTS or w == "*" for w in inner)

    def postfix(self) -> Optional[int]:
        t = self.take()
        if t.text == "(":
            v = self.ternary()
            if self.take().text != ")":
                raise _Unknown
            return v
        if t.kind == "num":
            s = t.text.rstrip("uUlL")
            if any(c in s for c in ".eE") and not s.lower().startswith("0x"):
                raise _Unknown
            return int(s, 0) if s.lower().startswith("0x") else int(s)
        if t.kind != "id":
            raise _Unknown
        if t.text == "sizeof":
            end = _match(self.toks, self.i)
            v = self.ev.sizeof(self.toks[self.i + 1:end - 1])
            self.i = end
            return v
        if t.text in ("static_cast", "reinterpret_cast"):
            self.i = _angle_end(self.toks, self.i)
            return self.postfix()
        names = [t.text]
        targs: List[List[Token]] = []
        if self.peek() == "<":
            end = _angle_end(self.toks, self.i)
            if end < len(self.toks) and self.toks[end].text == "::":
                targs = _split_commas(self.toks[self.i + 1:end - 1])
                self.i = end
        while self.peek() == "::":
            self.take()
            names.append(self.take().text)
        if self.peek() == "(":            # a call: min / max only
            end = _match(self.toks, self.i)
            args = [self.ev.eval(a) for a in
                    _split_commas(self.toks[self.i + 1:end - 1])]
            self.i = end
            if names[-1] in ("min", "max") and args and None not in args:
                return (min if names[-1] == "min" else max)(args)
            return None
        if self.peek() in (".", "->"):
            return None
        if len(names) >= 2:
            if names[0] in ("repro", "hopper") and len(names) == 2:
                return self.ev._lookup(names[-1])
            return self.ev._struct_member(names[-2], targs, names[-1])
        return self.ev._lookup(names[0])


def _apply(op: str, a: int, b: int) -> Optional[int]:
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return _c_div(a, b)
    if op == "%":
        return a - _c_div(a, b) * b
    if op == "<<":
        return a << b
    if op == ">>":
        return a >> b
    if op == "&":
        return a & b
    if op == "|":
        return a | b
    if op == "^":
        return a ^ b
    return int({"==": a == b, "!=": a != b, "<": a < b, ">": a > b,
                "<=": a <= b, ">=": a >= b, "&&": bool(a and b),
                "||": bool(a or b)}[op])


# ---------------------------------------------------------------------------
# shared memory
# ---------------------------------------------------------------------------

def _instance_env(prog: Program, fn: Function, dtype: Optional[str],
                  int_args: Sequence[int]) -> Evaluator:
    targs: List[object] = []
    it = iter(int_args)
    for kind, _ in fn.tparams:
        if kind == "type":
            targs.append(DTYPES.get(dtype or "", dtype or "?"))
        else:
            targs.append(next(it, None))
    return Evaluator(prog, fn.path).bind(fn, targs)


def shared_bytes(ev: Evaluator, fn: Function) -> Optional[int]:
    """Static shared bytes of ``fn``'s own ``__shared__`` arrays under
    ``ev`` (declaration order, each aligned to its ``__align__`` or its
    element size, as ptxas lays them out)."""
    total = 0
    for arr in fn.shared:
        elem = type_bytes(arr.elem, ev.types)
        if elem is None:
            return None
        n = elem
        for d in arr.dims:
            v = ev.eval(d)
            if v is None:
                return None
            n *= v
        align = ev.eval(arr.align) if arr.align else elem
        if not align:
            return None
        total = -(-total // align) * align + n
    return total


def static_smem_bytes(prog: Program, kernel: str, dtype: Optional[str],
                      int_args: Sequence[int]) -> Optional[int]:
    """Static shared memory of the kernel instance ``kernel<dtype,
    *int_args>`` (``dtype``: ``"f32"`` / ``"bf16"`` / ``"f16"``, or None
    for a kernel with no type parameter): its own ``__shared__`` arrays
    plus those of the device functions it reaches.  None when a size
    does not resolve."""
    fn = prog.kernel(kernel)
    if fn is None:
        return None
    ev = _instance_env(prog, fn, dtype, int_args)
    total = shared_bytes(ev, fn)
    if total is None:
        return None
    for g in prog.reached(fn)[1:]:
        if g.shared:
            sub = shared_bytes(Evaluator(prog, g.path, ev.types), g)
            if sub is None:
                return None
            total += sub
    return total
