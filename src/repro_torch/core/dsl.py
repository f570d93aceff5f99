"""CFDlang front-end (the `cfdlang` dialect analogue).

Parses the concrete syntax from the paper (Fig. 2)::

    var input  S : [11 11]
    var input  D : [11 11 11]
    var input  u : [11 11 11]
    var output v : [11 11 11]
    var t : [11 11 11]
    var r : [11 11 11]
    t = S # S # S # u . [[1 6][3 7][5 8]]
    r = D * t
    v = S # S # S # r . [[0 6][2 7][4 8]]

Grammar (whitespace-separated tokens; ``//`` comments to end of line)::

    program := stmt*
    stmt    := 'var' ('input'|'output')? 'elem'? NAME ':' shape
             | NAME '=' expr
    shape   := '[' INT+ ']'
    expr    := term (('+'|'-') term)*
    term    := factor (('*'|'/') factor)*          # Hadamard product
    factor  := atom ('#' atom)* ('.' pairs)?       # outer product + contraction
    pairs   := '[' ('[' INT INT ']')+ ']'
    atom    := NAME | '(' expr ')'

The ``elem`` qualifier marks an input/output as carrying the implicit
element axis (the paper's outer element loop) directly in the source, so
a ``.cfd`` file is self-contained for the ``repro.flow`` tool flow; the
``element_vars`` argument of :func:`parse` remains available for sources
without markers.

Like the cfdlang MLIR dialect, the parser performs no canonicalization --
it maps language elements 1:1 onto IR nodes and leaves rewriting to the
middle-end (``repro.core.rewrite``).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from . import ir


class ParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<comment>//[^\n]*)|(?P<num>\d+)|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<sym>[\[\]():=#*+/.-]))"
)


def _tokenize(src: str) -> List[str]:
    toks: List[str] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            raise ParseError(f"unexpected character at {src[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup != "comment":
            toks.append(m.group(m.lastgroup))
    return toks


class _Parser:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0
        self.decls: Dict[str, Tuple[ir.Shape, str]] = {}  # name -> (shape, kind)
        self.values: Dict[str, ir.Node] = {}
        self.order: List[str] = []  # statement order for outputs
        self.elem_decls: List[str] = []  # 'elem'-qualified declarations

    # -- token helpers ----
    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise ParseError("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t: str) -> None:
        got = self.next()
        if got != t:
            raise ParseError(f"expected {t!r}, got {got!r}")

    # -- grammar ----
    def parse(self) -> "ir.Program":
        while self.peek() is not None:
            if self.peek() == "var":
                self._parse_decl()
            else:
                self._parse_assign()
        inputs = {
            n: self.values[n]
            for n, (_, kind) in self.decls.items()
            if kind == "input"
        }
        outputs = {}
        for n, (shape, kind) in self.decls.items():
            if kind != "output":
                continue
            if n not in self.values or isinstance(self.values[n], ir.Input):
                raise ParseError(f"output {n!r} never assigned")
            node = self.values[n]
            if node.shape != shape:
                raise ParseError(
                    f"output {n!r}: declared {shape}, computed {node.shape}"
                )
            outputs[n] = node
        temps = {
            n: self.values[n]
            for n, (_, kind) in self.decls.items()
            if kind == "temp" and not isinstance(self.values.get(n), ir.Input)
        }
        return ir.Program(inputs=inputs, outputs=outputs, temps=temps)

    def _int(self, what: str) -> int:
        t = self.next()
        if not t.isdigit():
            raise ParseError(
                f"expected {what}, got {t!r} (CFDlang integers are "
                "unsigned; '-' is a binary operator only)"
            )
        return int(t)

    def _parse_decl(self) -> None:
        self.expect("var")
        kind = "temp"
        if self.peek() in ("input", "output"):
            kind = self.next()
        elem = False
        if self.peek() == "elem" and self.toks[self.i + 1:self.i + 2] != [":"]:
            self.next()
            elem = True
            if kind == "temp":
                raise ParseError(
                    "'elem' qualifies inputs/outputs only (temporaries "
                    "never cross the host link)"
                )
        name = self.next()
        self.expect(":")
        self.expect("[")
        dims: List[int] = []
        while self.peek() != "]":
            dims.append(self._int("dimension"))
        self.expect("]")
        if name in self.decls:
            raise ParseError(f"duplicate declaration of {name!r}")
        shape = tuple(dims)
        self.decls[name] = (shape, kind)
        if elem:
            self.elem_decls.append(name)
        if kind == "input":
            self.values[name] = ir.Input(shape=shape, name=name)

    def _parse_assign(self) -> None:
        name = self.next()
        if name not in self.decls:
            raise ParseError(f"assignment to undeclared {name!r}")
        self.expect("=")
        node = self._expr()
        declared = self.decls[name][0]
        if node.shape != declared:
            raise ParseError(
                f"{name!r}: declared shape {declared}, expression {node.shape}"
            )
        self.values[name] = node
        self.order.append(name)

    def _expr(self) -> ir.Node:
        node = self._term()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self._term()
            node = ir.add(node, rhs) if op == "+" else ir.sub(node, rhs)
        return node

    def _term(self) -> ir.Node:
        node = self._factor()
        while self.peek() in ("*", "/"):
            op = self.next()
            rhs = self._factor()
            node = ir.mul(node, rhs) if op == "*" else ir.div(node, rhs)
        return node

    def _factor(self) -> ir.Node:
        node = self._atom()
        while self.peek() == "#":
            self.next()
            rhs = self._atom()
            node = ir.prod(node, rhs)
        if self.peek() == ".":
            self.next()
            pairs = self._pairs()
            try:
                node = ir.cont(node, pairs)
            except ir.IRError as e:  # surface as a front-end diagnostic
                raise ParseError(str(e)) from e
        return node

    def _pairs(self) -> List[Tuple[int, int]]:
        self.expect("[")
        pairs: List[Tuple[int, int]] = []
        while self.peek() == "[":
            self.next()
            a = self._int("axis number")
            b = self._int("axis number")
            self.expect("]")
            pairs.append((a, b))
        self.expect("]")
        if not pairs:
            raise ParseError("empty contraction pair list")
        return pairs

    def _atom(self) -> ir.Node:
        t = self.next()
        if t == "(":
            node = self._expr()
            self.expect(")")
            return node
        if t in ("+", "-"):
            # a stray leading sign used to cascade into a confusing
            # "unknown identifier" chain; reject it at the source
            raise ParseError(
                f"{t!r} is a binary operator in CFDlang; unary signs are "
                "not part of the grammar (write '0 - x' via a declared "
                "zero operand, or fold the sign into the data)"
            )
        if t in self.values:
            return self.values[t]
        if t in self.decls:
            raise ParseError(f"use of {t!r} before assignment")
        raise ParseError(f"unknown identifier {t!r}")


def parse(src: str, element_vars: Sequence[str] = ()) -> ir.Program:
    """Parse CFDlang source into an IR Program.

    ``element_vars`` marks inputs/outputs that carry the implicit element
    axis (the paper's outer element loop); e.g. for the Inverse Helmholtz
    operator: ``("u", "D", "v")`` -- the operator matrix ``S`` is shared.
    Sources may equivalently carry ``elem`` qualifiers on declarations;
    both spellings are merged (declaration order first).
    """
    toks = _tokenize(src)
    if not toks:
        raise ParseError(
            "empty program: no declarations or statements "
            "(comment-only/blank source)"
        )
    parser = _Parser(toks)
    prog = parser.parse()
    merged = list(parser.elem_decls)
    merged += [v for v in element_vars if v not in merged]
    return ir.Program(
        inputs=prog.inputs,
        outputs=prog.outputs,
        element_vars=tuple(merged),
        temps=prog.temps,
    )


# ---------------------------------------------------------------------------
# Python builder API (for programs generated programmatically, e.g. the
# LM MLP blocks routed through the scheduler).
# ---------------------------------------------------------------------------


class Builder:
    """Programmatic front end producing the same IR as :func:`parse`."""

    def __init__(self) -> None:
        self._inputs: Dict[str, ir.Input] = {}
        self._outputs: Dict[str, ir.Node] = {}
        self._element_vars: List[str] = []

    def input(self, name: str, shape: Sequence[int], element: bool = False) -> ir.Input:
        if name in self._inputs:
            raise ParseError(f"duplicate input {name!r}")
        node = ir.Input(shape=tuple(shape), name=name)
        self._inputs[name] = node
        if element:
            self._element_vars.append(name)
        return node

    def output(self, name: str, node: ir.Node, element: bool = False) -> None:
        self._outputs[name] = node
        if element:
            self._element_vars.append(name)

    # thin wrappers so user code reads like the DSL
    prod = staticmethod(ir.prod)
    cont = staticmethod(ir.cont)
    diag = staticmethod(ir.diag)
    red = staticmethod(ir.red)
    transpose = staticmethod(ir.transpose)
    add = staticmethod(ir.add)
    sub = staticmethod(ir.sub)
    mul = staticmethod(ir.mul)
    div = staticmethod(ir.div)

    def matmul(self, a: ir.Node, b: ir.Node) -> ir.Node:
        """GEMM as prod+cont (the teil encoding from the paper's Fig. 8b)."""
        if a.rank != 2 or b.rank != 2:
            raise ParseError("matmul expects rank-2 operands")
        return ir.cont(ir.prod(a, b), [(1, 2)])

    def program(self) -> ir.Program:
        return ir.Program(
            inputs=self._inputs,
            outputs=self._outputs,
            element_vars=tuple(self._element_vars),
        )


#: The paper's running example (Fig. 2), exposed for tests and examples.
INVERSE_HELMHOLTZ_SRC = """
var input S : [{p} {p}]
var input D : [{p} {p} {p}]
var input u : [{p} {p} {p}]
var output v : [{p} {p} {p}]
var t : [{p} {p} {p}]
var r : [{p} {p} {p}]
t = S # S # S # u . [[1 6][3 7][5 8]]
r = D * t
v = S # S # S # r . [[0 6][2 7][4 8]]
"""


def inverse_helmholtz_program(p: int = 11) -> ir.Program:
    return parse(INVERSE_HELMHOLTZ_SRC.format(p=p), element_vars=("u", "D", "v"))


INTERPOLATION_SRC = """
var input A : [{m} {n}]
var input u : [{n} {n} {n}]
var output v : [{m} {m} {m}]
v = A # A # A # u . [[1 6][3 7][5 8]]
"""


def interpolation_program(n: int = 11, m: int = 11) -> ir.Program:
    return parse(
        INTERPOLATION_SRC.format(n=n, m=m), element_vars=("u", "v")
    )


# Note on layouts: CFDlang's '.' contraction keeps the remaining axes in
# their original order, so the y/z gradients come out with the derivative
# axis leading (the paper's flow would equally emit layout metadata for the
# host; see Olympus host-code specialization, paper section 3.6.2).
GRADIENT_SRC = """
var input Dx : [{nx} {nx}]
var input Dy : [{ny} {ny}]
var input Dz : [{nz} {nz}]
var input u : [{nx} {ny} {nz}]
var output gx : [{nx} {ny} {nz}]
var output gy : [{ny} {nx} {nz}]
var output gz : [{nz} {nx} {ny}]
gx = Dx # u . [[1 2]]
gy = Dy # u . [[1 3]]
gz = Dz # u . [[1 4]]
"""


def gradient_program(nx: int = 8, ny: int = 7, nz: int = 6) -> ir.Program:
    return parse(
        GRADIENT_SRC.format(nx=nx, ny=ny, nz=nz),
        element_vars=("u", "gx", "gy", "gz"),
    )
