"""Math-expression compiler: propensity strings -> batched torch functions.

The reference evaluates propensity expressions with a runtime stack-bytecode
interpreter, one (state, reaction) pair at a time
(``reference/src/parser/FortranParser.f90:187-302``).  Here the same
grammar is parsed once into an AST and *compiled to a closure over torch
tensors* that evaluates a whole batch of states at once by broadcasting.
The tokenizer, parser and AST are those of the JAX package
(``krylovfspssa_tpu/models/expressions.py``); only the evaluator changes.

Grammar parity (FortranParser.f90:52-94,176):
  * binary operators ``+ - * / ^`` with standard precedence, ``^``
    right-associative; ``**`` is rewritten to ``^``;
  * unary minus;
  * functions: abs, exp, log10, log, sqrt, sinh, cosh, tanh, sin, cos, tan,
    asin, acos, atan (case-insensitive);
  * numeric literals with Fortran ``d``/``D`` or ``e``/``E`` exponents
    (FortranParser.f90:768-841);
  * variables are arbitrary names supplied by the model (species first, then
    parameters), longest-match tokenized so names containing dots
    (e.g. ``DNA.2D``) work.

Domain errors (division by zero, log of non-positive, ...) are non-fatal and
yield inf/nan, mirroring the reference's non-fatal error flags
(FortranParser.f90:217-287).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import torch

FUNCTIONS = (
    "abs",
    "exp",
    "log10",
    "log",
    "sqrt",
    "sinh",
    "cosh",
    "tanh",
    "sin",
    "cos",
    "tan",
    "asin",
    "acos",
    "atan",
)

_FUNC_IMPL = {
    "abs": torch.abs,
    "exp": torch.exp,
    "log10": lambda x: torch.log(x) / math.log(10.0),
    "log": torch.log,
    "sqrt": torch.sqrt,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
}

_NUMBER_RE = re.compile(r"(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?")


class ExpressionError(ValueError):
    """Raised on a syntax error in a propensity expression."""


# ----------------------------------------------------------------- AST ----


@dataclass(frozen=True)
class Num:
    value: float


@dataclass(frozen=True)
class Var:
    name: str


@dataclass(frozen=True)
class Neg:
    arg: "Node"


@dataclass(frozen=True)
class BinOp:
    op: str  # one of + - * / ^
    lhs: "Node"
    rhs: "Node"


@dataclass(frozen=True)
class Call:
    func: str
    arg: "Node"


Node = Num | Var | Neg | BinOp | Call


# ----------------------------------------------------------- tokenizer ----


@dataclass(frozen=True)
class _Tok:
    kind: str  # num | var | func | op | lparen | rparen
    text: str
    value: float = 0.0


def _tokenize(expr: str, variables: Sequence[str]) -> list[_Tok]:
    # ** is the Fortran power operator; the reference rewrites it to ^
    # (FortranParser.f90:176).
    s = expr.replace("**", "^")
    # Longest variable name first so e.g. "DNA.2D" beats "DNA".
    vars_by_len = sorted(variables, key=len, reverse=True)
    toks: list[_Tok] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c in "+-*/^":
            toks.append(_Tok("op", c))
            i += 1
            continue
        if c == "(":
            toks.append(_Tok("lparen", c))
            i += 1
            continue
        if c == ")":
            toks.append(_Tok("rparen", c))
            i += 1
            continue
        # variable names take precedence over everything else (they may
        # start with a digit or clash with a function name)
        matched = False
        for name in vars_by_len:
            if s.startswith(name, i) and _boundary_ok(s, i, len(name)):
                toks.append(_Tok("var", name))
                i += len(name)
                matched = True
                break
        if matched:
            continue
        m = _NUMBER_RE.match(s, i)
        if m:
            text = m.group(0)
            toks.append(_Tok("num", text, float(text.lower().replace("d", "e"))))
            i = m.end()
            continue
        # function name followed by '('
        m2 = re.match(r"[A-Za-z][A-Za-z0-9_]*", s[i:])
        if m2:
            name = m2.group(0)
            lower = name.lower()
            rest = s[i + len(name):].lstrip()
            if lower in FUNCTIONS and rest.startswith("("):
                toks.append(_Tok("func", lower))
                i += len(name)
                continue
            # case-insensitive variable fallback
            for v in vars_by_len:
                if v.lower() == lower:
                    toks.append(_Tok("var", v))
                    break
            else:
                raise ExpressionError(
                    f"unknown symbol {name!r} in expression {expr!r}"
                )
            i += len(name)
            continue
        raise ExpressionError(f"unexpected character {c!r} in expression {expr!r}")
    return toks


def _boundary_ok(s: str, start: int, length: int) -> bool:
    """A variable match must not be a prefix of a longer identifier."""
    end = start + length
    if end < len(s):
        nxt = s[end]
        if nxt.isalnum() or nxt == "_":
            return False
    if start > 0:
        prev = s[start - 1]
        if prev.isalnum() or prev == "_" or prev == ".":
            return False
    return True


# -------------------------------------------------------------- parser ----


class _Parser:
    """Recursive descent with standard precedence; ^ is right-associative
    and binds tighter than unary minus (Fortran semantics: -x**2 == -(x**2)).
    """

    def __init__(self, toks: list[_Tok], expr: str):
        self.toks = toks
        self.pos = 0
        self.expr = expr

    def peek(self) -> _Tok | None:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> _Tok:
        tok = self.peek()
        if tok is None:
            raise ExpressionError(f"unexpected end of expression: {self.expr!r}")
        self.pos += 1
        return tok

    def parse(self) -> Node:
        node = self.expr_sum()
        if self.peek() is not None:
            raise ExpressionError(
                f"trailing tokens after position {self.pos} in {self.expr!r}"
            )
        return node

    def expr_sum(self) -> Node:
        # optional leading sign
        tok = self.peek()
        if tok and tok.kind == "op" and tok.text in "+-":
            self.next()
            node = self.term()
            if tok.text == "-":
                node = Neg(node)
        else:
            node = self.term()
        while (tok := self.peek()) and tok.kind == "op" and tok.text in "+-":
            self.next()
            rhs = self.term()
            node = BinOp(tok.text, node, rhs)
        return node

    def term(self) -> Node:
        node = self.factor()
        while (tok := self.peek()) and tok.kind == "op" and tok.text in "*/":
            self.next()
            rhs = self.factor()
            node = BinOp(tok.text, node, rhs)
        return node

    def factor(self) -> Node:
        node = self.atom()
        tok = self.peek()
        if tok and tok.kind == "op" and tok.text == "^":
            self.next()
            # right-associative; allow unary minus in the exponent
            etok = self.peek()
            if etok and etok.kind == "op" and etok.text in "+-":
                self.next()
                rhs = self.factor()
                if etok.text == "-":
                    rhs = Neg(rhs)
            else:
                rhs = self.factor()
            node = BinOp("^", node, rhs)
        return node

    def atom(self) -> Node:
        tok = self.next()
        if tok.kind == "num":
            return Num(tok.value)
        if tok.kind == "var":
            return Var(tok.text)
        if tok.kind == "func":
            lp = self.next()
            if lp.kind != "lparen":
                raise ExpressionError(f"expected '(' after {tok.text} in {self.expr!r}")
            arg = self.expr_sum()
            rp = self.next()
            if rp.kind != "rparen":
                raise ExpressionError(f"missing ')' in {self.expr!r}")
            return Call(tok.text, arg)
        if tok.kind == "lparen":
            node = self.expr_sum()
            rp = self.next()
            if rp.kind != "rparen":
                raise ExpressionError(f"missing ')' in {self.expr!r}")
            return node
        if tok.kind == "op" and tok.text in "+-":
            node = self.factor()
            return Neg(node) if tok.text == "-" else node
        raise ExpressionError(f"unexpected token {tok.text!r} in {self.expr!r}")


def parse_expression(expr: str, variables: Sequence[str]) -> Node:
    """Parse ``expr`` over the given variable names into an AST."""
    toks = _tokenize(expr, variables)
    if not toks:
        raise ExpressionError("empty expression")
    return _Parser(toks, expr).parse()


# ------------------------------------------------------------ compiler ----


def _as_tensor(v):
    """Python numbers become float64 tensors (torch functions take only
    tensors; a 0-d CPU tensor broadcasts against tensors on any device)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float64)


def _eval_node(node: Node, env: Mapping[str, torch.Tensor]):
    if isinstance(node, Num):
        return node.value
    if isinstance(node, Var):
        return env[node.name]
    if isinstance(node, Neg):
        return -_eval_node(node.arg, env)
    if isinstance(node, Call):
        return _FUNC_IMPL[node.func](_as_tensor(_eval_node(node.arg, env)))
    if isinstance(node, BinOp):
        a = _eval_node(node.lhs, env)
        b = _eval_node(node.rhs, env)
        if node.op == "+":
            return a + b
        if node.op == "-":
            return a - b
        if node.op == "*":
            return a * b
        if node.op == "/":
            return a / b
        if node.op == "^":
            # integer exponents stay exact and avoid pow-domain issues at 0
            if isinstance(b, float) and float(b).is_integer() and abs(b) <= 64:
                return _int_pow(a, int(b))
            return _pow(a, b)
    raise TypeError(f"bad AST node {node!r}")


def _int_pow(a, k: int):
    if k == 0:
        return torch.ones_like(a) if isinstance(a, torch.Tensor) else 1.0
    inv = k < 0
    k = abs(k)
    out = a
    for _ in range(k - 1):
        out = out * a
    return 1.0 / out if inv else out


def _pow(a, b):
    return torch.pow(_as_tensor(a), b)


def compile_expression(
    expr: str, variables: Sequence[str]
) -> Callable[[Mapping[str, torch.Tensor]], torch.Tensor]:
    """Compile ``expr`` to a function of an env mapping var-name -> tensor.

    The returned callable evaluates on whatever tensors it is given (all
    vars broadcast together, on their own device).
    """
    ast = parse_expression(expr, variables)
    free = free_variables(ast)

    def fn(env: Mapping[str, torch.Tensor]):
        missing = free - set(env)
        if missing:
            raise KeyError(f"expression {expr!r} missing variables {sorted(missing)}")
        return _eval_node(ast, env)

    fn.ast = ast  # type: ignore[attr-defined]
    fn.expression = expr  # type: ignore[attr-defined]
    return fn


def free_variables(node: Node) -> set[str]:
    if isinstance(node, Num):
        return set()
    if isinstance(node, Var):
        return {node.name}
    if isinstance(node, Neg):
        return free_variables(node.arg)
    if isinstance(node, Call):
        return free_variables(node.arg)
    if isinstance(node, BinOp):
        return free_variables(node.lhs) | free_variables(node.rhs)
    raise TypeError(node)
