"""PromQL parser (recursive descent) producing this engine's AST.

A copy of ``m3_tpu/query/promql.py`` (pure Python): the port keeps its
own so that it imports nothing of the JAX package.

The reference wraps the upstream Prometheus parser and maps its AST into
M3 parse nodes (`src/query/parser/promql/parse.go`); this is a
from-scratch parser for the supported subset:

* literals, vector selectors `m{a="b",c!~"d"}`, range `[5m]`, `offset`;
* function calls (temporal family, math family, histogram_quantile,
  clamp/round, scalar/vector, label_replace/label_join, absent);
* aggregations with `by`/`without` grouping + parameterized topk/
  bottomk/quantile/count_values;
* binary operators with precedence (^ > */% > +- > comparisons > and/
  unless > or), `bool` modifier, and `on`/`ignoring` vector matching.
"""

from __future__ import annotations

import re
import dataclasses
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class NumberLiteral(Expr):
    value: float


@dataclass(frozen=True)
class StringLiteral(Expr):
    value: str


@dataclass(frozen=True)
class LabelMatcher:
    name: bytes
    op: str  # "=", "!=", "=~", "!~"
    value: bytes


@dataclass(frozen=True)
class VectorSelector(Expr):
    name: bytes | None
    matchers: tuple[LabelMatcher, ...] = ()
    range_nanos: int = 0  # 0 = instant
    offset_nanos: int = 0
    # @ modifier: pin evaluation to a fixed time.  at_nanos holds the
    # literal timestamp; at_edge "start"/"end" resolves to the query
    # range boundary at evaluation (Prometheus start()/end()).
    at_nanos: int | None = None
    at_edge: str = ""


@dataclass(frozen=True)
class Subquery(Expr):
    """``<expr>[range:step]`` (Prometheus subqueries): evaluate the
    inner INSTANT expression on a step grid, then window it like a
    range vector.  step 0 = the engine's default resolution."""

    expr: Expr
    range_nanos: int
    step_nanos: int = 0
    offset_nanos: int = 0
    at_nanos: int | None = None
    at_edge: str = ""


@dataclass(frozen=True)
class Call(Expr):
    func: str
    args: tuple[Expr, ...]


@dataclass(frozen=True)
class Aggregation(Expr):
    op: str
    expr: Expr
    by: tuple[bytes, ...] | None = None
    without: tuple[bytes, ...] | None = None
    param: Expr | None = None


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr
    bool_mode: bool = False
    on: tuple[bytes, ...] | None = None
    ignoring: tuple[bytes, ...] | None = None


@dataclass(frozen=True)
class Unary(Expr):
    op: str
    expr: Expr


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<space>\s+)
  | (?P<duration>\d+(?:\.\d+)?(?:ms|s|m|h|d|w|y))
  | (?P<number>
        0x[0-9a-fA-F]+
      | (?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?
      | [iI][nN][fF] | [nN][aA][nN])
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>=~|!~|==|!=|>=|<=|<|>|=|\+|-|\*|/|%|\^|\(|\)|\{|\}|\[|\]|,|:|@)
  | (?P<ident>[a-zA-Z_:][a-zA-Z0-9_:.]*)
    """,
    re.VERBOSE,
)

_DUR = {"ms": 10**6, "s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9,
        "d": 86400 * 10**9, "w": 7 * 86400 * 10**9, "y": 365 * 86400 * 10**9}

AGG_OPS = {"sum", "avg", "min", "max", "count", "stddev", "stdvar",
           "topk", "bottomk", "quantile", "count_values", "group"}

_CMP = {"==", "!=", ">", "<", ">=", "<="}


@dataclass
class _Tok:
    kind: str
    text: str


def _lex(s: str) -> list[_Tok]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ValueError(f"promql: bad token at {s[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "space":
            continue
        out.append(_Tok(kind, m.group()))
    out.append(_Tok("eof", ""))
    return out


def _unquote(text: str) -> str:
    """Strip quotes and resolve escape sequences (Prometheus string
    literals use Go escaping; \\" \\\\ \\n \\t etc.)."""
    body = text[1:-1]
    return body.encode("latin-1", "backslashreplace").decode("unicode_escape")


def parse_duration(text: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h|d|w|y)", text)
    if not m:
        raise ValueError(f"bad duration {text!r}")
    return int(float(m.group(1)) * _DUR[m.group(2)])


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> _Tok:
        t = self.next()
        if t.text != text:
            raise ValueError(f"promql: expected {text!r}, got {t.text!r}")
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.i += 1
            return True
        return False

    # precedence climbing: or < and/unless < cmp < +- < */% < ^ < unary
    def parse_expr(self) -> Expr:
        return self._parse_or()

    def _bin_rhs(self, op: str):
        bool_mode = False
        on = ignoring = None
        if self.peek().text == "bool":
            self.next()
            bool_mode = True
        if self.peek().text in ("on", "ignoring"):
            which = self.next().text
            labels = self._parse_label_list()
            if which == "on":
                on = labels
            else:
                ignoring = labels
            if self.peek().text in ("group_left", "group_right"):
                self.next()
                if self.peek().text == "(":
                    self._parse_label_list()
        return bool_mode, on, ignoring

    def _parse_or(self) -> Expr:
        lhs = self._parse_and()
        while self.peek().text == "or":
            self.next()
            bm, on, ig = self._bin_rhs("or")
            lhs = BinaryOp("or", lhs, self._parse_and(), bm, on, ig)
        return lhs

    def _parse_and(self) -> Expr:
        lhs = self._parse_cmp()
        while self.peek().text in ("and", "unless"):
            op = self.next().text
            bm, on, ig = self._bin_rhs(op)
            lhs = BinaryOp(op, lhs, self._parse_cmp(), bm, on, ig)
        return lhs

    def _parse_cmp(self) -> Expr:
        lhs = self._parse_add()
        while self.peek().text in _CMP:
            op = self.next().text
            bm, on, ig = self._bin_rhs(op)
            lhs = BinaryOp(op, lhs, self._parse_add(), bm, on, ig)
        return lhs

    def _parse_add(self) -> Expr:
        lhs = self._parse_mul()
        while self.peek().text in ("+", "-"):
            op = self.next().text
            bm, on, ig = self._bin_rhs(op)
            lhs = BinaryOp(op, lhs, self._parse_mul(), bm, on, ig)
        return lhs

    def _parse_mul(self) -> Expr:
        lhs = self._parse_unary()
        while self.peek().text in ("*", "/", "%"):
            op = self.next().text
            bm, on, ig = self._bin_rhs(op)
            lhs = BinaryOp(op, lhs, self._parse_unary(), bm, on, ig)
        return lhs

    def _parse_unary(self) -> Expr:
        # Unary binds LOOSER than ^ (Prometheus: -2^2 == -(2^2)).
        if self.peek().text in ("-", "+"):
            op = self.next().text
            return Unary(op, self._parse_unary())
        return self._parse_pow()

    def _parse_pow(self) -> Expr:
        lhs = self._parse_postfix()
        if self.peek().text == "^":  # right-assoc; rhs may be unary (2^-3)
            self.next()
            bm, on, ig = self._bin_rhs("^")
            return BinaryOp("^", lhs, self._parse_unary(), bm, on, ig)
        return lhs

    def _parse_postfix(self) -> Expr:
        e = self._parse_primary()
        while True:
            if self.peek().text == "[":
                self.next()
                dur = self.next()
                rng = parse_duration(dur.text)
                if self.accept(":"):
                    # subquery: [range:step] or [range:] (default step)
                    sub_step = 0
                    if self.peek().text != "]":
                        sub_step = parse_duration(self.next().text)
                    self.expect("]")
                    e = Subquery(e, rng, sub_step)
                    continue
                self.expect("]")
                if not isinstance(e, VectorSelector):
                    raise ValueError(
                        "range selector on non-selector (use [range:step] "
                        "for a subquery)")
                e = dataclasses.replace(e, range_nanos=rng)
            elif self.peek().text == "offset":
                self.next()
                off = parse_duration(self.next().text)
                if not isinstance(e, (Subquery, VectorSelector)):
                    raise ValueError("offset on non-selector")
                e = dataclasses.replace(e, offset_nanos=off)
            elif self.peek().text == "@":
                self.next()
                at_nanos: int | None = None
                edge = ""
                t = self.next()
                if t.text in ("start", "end"):
                    self.expect("(")
                    self.expect(")")
                    edge = t.text
                else:
                    # unix seconds, possibly fractional or signed.
                    # Parsed at millisecond precision like Prometheus:
                    # float seconds * 1e9 at epoch magnitude is ~200ns
                    # off, enough to exclude a sample stored exactly at
                    # the pinned time from its (t-range, t] window.
                    txt = t.text
                    if txt == "-":
                        txt += self.next().text
                    at_nanos = int(round(float(txt) * 1000)) * 10**6
                if not isinstance(e, (Subquery, VectorSelector)):
                    raise ValueError("@ modifier on non-selector")
                e = dataclasses.replace(e, at_nanos=at_nanos, at_edge=edge)
            else:
                return e

    def _parse_label_list(self) -> tuple[bytes, ...]:
        self.expect("(")
        out = []
        while self.peek().text != ")":
            out.append(self.next().text.encode())
            if not self.accept(","):
                break
        self.expect(")")
        return tuple(out)

    def _parse_matchers(self) -> tuple[LabelMatcher, ...]:
        self.expect("{")
        out = []
        while self.peek().text != "}":
            name = self.next().text.encode()
            op = self.next().text
            if op not in ("=", "!=", "=~", "!~"):
                raise ValueError(f"bad matcher op {op!r}")
            val = self.next()
            if val.kind != "string":
                raise ValueError("matcher value must be a string")
            out.append(LabelMatcher(name, op, _unquote(val.text).encode()))
            if not self.accept(","):
                break
        self.expect("}")
        return tuple(out)

    def _parse_primary(self) -> Expr:
        t = self.peek()
        if t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.kind == "number":
            self.next()
            txt = t.text.lower()
            if txt.startswith("0x"):
                return NumberLiteral(float(int(txt, 16)))
            if txt == "inf":
                return NumberLiteral(float("inf"))
            if txt == "nan":
                return NumberLiteral(float("nan"))
            return NumberLiteral(float(t.text))
        if t.kind == "duration":
            self.next()
            return NumberLiteral(parse_duration(t.text) / 1e9)
        if t.kind == "string":
            self.next()
            return StringLiteral(_unquote(t.text))
        if t.text == "{":
            return VectorSelector(None, self._parse_matchers())
        if t.kind == "ident":
            self.next()
            name = t.text
            if name in AGG_OPS and self.peek().text in ("(", "by", "without"):
                return self._parse_aggregation(name)
            if self.peek().text == "(":
                self.next()
                args = []
                while self.peek().text != ")":
                    args.append(self.parse_expr())
                    if not self.accept(","):
                        break
                self.expect(")")
                return Call(name, tuple(args))
            matchers = ()
            if self.peek().text == "{":
                matchers = self._parse_matchers()
            return VectorSelector(name.encode(), matchers)
        raise ValueError(f"promql: unexpected token {t.text!r}")

    def _parse_aggregation(self, op: str) -> Expr:
        by = without = None
        if self.peek().text == "by":
            self.next()
            by = self._parse_label_list()
        elif self.peek().text == "without":
            self.next()
            without = self._parse_label_list()
        self.expect("(")
        first = self.parse_expr()
        param = None
        expr = first
        if self.accept(","):
            param = first
            expr = self.parse_expr()
        self.expect(")")
        if self.peek().text == "by":
            self.next()
            by = self._parse_label_list()
        elif self.peek().text == "without":
            self.next()
            without = self._parse_label_list()
        return Aggregation(op, expr, by, without, param)


def parse(query: str) -> Expr:
    p = _Parser(_lex(query))
    e = p.parse_expr()
    if p.peek().kind != "eof":
        raise ValueError(f"promql: trailing input at {p.peek().text!r}")
    return e
