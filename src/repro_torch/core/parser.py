"""Textual Datalog -> IR.

Accepts the paper's concrete syntax, e.g.::

    tc(X, Y) <- arc(X, Y).
    tc(X, Y) <- tc(X, Z), arc(Z, Y).
    dpath(X, Z, min<Dxz>) <- dpath(X, Y, Dxy), darc(Y, Z, Dyz), Dxz = Dxy + Dyz.
    spath(X, Z, Dxz) <- dpath(X, Z, Dxz).
    attend(X) <- cntfriends(X, Nfx), Nfx >= 3.
    cntfriends(Y, mcount<X>) <- attend(X), friend(Y, X).
    len(T, 0) <- myrupt(T, C, V, _, _), ~myrupt(_, _, _, _, T).

Conventions follow the paper: predicates/constants lower-case, variables
upper-case, ``_`` anonymous, ``~`` negation, ``<-`` rule arrow, ``.`` rule
terminator.  Head aggregates use ``agg<Var>`` (the extra grouping witness of
``sum<Qty, Store>`` is accepted and recorded).
"""
from __future__ import annotations

import re

from .ir import AGG_KINDS, AggSpec, Arith, Comparison, Const, Goal, Literal, Program, Rule, Term, Var, fresh_var

_TOKEN = re.compile(
    r"\s*(?:"
    r"(?P<query>\?-)|"
    r"(?P<arrow><-)|"
    r"(?P<cmp><=|>=|!=|<|>|=)|"
    r"(?P<lpar>\()|(?P<rpar>\))|"
    r"(?P<langle>⟨)|(?P<rangle>⟩)|"
    r"(?P<comma>,)|(?P<dot>\.)|(?P<neg>~)|"
    r"(?P<plus>\+)|(?P<minus>-)|(?P<star>\*)|"
    r"(?P<num>\d+)|"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r")"
)


class ParseError(ValueError):
    pass


def _tokenize(text: str) -> list[tuple[str, str]]:
    # strip %-comments
    text = re.sub(r"%[^\n]*", "", text)
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise ParseError(f"bad token at: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        toks.append((kind, m.group(kind)))
    return toks


class _Stream:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise ParseError(f"expected {kind}, got {t}")
        return t


def _is_var_name(name: str) -> bool:
    return name[0].isupper() or name[0] == "_"


def parse_program(text: str, constants: dict[str, int] | None = None) -> Program:
    """Parse rules and query goals (``?- tc(1, X).``); lower-case symbolic
    constants resolve via ``constants``."""
    constants = constants or {}
    s = _Stream(_tokenize(text))
    rules, queries = [], []
    while s.peek()[0] != "eof":
        if s.peek()[0] == "query":
            s.next()
            queries.append(_parse_query_literal(s, constants))
            s.expect("dot")
        else:
            rules.append(_parse_rule(s, constants))
    return Program(rules, queries=queries)


def parse_query(text: str, constants: dict[str, int] | None = None) -> Literal:
    """Parse a single query goal: ``tc(1, X)`` or ``?- tc(1, X).``."""
    s = _Stream(_tokenize(text))
    if s.peek()[0] == "query":
        s.next()
    lit = _parse_query_literal(s, constants or {})
    if s.peek()[0] == "dot":
        s.next()
    if s.peek()[0] != "eof":
        raise ParseError(f"trailing tokens after query goal: {s.peek()}")
    return lit


def _parse_query_literal(s: _Stream, constants) -> Literal:
    """A plain positive literal — constants or free vars in any position."""
    _, pred = s.expect("name")
    if _is_var_name(pred):
        raise ParseError(f"query predicate must be lower-case, got {pred!r}")
    s.expect("lpar")
    args = [_parse_term(s, constants)]
    while s.peek()[0] == "comma":
        s.next()
        args.append(_parse_term(s, constants))
    s.expect("rpar")
    return Literal(pred, tuple(args))


def _parse_term(s: _Stream, constants) -> Term:
    kind, val = s.next()
    if kind == "num":
        return Const(int(val))
    if kind == "minus":
        kind2, val2 = s.expect("num")
        return Const(-int(val2))
    if kind == "name":
        if _is_var_name(val):
            return fresh_var() if val == "_" else Var(val)
        if val in constants:
            return Const(constants[val])
        raise ParseError(f"unknown constant {val!r} (pass it via constants=)")
    raise ParseError(f"expected term, got {kind}:{val}")


def _parse_head(s: _Stream, constants) -> tuple[Literal, AggSpec | None]:
    _, pred = s.expect("name")
    s.expect("lpar")
    args: list[Term] = []
    agg: AggSpec | None = None
    while True:
        kind, val = s.peek()
        if kind == "name" and val in AGG_KINDS and s.toks[s.i + 1][0] in ("cmp", "langle") and (
            s.toks[s.i + 1][1] in ("<",) or s.toks[s.i + 1][0] == "langle"
        ):
            s.next()  # agg name
            s.next()  # '<' or '⟨'
            inner = [_parse_term(s, constants)]
            while s.peek()[0] == "comma":
                s.next()
                inner.append(_parse_term(s, constants))
            closer = s.next()
            if not (closer[0] == "rangle" or (closer[0] == "cmp" and closer[1] == ">")):
                raise ParseError(f"expected closing aggregate bracket, got {closer}")
            if agg is not None:
                raise ParseError("multiple aggregates in one head")
            agg = AggSpec(kind=val, position=len(args))
            args.append(inner[0])  # aggregate value term; extra witnesses implied
        else:
            args.append(_parse_term(s, constants))
        kind, _ = s.next()
        if kind == "rpar":
            break
        if kind != "comma":
            raise ParseError("expected , or ) in head")
    return Literal(pred, tuple(args)), agg


def _parse_goal(s: _Stream, constants) -> Goal:
    if s.peek()[0] == "neg":
        s.next()
        _, pred = s.expect("name")
        s.expect("lpar")
        args = [_parse_term(s, constants)]
        while s.peek()[0] == "comma":
            s.next()
            args.append(_parse_term(s, constants))
        s.expect("rpar")
        return Literal(pred, tuple(args), negated=True)

    kind, val = s.peek()
    if kind == "name" and not _is_var_name(val) and s.toks[s.i + 1][0] == "lpar":
        s.next()
        s.expect("lpar")
        args = [_parse_term(s, constants)]
        while s.peek()[0] == "comma":
            s.next()
            args.append(_parse_term(s, constants))
        s.expect("rpar")
        return Literal(val, tuple(args))

    # comparison or arithmetic: Term cmp Term [+|- Term]
    lhs = _parse_term(s, constants)
    opk, opv = s.next()
    if opk != "cmp":
        raise ParseError(f"expected comparison after {lhs!r}, got {opv}")
    rhs = _parse_term(s, constants)
    if s.peek()[0] in ("plus", "minus", "star"):
        if opv != "=":
            raise ParseError("arithmetic only allowed with '='")
        aop = {"plus": "+", "minus": "-", "star": "*"}[s.next()[0]]
        rhs2 = _parse_term(s, constants)
        if not isinstance(lhs, Var):
            raise ParseError("arithmetic target must be a variable")
        return Arith(lhs, aop, rhs, rhs2)
    return Comparison(opv, lhs, rhs)


def _parse_rule(s: _Stream, constants) -> Rule:
    head, agg = _parse_head(s, constants)
    kind, _ = s.next()
    if kind == "dot":
        return Rule(head, (), agg)
    if kind != "arrow":
        raise ParseError("expected <- or . after head")
    body: list[Goal] = [_parse_goal(s, constants)]
    while True:
        kind, _ = s.next()
        if kind == "dot":
            break
        if kind != "comma":
            raise ParseError("expected , or . in body")
        body.append(_parse_goal(s, constants))
    return Rule(head, tuple(body), agg)
