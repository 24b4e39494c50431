# Copied verbatim from kyverno_tpu/cel/parser.py.
"""CEL recursive-descent parser -> tuple AST.

AST nodes (tag, ...):
  ("lit", value)                  ("ident", name)
  ("select", target, field)       ("opt_select", target, field)
  ("index", target, key)          ("call", name, args)
  ("method", target, name, args)  ("list", items)
  ("map", [(k, v), ...])          ("cond", c, t, f)
  ("or", l, r) ("and", l, r)      ("binop", op, l, r)
  ("not", e) ("neg", e)
  ("has", target, field)
  ("macro", kind, target, var, [expr...])   # all/exists/exists_one/map/filter

Macros are recognized at parse time (cel-spec macros.md): they bind an
iteration variable and therefore cannot be ordinary calls."""

from __future__ import annotations

from typing import Any, List, Tuple

from .errors import CelSyntaxError
from .lexer import RESERVED, Token, tokenize

_MACROS = {"all", "exists", "exists_one", "map", "filter"}
_RELOPS = {"<", "<=", ">=", ">", "==", "!="}


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value=None) -> bool:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value=None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise CelSyntaxError(f"expected {value or kind}, got {t.value!r} at {t.pos}")
        return t

    # -- grammar

    def parse(self):
        e = self.expr()
        self.expect("EOF")
        return e

    def expr(self):
        cond = self.conditional_or()
        if self.accept("PUNCT", "?"):
            t = self.conditional_or()
            self.expect("PUNCT", ":")
            f = self.expr()
            return ("cond", cond, t, f)
        return cond

    def conditional_or(self):
        e = self.conditional_and()
        while self.accept("PUNCT", "||"):
            e = ("or", e, self.conditional_and())
        return e

    def conditional_and(self):
        e = self.relation()
        while self.accept("PUNCT", "&&"):
            e = ("and", e, self.relation())
        return e

    def relation(self):
        e = self.addition()
        while True:
            t = self.peek()
            if t.kind == "PUNCT" and t.value in _RELOPS:
                self.next()
                e = ("binop", t.value, e, self.addition())
            elif t.kind == "IN":
                self.next()
                e = ("binop", "in", e, self.addition())
            else:
                return e

    def addition(self):
        e = self.multiplication()
        while True:
            t = self.peek()
            if t.kind == "PUNCT" and t.value in ("+", "-"):
                self.next()
                e = ("binop", t.value, e, self.multiplication())
            else:
                return e

    def multiplication(self):
        e = self.unary()
        while True:
            t = self.peek()
            if t.kind == "PUNCT" and t.value in ("*", "/", "%"):
                self.next()
                e = ("binop", t.value, e, self.unary())
            else:
                return e

    def unary(self):
        if self.accept("PUNCT", "!"):
            return ("not", self.unary())
        if self.accept("PUNCT", "-"):
            return ("neg", self.unary())
        return self.member()

    def member(self):
        e = self.primary()
        while True:
            if self.accept("PUNCT", "."):
                if self.accept("PUNCT", "?"):
                    # optional field selection e.?f (k8s optionals lib)
                    name = self.expect("IDENT").value
                    e = ("opt_select", e, name)
                    continue
                name = self.expect("IDENT").value
                if self.accept("PUNCT", "("):
                    args = self.expr_list(")")
                    e = self._method(e, name, args)
                else:
                    e = ("select", e, name)
            elif self.accept("PUNCT", "["):
                k = self.expr()
                self.expect("PUNCT", "]")
                e = ("index", e, k)
            else:
                return e

    def _method(self, target, name: str, args: List[Any]):
        if name in _MACROS:
            if not args or args[0][0] != "ident":
                # map/filter REQUIRE an ident binder; a non-ident first
                # arg is only legal for non-macro same-named methods,
                # which CEL does not define — error like cel-go
                raise CelSyntaxError(f"{name}() requires an iteration variable")
            var = args[0][1]
            body = args[1:]
            if name in ("all", "exists", "exists_one", "filter") and len(body) != 1:
                raise CelSyntaxError(f"{name}() takes exactly 2 arguments")
            if name == "map" and len(body) not in (1, 2):
                raise CelSyntaxError("map() takes 2 or 3 arguments")
            return ("macro", name, target, var, body)
        return ("method", target, name, args)

    def expr_list(self, closer: str) -> List[Any]:
        args: List[Any] = []
        if self.accept("PUNCT", closer):
            return args
        while True:
            args.append(self.expr())
            if self.accept("PUNCT", ","):
                if self.accept("PUNCT", closer):  # trailing comma
                    return args
                continue
            self.expect("PUNCT", closer)
            return args

    def primary(self):
        t = self.peek()
        if t.kind in ("INT", "UINT", "DOUBLE", "STRING", "BYTES", "BOOL", "NULL"):
            self.next()
            return ("lit", t.value)
        if t.kind == "PUNCT" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("PUNCT", ")")
            return e
        if t.kind == "PUNCT" and t.value == "[":
            self.next()
            return ("list", self.expr_list("]"))
        if t.kind == "PUNCT" and t.value == "{":
            self.next()
            return ("map", self.map_inits())
        if self.accept("PUNCT", "."):
            # leading-dot absolute reference; treated like a bare ident
            name = self.expect("IDENT").value
            return self._ident_or_call(name)
        if t.kind == "IDENT":
            self.next()
            return self._ident_or_call(t.value)
        raise CelSyntaxError(f"unexpected token {t.value!r} at {t.pos}")

    def _ident_or_call(self, name: str):
        if name in RESERVED:
            raise CelSyntaxError(f"reserved identifier {name!r}")
        if self.accept("PUNCT", "("):
            args = self.expr_list(")")
            if name == "has":
                if len(args) != 1 or args[0][0] not in ("select", "opt_select"):
                    raise CelSyntaxError("has() requires a field selection argument")
                return ("has", args[0][1], args[0][2])
            return ("call", name, args)
        return ("ident", name)

    def map_inits(self) -> List[Tuple[Any, Any]]:
        items: List[Tuple[Any, Any]] = []
        if self.accept("PUNCT", "}"):
            return items
        while True:
            optional = False
            if self.peek().kind == "PUNCT" and self.peek().value == "?":
                self.next()
                optional = True
            k = self.expr()
            self.expect("PUNCT", ":")
            v = self.expr()
            items.append((("opt", k) if optional else k, v))
            if self.accept("PUNCT", ","):
                if self.accept("PUNCT", "}"):
                    return items
                continue
            self.expect("PUNCT", "}")
            return items


def parse(src: str):
    try:
        return Parser(tokenize(src)).parse()
    except RecursionError:
        # thousands of nested parens must surface as a per-expression
        # compile error (CelValidator's eager-compile catch), not
        # escape as a whole-request exception handled by failurePolicy
        raise CelSyntaxError("expression nesting too deep")
