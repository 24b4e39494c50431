# Copied verbatim from kyverno_tpu/engine/jmespath/lexer.py.
"""JMESPath lexer (per the jmespath.org grammar)."""

from __future__ import annotations

import json
import string
from typing import Iterator

from .errors import LexerError

START_IDENTIFIER = set(string.ascii_letters + "_")
VALID_IDENTIFIER = set(string.ascii_letters + string.digits + "_")
VALID_NUMBER = set(string.digits)
WHITESPACE = set(" \t\n\r")
SIMPLE_TOKENS = {
    ".": "dot",
    "*": "star",
    ",": "comma",
    ":": "colon",
    "@": "current",
    "(": "lparen",
    ")": "rparen",
    "{": "lbrace",
    "}": "rbrace",
    "]": "rbracket",
}


class Lexer:
    def tokenize(self, expression: str) -> Iterator[dict]:
        self._expr = expression
        self._position = 0
        self._chars = list(expression)
        self._length = len(expression)
        if self._length == 0:
            raise LexerError(0, "", "empty expression")
        self._current = self._chars[0]
        while self._current is not None:
            c = self._current
            if c in SIMPLE_TOKENS:
                yield self._tok(SIMPLE_TOKENS[c], c)
                self._next()
            elif c in START_IDENTIFIER:
                yield self._consume_identifier()
            elif c in WHITESPACE:
                self._next()
            elif c == "[":
                yield self._consume_lbracket()
            elif c == "'":
                yield self._consume_raw_string()
            elif c == "|":
                yield self._consume_alt("|", "or", "pipe")
            elif c == "&":
                yield self._consume_alt("&", "and", "expref")
            elif c == "`":
                yield self._consume_literal()
            elif c in VALID_NUMBER or c == "-":
                yield self._consume_number()
            elif c == '"':
                yield self._consume_quoted_identifier()
            elif c == "<":
                yield self._consume_cmp("<", "lte", "lt")
            elif c == ">":
                yield self._consume_cmp(">", "gte", "gt")
            elif c == "!":
                yield self._consume_cmp("!", "ne", "not")
            elif c == "=":
                start = self._position
                self._next()
                if self._current == "=":
                    yield self._tok_at("eq", "==", start)
                    self._next()
                else:
                    raise LexerError(start, "=", "'=' is not valid, did you mean '=='")
            else:
                raise LexerError(self._position, c, "unknown token")
        yield self._tok("eof", "")

    # -- helpers

    def _tok(self, type_, value):
        return {"type": type_, "value": value, "start": self._position, "end": self._position + max(len(str(value)), 1)}

    def _tok_at(self, type_, value, start):
        return {"type": type_, "value": value, "start": start, "end": start + len(str(value))}

    def _next(self):
        self._position += 1
        if self._position >= self._length:
            self._current = None
        else:
            self._current = self._chars[self._position]
        return self._current

    def _consume_identifier(self):
        start = self._position
        buf = [self._current]
        while self._next() is not None and self._current in VALID_IDENTIFIER:
            buf.append(self._current)
        return self._tok_at("unquoted_identifier", "".join(buf), start)

    def _consume_number(self):
        start = self._position
        buf = [self._current]
        while self._next() is not None and self._current in VALID_NUMBER:
            buf.append(self._current)
        value = "".join(buf)
        if value == "-":
            raise LexerError(start, value, "invalid number")
        return self._tok_at("number", int(value), start)

    def _consume_lbracket(self):
        start = self._position
        nxt = self._next()
        if nxt == "]":
            self._next()
            return self._tok_at("flatten", "[]", start)
        if nxt == "?":
            self._next()
            return self._tok_at("filter", "[?", start)
        return self._tok_at("lbracket", "[", start)

    def _consume_alt(self, char, double_type, single_type):
        start = self._position
        if self._next() == char:
            self._next()
            return self._tok_at(double_type, char * 2, start)
        return self._tok_at(single_type, char, start)

    def _consume_cmp(self, char, eq_type, bare_type):
        start = self._position
        if self._next() == "=":
            self._next()
            return self._tok_at(eq_type, char + "=", start)
        return self._tok_at(bare_type, char, start)

    def _consume_until(self, delimiter):
        start = self._position
        buf = []
        self._next()
        while self._current != delimiter:
            if self._current == "\\":
                buf.append(self._current)
                self._next()
            if self._current is None:
                raise LexerError(start, "".join(buf), f"unclosed {delimiter} delimiter")
            buf.append(self._current)
            self._next()
        self._next()  # skip closing delimiter
        return "".join(buf)

    def _consume_raw_string(self):
        start = self._position
        lexeme = self._consume_until("'").replace("\\'", "'").replace("\\\\", "\\")
        return self._tok_at("literal", lexeme, start)

    def _consume_quoted_identifier(self):
        start = self._position
        lexeme = '"' + self._consume_until('"') + '"'
        try:
            return self._tok_at("quoted_identifier", json.loads(lexeme), start)
        except ValueError as e:
            raise LexerError(start, lexeme, f"invalid quoted identifier: {e}")

    def _consume_literal(self):
        start = self._position
        lexeme = self._consume_until("`").replace("\\`", "`")
        try:
            parsed = json.loads(lexeme)
        except ValueError:
            # elided-quotes legacy form: `foo` == `"foo"`
            try:
                parsed = json.loads('"%s"' % lexeme.lstrip())
            except ValueError:
                raise LexerError(start, lexeme, "bad JSON literal")
        return self._tok_at("literal", parsed, start)
