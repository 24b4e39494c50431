# Copied verbatim from kyverno_tpu/engine/jmespath/parser.py.
"""JMESPath Pratt parser producing a tuple-based AST.

AST node shapes (first element is the node type):
  ('field', name) ('subexpression', parent, child) ('index', i)
  ('slice', start, stop, step) ('projection', left, right)
  ('flatten', node) ('value_projection', left, right)
  ('filter_projection', left, right, condition)
  ('comparator', op, left, right) ('or', l, r) ('and', l, r) ('not', n)
  ('identity',) ('literal', value) ('multiselect_list', [nodes])
  ('multiselect_dict', [(key, node), ...]) ('function', name, [args])
  ('expref', node) ('current',) ('pipe', l, r) ('index_expression', [l, r])
"""

from __future__ import annotations

from .errors import IncompleteExpressionError, ParseError
from .lexer import Lexer

BINDING_POWER = {
    "eof": 0,
    "unquoted_identifier": 0,
    "quoted_identifier": 0,
    "literal": 0,
    "rbracket": 0,
    "rparen": 0,
    "comma": 0,
    "rbrace": 0,
    "number": 0,
    "current": 0,
    "expref": 0,
    "colon": 0,
    "pipe": 1,
    "or": 2,
    "and": 3,
    "eq": 5,
    "gt": 5,
    "lt": 5,
    "gte": 5,
    "lte": 5,
    "ne": 5,
    "flatten": 9,
    "star": 20,
    "filter": 21,
    "dot": 40,
    "not": 45,
    "lbrace": 50,
    "lbracket": 55,
    "lparen": 60,
}

PROJECTION_STOP = 10


class Parser:
    def parse(self, expression: str):
        self._tokens = list(Lexer().tokenize(expression))
        self._index = 0
        parsed = self._expression(0)
        if self._current_type() != "eof":
            t = self._lookahead_token(0)
            raise ParseError(t["start"], t["value"])
        return parsed

    # -- token plumbing

    def _current_type(self):
        return self._tokens[self._index]["type"]

    def _lookahead(self, n):
        return self._tokens[self._index + n]["type"]

    def _lookahead_token(self, n):
        return self._tokens[self._index + n]

    def _advance(self):
        self._index += 1

    def _match(self, token_type):
        if self._current_type() == token_type:
            self._advance()
        else:
            t = self._lookahead_token(0)
            if t["type"] == "eof":
                raise IncompleteExpressionError(t["start"], t["value"])
            raise ParseError(t["start"], t["value"], f"expected {token_type}")

    def _match_multiple(self, *token_types):
        if self._current_type() in token_types:
            self._advance()
        else:
            t = self._lookahead_token(0)
            raise ParseError(t["start"], t["value"], f"expected one of {token_types}")

    # -- Pratt core

    def _expression(self, binding_power=0):
        left_token = self._lookahead_token(0)
        self._advance()
        left = self._nud(left_token)
        while binding_power < BINDING_POWER[self._current_type()]:
            token = self._lookahead_token(0)
            self._advance()
            left = self._led(token, left)
        return left

    # -- prefix handlers

    def _nud(self, token):
        ttype = token["type"]
        if ttype == "literal":
            return ("literal", token["value"])
        if ttype == "unquoted_identifier":
            return ("field", token["value"])
        if ttype == "quoted_identifier":
            field = ("field", token["value"])
            if self._current_type() == "lparen":
                t = self._lookahead_token(0)
                raise ParseError(t["start"], t["value"], "quoted identifier not allowed for function names")
            return field
        if ttype == "star":
            left = ("identity",)
            if self._current_type() == "rbracket":
                right = ("identity",)
            else:
                right = self._parse_projection_rhs(BINDING_POWER["star"])
            return ("value_projection", left, right)
        if ttype == "filter":
            return self._parse_filter(("identity",))
        if ttype == "lbrace":
            return self._parse_multiselect_hash()
        if ttype == "flatten":
            left = ("flatten", ("identity",))
            right = self._parse_projection_rhs(BINDING_POWER["flatten"])
            return ("projection", left, right)
        if ttype == "lbracket":
            if self._current_type() in ("number", "colon"):
                right = self._parse_index_expression()
                return self._project_if_slice(("identity",), right)
            if self._current_type() == "star" and self._lookahead(1) == "rbracket":
                self._advance()
                self._advance()
                right = self._parse_projection_rhs(BINDING_POWER["star"])
                return ("projection", ("identity",), right)
            return self._parse_multiselect_list()
        if ttype == "current":
            return ("current",)
        if ttype == "expref":
            return ("expref", self._expression(BINDING_POWER["expref"]))
        if ttype == "not":
            return ("not", self._expression(BINDING_POWER["not"]))
        if ttype == "lparen":
            expression = self._expression(0)
            self._match("rparen")
            return expression
        if ttype == "eof":
            raise IncompleteExpressionError(token["start"], token["value"])
        raise ParseError(token["start"], token["value"])

    # -- infix handlers

    def _led(self, token, left):
        ttype = token["type"]
        if ttype == "dot":
            if self._current_type() != "star":
                right = self._parse_dot_rhs(BINDING_POWER["dot"])
                return ("subexpression", left, right)
            # creates a value projection: foo.*
            self._advance()
            right = self._parse_projection_rhs(BINDING_POWER["dot"])
            return ("value_projection", left, right)
        if ttype == "pipe":
            right = self._expression(BINDING_POWER["pipe"])
            return ("pipe", left, right)
        if ttype == "or":
            right = self._expression(BINDING_POWER["or"])
            return ("or", left, right)
        if ttype == "and":
            right = self._expression(BINDING_POWER["and"])
            return ("and", left, right)
        if ttype == "lparen":
            if left[0] != "field":
                prev = self._lookahead_token(-2)
                raise ParseError(prev["start"], prev["value"], "invalid function name")
            name = left[1]
            args = []
            while self._current_type() != "rparen":
                args.append(self._expression(0))
                if self._current_type() == "comma":
                    self._match("comma")
            self._match("rparen")
            return ("function", name, args)
        if ttype == "filter":
            return self._parse_filter(left)
        if ttype == "eq":
            return self._parse_comparator(left, "eq")
        if ttype == "ne":
            return self._parse_comparator(left, "ne")
        if ttype == "gt":
            return self._parse_comparator(left, "gt")
        if ttype == "gte":
            return self._parse_comparator(left, "gte")
        if ttype == "lt":
            return self._parse_comparator(left, "lt")
        if ttype == "lte":
            return self._parse_comparator(left, "lte")
        if ttype == "flatten":
            new_left = ("flatten", left)
            right = self._parse_projection_rhs(BINDING_POWER["flatten"])
            return ("projection", new_left, right)
        if ttype == "lbracket":
            if self._current_type() in ("number", "colon"):
                right = self._parse_index_expression()
                return self._project_if_slice(left, right)
            if self._current_type() == "star" and self._lookahead(1) == "rbracket":
                self._advance()
                self._advance()
                right = self._parse_projection_rhs(BINDING_POWER["star"])
                return ("projection", left, right)
            t = self._lookahead_token(0)
            raise ParseError(t["start"], t["value"], "expected number, colon or star")
        raise ParseError(token["start"], token["value"])

    # -- grammar pieces

    def _parse_comparator(self, left, op):
        right = self._expression(BINDING_POWER[op])
        return ("comparator", op, left, right)

    def _parse_index_expression(self):
        # either [number], [number:number:number] or variants
        if self._lookahead(0) == "colon" or self._lookahead(1) == "colon":
            return self._parse_slice_expression()
        node = ("index", self._lookahead_token(0)["value"])
        self._advance()
        self._match("rbracket")
        return node

    def _parse_slice_expression(self):
        parts = [None, None, None]
        index = 0
        current = self._current_type()
        while current != "rbracket" and index < 3:
            if current == "colon":
                index += 1
                if index == 3:
                    t = self._lookahead_token(0)
                    raise ParseError(t["start"], t["value"], "too many colons in slice")
                self._advance()
            elif current == "number":
                parts[index] = self._lookahead_token(0)["value"]
                self._advance()
            else:
                t = self._lookahead_token(0)
                raise ParseError(t["start"], t["value"], "expected colon or number")
            current = self._current_type()
        self._match("rbracket")
        return ("slice", parts[0], parts[1], parts[2])

    def _project_if_slice(self, left, right):
        index_expr = ("index_expression", [left, right])
        if right[0] == "slice":
            return ("projection", index_expr, self._parse_projection_rhs(BINDING_POWER["star"]))
        return index_expr

    def _parse_filter(self, left):
        condition = self._expression(0)
        self._match("rbracket")
        if self._current_type() == "flatten":
            right = ("identity",)
        else:
            right = self._parse_projection_rhs(BINDING_POWER["filter"])
        return ("filter_projection", left, right, condition)

    def _parse_multiselect_list(self):
        expressions = []
        while True:
            expressions.append(self._expression(0))
            if self._current_type() == "rbracket":
                break
            self._match("comma")
        self._match("rbracket")
        return ("multiselect_list", expressions)

    def _parse_multiselect_hash(self):
        pairs = []
        while True:
            key_token = self._lookahead_token(0)
            self._match_multiple("quoted_identifier", "unquoted_identifier")
            key_name = key_token["value"]
            self._match("colon")
            value = self._expression(0)
            pairs.append((key_name, value))
            if self._current_type() == "comma":
                self._match("comma")
            elif self._current_type() == "rbrace":
                self._match("rbrace")
                break
        return ("multiselect_dict", pairs)

    def _parse_projection_rhs(self, binding_power):
        current = self._current_type()
        if BINDING_POWER[current] < PROJECTION_STOP:
            return ("identity",)
        if current == "lbracket":
            return self._expression(binding_power)
        if current == "filter":
            return self._expression(binding_power)
        if current == "dot":
            self._match("dot")
            return self._parse_dot_rhs(binding_power)
        t = self._lookahead_token(0)
        raise ParseError(t["start"], t["value"], "syntax error after projection")

    def _parse_dot_rhs(self, binding_power):
        lookahead = self._current_type()
        if lookahead in ("quoted_identifier", "unquoted_identifier", "star"):
            return self._expression(binding_power)
        if lookahead == "lbracket":
            self._match("lbracket")
            return self._parse_multiselect_list()
        if lookahead == "lbrace":
            self._match("lbrace")
            return self._parse_multiselect_hash()
        t = self._lookahead_token(0)
        raise ParseError(t["start"], t["value"], "expected identifier, '[', '{' or '*' after '.'")
