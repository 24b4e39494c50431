# Copied verbatim from kyverno_tpu/engine/jmespath/interpreter.py.
"""JMESPath tree interpreter."""

from __future__ import annotations

from .errors import JMESPathTypeError, UnknownFunctionError
from .functions import FUNCTION_TABLE, call_function


def _is_false(value) -> bool:
    # JMESPath truthiness: empty list/dict/string, False, None are false;
    # numbers (including 0) are true.
    return value is None or value is False or value == [] or value == {} or value == ""


def _equals(x, y) -> bool:
    # strict equality; bool is not equal to 0/1
    if isinstance(x, bool) != isinstance(y, bool):
        return False
    if type(x) in (int, float) and type(y) in (int, float):
        return x == y
    if type(x) is not type(y):
        return False
    return x == y


class _ExpRef:
    __slots__ = ("node", "interpreter")

    def __init__(self, node, interpreter):
        self.node = node
        self.interpreter = interpreter

    def visit(self, value):
        return self.interpreter.visit(self.node, value)


class TreeInterpreter:
    def visit(self, node, value):
        method = getattr(self, "_visit_" + node[0])
        return method(node, value)

    def _visit_field(self, node, value):
        try:
            return value.get(node[1])
        except AttributeError:
            return None

    def _visit_subexpression(self, node, value):
        result = self.visit(node[1], value)
        if result is None:
            return None
        return self.visit(node[2], result)

    def _visit_pipe(self, node, value):
        return self.visit(node[2], self.visit(node[1], value))

    def _visit_index(self, node, value):
        if not isinstance(value, list):
            return None
        try:
            return value[node[1]]
        except IndexError:
            return None

    def _visit_slice(self, node, value):
        if not isinstance(value, list):
            return None
        if node[3] == 0:
            raise JMESPathTypeError("slice", 0, "number", ["non-zero step"])
        return value[slice(node[1], node[2], node[3])]

    def _visit_index_expression(self, node, value):
        result = value
        for child in node[1]:
            result = self.visit(child, result)
        return result

    def _visit_projection(self, node, value):
        base = self.visit(node[1], value)
        if not isinstance(base, list):
            return None
        collected = []
        for element in base:
            current = self.visit(node[2], element)
            if current is not None:
                collected.append(current)
        return collected

    def _visit_value_projection(self, node, value):
        base = self.visit(node[1], value)
        try:
            base = list(base.values())
        except AttributeError:
            return None
        collected = []
        for element in base:
            current = self.visit(node[2], element)
            if current is not None:
                collected.append(current)
        return collected

    def _visit_filter_projection(self, node, value):
        base = self.visit(node[1], value)
        if not isinstance(base, list):
            return None
        collected = []
        for element in base:
            if not _is_false(self.visit(node[3], element)):
                current = self.visit(node[2], element)
                if current is not None:
                    collected.append(current)
        return collected

    def _visit_flatten(self, node, value):
        base = self.visit(node[1], value)
        if not isinstance(base, list):
            return None
        merged = []
        for element in base:
            if isinstance(element, list):
                merged.extend(element)
            else:
                merged.append(element)
        return merged

    def _visit_identity(self, node, value):
        return value

    def _visit_current(self, node, value):
        return value

    def _visit_literal(self, node, value):
        return node[1]

    def _visit_comparator(self, node, value):
        op = node[1]
        left = self.visit(node[2], value)
        right = self.visit(node[3], value)
        if op == "eq":
            return _equals(left, right)
        if op == "ne":
            return not _equals(left, right)
        # ordering operators only apply to numbers
        if not isinstance(left, (int, float)) or isinstance(left, bool):
            return None
        if not isinstance(right, (int, float)) or isinstance(right, bool):
            return None
        if op == "lt":
            return left < right
        if op == "lte":
            return left <= right
        if op == "gt":
            return left > right
        return left >= right

    def _visit_or(self, node, value):
        matched = self.visit(node[1], value)
        if _is_false(matched):
            return self.visit(node[2], value)
        return matched

    def _visit_and(self, node, value):
        matched = self.visit(node[1], value)
        if _is_false(matched):
            return matched
        return self.visit(node[2], value)

    def _visit_not(self, node, value):
        return _is_false(self.visit(node[1], value))

    def _visit_multiselect_list(self, node, value):
        if value is None:
            return None
        return [self.visit(child, value) for child in node[1]]

    def _visit_multiselect_dict(self, node, value):
        if value is None:
            return None
        return {key: self.visit(child, value) for key, child in node[1]}

    def _visit_expref(self, node, value):
        return _ExpRef(node[1], self)

    def _visit_function(self, node, value):
        name = node[1]
        if name not in FUNCTION_TABLE:
            raise UnknownFunctionError(f"Unknown function: {name}()")
        args = [self.visit(arg, value) for arg in node[2]]
        return call_function(name, args)
