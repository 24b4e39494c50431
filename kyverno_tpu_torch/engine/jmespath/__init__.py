# Copied verbatim from kyverno_tpu/engine/jmespath/__init__.py.
"""JMESPath engine with Kyverno's custom function library.

The reference forks go-jmespath and registers ~50 custom functions
(pkg/engine/jmespath/functions.go:45-81, time.go:11-22). This package
is a from-scratch Python implementation of the JMESPath grammar (lexer
+ Pratt parser + tree interpreter) with the same custom functions, used
by the JSON context, variable substitution, preconditions and the
``jp`` CLI command.
"""

from .errors import JMESPathError, JMESPathTypeError, UnknownFunctionError
from .interpreter import TreeInterpreter
from .parser import Parser

_parser = Parser()


class Expression:
    def __init__(self, ast, expression: str):
        self.ast = ast
        self.expression = expression

    def search(self, data):
        return TreeInterpreter().visit(self.ast, data)


def compile(expression: str) -> Expression:  # noqa: A001 - mirrors jmespath API
    return Expression(_parser.parse(expression), expression)


def search(expression: str, data):
    return compile(expression).search(data)


__all__ = [
    "Expression",
    "JMESPathError",
    "JMESPathTypeError",
    "UnknownFunctionError",
    "compile",
    "search",
]
