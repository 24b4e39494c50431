# Copied verbatim from kyverno_tpu/cel/__init__.py.
"""CEL expression engine (host plane).

Independent implementation of the CEL subset Kubernetes admission
uses — the reference evaluates these through cel-go + k8s libraries
(pkg/engine/handlers/validation/validate_cel.go:34,
pkg/validatingadmissionpolicy/validate.go:66). Expressions compile
once (parse -> tuple AST) and evaluate against per-request variable
environments (object/oldObject/request/params/namespaceObject/
variables.*)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .errors import CelError, CelSyntaxError
from .interp import Env, Optional_, base_env, evaluate
from .parser import parse


class Program:
    """A compiled CEL expression."""

    def __init__(self, source: str):
        self.source = source
        self.ast = parse(source)

    def evaluate(self, variables: Dict[str, Any]) -> Any:
        return evaluate(self.ast, base_env(variables))


_cache: Dict[str, Program] = {}


def compile(source: str) -> Program:  # noqa: A001 - mirrors cel API
    prog = _cache.get(source)
    if prog is None:
        prog = Program(source)
        if len(_cache) > 4096:
            _cache.clear()
        _cache[source] = prog
    return prog


def eval_expression(source: str, variables: Dict[str, Any]) -> Any:
    return compile(source).evaluate(variables)


__all__ = ["CelError", "CelSyntaxError", "Program", "compile",
           "eval_expression", "Env", "Optional_", "base_env", "evaluate",
           "parse"]
