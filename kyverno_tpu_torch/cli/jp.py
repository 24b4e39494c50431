# Copied verbatim from kyverno_tpu/cli/jp.py.
"""`jp` — JMESPath playground (cmd/cli/kubectl-kyverno/commands/jp)."""

from __future__ import annotations

import argparse
import json
import sys

import yaml


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("jp", help="evaluate JMESPath expressions")
    ps = p.add_subparsers(dest="jp_cmd", required=True)

    q = ps.add_parser("query", help="evaluate a query against input JSON/YAML")
    q.add_argument("expression")
    q.add_argument("--input", "-i", default="-", help="input file (default stdin)")
    q.set_defaults(func=run_query)

    f = ps.add_parser("function", help="list custom functions")
    f.add_argument("name", nargs="?", help="filter by name substring")
    f.set_defaults(func=run_function)

    pp = ps.add_parser("parse", help="parse an expression to its AST")
    pp.add_argument("expression")
    pp.set_defaults(func=run_parse)


def run_query(args: argparse.Namespace) -> int:
    from ..engine.jmespath import search

    try:
        text = sys.stdin.read() if args.input == "-" else open(args.input).read()
    except OSError as e:
        print(f"error: cannot read {args.input}: {e}", file=sys.stderr)
        return 1
    try:
        data = yaml.safe_load(text)
    except yaml.YAMLError as e:
        print(f"error: invalid input document: {e}", file=sys.stderr)
        return 1
    try:
        result = search(args.expression, data)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2, default=str))
    return 0


def run_function(args: argparse.Namespace) -> int:
    from ..engine.jmespath.functions import FUNCTION_TABLE

    for name in sorted(FUNCTION_TABLE):
        if args.name and args.name not in name:
            continue
        print(name)
    return 0


def run_parse(args: argparse.Namespace) -> int:
    from ..engine.jmespath.parser import Parser

    try:
        ast = Parser().parse(args.expression)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(_ast_to_json(ast), indent=2))
    return 0


def _ast_to_json(node):
    if isinstance(node, tuple):
        return [node[0]] + [_ast_to_json(x) for x in node[1:]]
    if isinstance(node, list):
        return [_ast_to_json(x) for x in node]
    return node
