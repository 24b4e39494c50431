# Copied verbatim from kyverno_tpu/cel/interp.py.
"""CEL evaluator over the tuple AST.

Semantics follow cel-spec (langdef.md) as configured by Kubernetes
admission (cross-type numeric comparisons on, heterogeneous equality
on, the optional-types library on):

- ``&&``/``||`` and the all/exists macros are commutative and absorb
  errors when the other operand determines the result;
- int arithmetic is int64 with overflow errors; ``/`` and ``%`` on ints
  are integer ops erroring on zero; doubles follow IEEE;
- equality across unrelated types is ``false`` (never an error);
  numerics compare by value (1 == 1.0);
- field selection on a map requires presence (no_such_field error) —
  ``has()`` / optionals are the presence idioms;
- strings are unicode; ``size`` counts code points.

Values are plain Python JSON values (None/bool/int/float/str/bytes/
list/dict) plus Optional / CelType wrappers."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

from .re2 import Re2Error
from .re2 import search as _re2_search
from .errors import CelError, no_such_overload, type_name

INT_MIN, INT_MAX = -(2**63), 2**63 - 1


class Optional_:
    """CEL optional_type value (k8s enables the optionals library)."""

    __slots__ = ("present", "val")

    def __init__(self, present: bool, val: Any = None):
        self.present = present
        self.val = val

    def __eq__(self, other):
        if not isinstance(other, Optional_):
            return NotImplemented
        if not self.present or not other.present:
            return self.present == other.present
        return _eq(self.val, other.val)

    def __repr__(self):
        return f"optional.of({self.val!r})" if self.present else "optional.none()"


OPT_NONE = Optional_(False)


class CelType:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __eq__(self, other):
        return isinstance(other, CelType) and self.name == other.name

    def __hash__(self):
        return hash(("CelType", self.name))

    def __repr__(self):
        return self.name


def _check_int(v: int) -> int:
    if not (INT_MIN <= v <= INT_MAX):
        raise CelError("return error for overflow")
    return v


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _eq(a, b) -> bool:
    """Heterogeneous equality: numerics by value, others structurally,
    mismatched types false."""
    if _is_num(a) and _is_num(b):
        return a == b
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if type(a) is not type(b):
        if isinstance(a, Optional_) or isinstance(b, Optional_):
            return isinstance(a, Optional_) and isinstance(b, Optional_) and a == b
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        if len(a) != len(b):
            return False
        return all(k in b and _eq(v, b[k]) for k, v in a.items())
    return a == b


def _cmp(op: str, a, b) -> bool:
    if _is_num(a) and _is_num(b):
        pass  # cross-type numeric comparison enabled
    elif isinstance(a, bool) and isinstance(b, bool):
        pass
    elif isinstance(a, str) and isinstance(b, str):
        pass
    elif isinstance(a, bytes) and isinstance(b, bytes):
        pass
    else:
        raise no_such_overload(op, a, b)
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


class Env:
    """Variable bindings; child scopes for macro iteration vars."""

    __slots__ = ("vars", "parent")

    def __init__(self, vars: Dict[str, Any], parent: "Env" = None):
        self.vars = vars
        self.parent = parent

    def lookup(self, name: str):
        e = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        raise CelError(f"undeclared reference to '{name}'")

    def child(self, name: str, value: Any) -> "Env":
        return Env({name: value}, self)


def evaluate(ast, env: Env) -> Any:
    return _eval(ast, env)


def _truth(v) -> bool:
    if isinstance(v, bool):
        return v
    raise no_such_overload("bool", v)


def _eval(node, env: Env) -> Any:
    tag = node[0]
    if tag == "lit":
        return node[1]
    if tag == "ident":
        return env.lookup(node[1])
    if tag == "select":
        target = _eval(node[1], env)
        return _select(target, node[2])
    if tag == "opt_select":
        target = _eval(node[1], env)
        if isinstance(target, Optional_):
            if not target.present:
                return OPT_NONE
            target = target.val
        if isinstance(target, dict):
            return Optional_(True, target[node[2]]) if node[2] in target else OPT_NONE
        raise no_such_overload("?.", target)
    if tag == "index":
        return _index(_eval(node[1], env), _eval(node[2], env))
    if tag == "list":
        return [_eval(e, env) for e in node[1]]
    if tag == "map":
        out = {}
        for k, v in node[1]:
            if isinstance(k, tuple) and k[0] == "opt":
                val = _eval(v, env)
                if isinstance(val, Optional_):
                    if not val.present:
                        continue
                    val = val.val
                out[_map_key(_eval(k[1], env))] = val
            else:
                out[_map_key(_eval(k, env))] = _eval(v, env)
        return out
    if tag == "cond":
        return _eval(node[2] if _truth(_eval(node[1], env)) else node[3], env)
    if tag == "or":
        return _logic(node, env, True)
    if tag == "and":
        return _logic(node, env, False)
    if tag == "not":
        return not _truth(_eval(node[1], env))
    if tag == "neg":
        v = _eval(node[1], env)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise no_such_overload("-", v)
        return _check_int(-v) if isinstance(v, int) else -v
    if tag == "binop":
        return _binop(node[1], _eval(node[2], env), _eval(node[3], env))
    if tag == "has":
        return _has(node, env)
    if tag == "call":
        return _call(node[1], [_eval(a, env) for a in node[2]], env)
    if tag == "method":
        target = _eval(node[1], env)
        # optional chaining terminators evaluate on the Optional itself
        if node[2] in ("orValue", "hasValue", "value", "optMap", "optFlatMap"):
            return _optional_method(target, node[2], node[3], env)
        return _method(target, node[2], [_eval(a, env) for a in node[3]])
    if tag == "macro":
        return _macro(node, env)
    raise CelError(f"unknown AST node {tag}")


def _logic(node, env: Env, is_or: bool):
    try:
        left = _truth(_eval(node[1], env))
        if left is is_or:
            return is_or
    except CelError as e:
        left = e
    try:
        right = _truth(_eval(node[2], env))
        if right is is_or:
            return is_or
    except CelError as e:
        right = e
    if isinstance(left, CelError):
        raise left
    if isinstance(right, CelError):
        raise right
    return not is_or


def _select(target, field: str):
    if isinstance(target, Optional_):
        if not target.present:
            return OPT_NONE
        target = target.val
        if isinstance(target, dict):
            return Optional_(True, target[field]) if field in target else OPT_NONE
        raise no_such_overload(".", target)
    if isinstance(target, dict):
        if field in target:
            return target[field]
        raise CelError(f"no_such_field '{field}'")
    raise no_such_overload(".", target)


def _has(node, env: Env) -> bool:
    try:
        target = _eval(node[1], env)
    except CelError:
        raise
    if isinstance(target, Optional_):
        target = target.val if target.present else None
    if isinstance(target, dict):
        return node[2] in target
    if target is None:
        raise CelError("no_such_field")
    raise no_such_overload("has", target)


def _map_key(k):
    if isinstance(k, (bool, int, str)):
        return k
    raise no_such_overload("map key", k)


def _index(target, key):
    if isinstance(target, list):
        if isinstance(key, bool) or not isinstance(key, int):
            if isinstance(key, float) and key == int(key):
                key = int(key)
            else:
                raise no_such_overload("[]", target, key)
        if 0 <= key < len(target):
            return target[key]
        raise CelError(f"index out of bounds: {key}")
    if isinstance(target, dict):
        k = _map_key(key)
        if k in target:
            return target[k]
        raise CelError(f"no such key: {key!r}")
    if isinstance(target, Optional_):
        if not target.present:
            return OPT_NONE
        inner = target.val
        if isinstance(inner, (list, dict)):
            try:
                return Optional_(True, _index(inner, key))
            except CelError:
                return OPT_NONE
        raise no_such_overload("[]", inner)
    raise no_such_overload("[]", target, key)


def _binop(op: str, l, r):
    if op == "==":
        return _eq(l, r)
    if op == "!=":
        return not _eq(l, r)
    if op in ("<", "<=", ">", ">="):
        return _cmp(op, l, r)
    if op == "in":
        if isinstance(r, list):
            return any(_eq(l, x) for x in r)
        if isinstance(r, dict):
            try:
                return _map_key(l) in r
            except CelError:
                return False
        raise no_such_overload("in", l, r)
    if op == "+":
        if isinstance(l, bool) or isinstance(r, bool):
            raise no_such_overload("+", l, r)
        if isinstance(l, int) and isinstance(r, int):
            return _check_int(l + r)
        if _is_num(l) and _is_num(r) and (isinstance(l, float) or isinstance(r, float)):
            return float(l) + float(r)
        if isinstance(l, str) and isinstance(r, str):
            return l + r
        if isinstance(l, bytes) and isinstance(r, bytes):
            return l + r
        if isinstance(l, list) and isinstance(r, list):
            return l + r
        raise no_such_overload("+", l, r)
    if op == "-":
        if isinstance(l, bool) or isinstance(r, bool) or not (_is_num(l) and _is_num(r)):
            raise no_such_overload("-", l, r)
        if isinstance(l, int) and isinstance(r, int):
            return _check_int(l - r)
        return float(l) - float(r)
    if op == "*":
        if isinstance(l, bool) or isinstance(r, bool) or not (_is_num(l) and _is_num(r)):
            raise no_such_overload("*", l, r)
        if isinstance(l, int) and isinstance(r, int):
            return _check_int(l * r)
        return float(l) * float(r)
    if op == "/":
        if isinstance(l, bool) or isinstance(r, bool) or not (_is_num(l) and _is_num(r)):
            raise no_such_overload("/", l, r)
        if isinstance(l, int) and isinstance(r, int):
            if r == 0:
                raise CelError("division by zero")
            q = abs(l) // abs(r)  # Go truncates toward zero
            return _check_int(q if (l >= 0) == (r >= 0) else -q)
        if float(r) == 0.0:
            return math.inf if float(l) > 0 else (-math.inf if float(l) < 0 else math.nan)
        return float(l) / float(r)
    if op == "%":
        if isinstance(l, int) and isinstance(r, int) and not isinstance(l, bool) and not isinstance(r, bool):
            if r == 0:
                raise CelError("modulus by zero")
            q = abs(l) // abs(r)  # truncated division like Go
            if (l >= 0) != (r >= 0):
                q = -q
            return l - r * q
        raise no_such_overload("%", l, r)
    raise CelError(f"unknown operator {op}")


def _size(v):
    if isinstance(v, (str, bytes, list, dict)):
        return len(v)
    raise no_such_overload("size", v)


def _to_int(v):
    if isinstance(v, bool):
        raise no_such_overload("int", v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if math.isnan(v) or v >= 2**63 or v < -(2**63):
            raise CelError("integer overflow")
        return int(v)
    if isinstance(v, str):
        try:
            return _check_int(int(v.strip(), 10))
        except ValueError:
            raise CelError(f"cannot convert '{v}' to int")
    raise no_such_overload("int", v)


def _to_double(v):
    if isinstance(v, bool):
        raise no_such_overload("double", v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            raise CelError(f"cannot convert '{v}' to double")
    raise no_such_overload("double", v)


def _to_string(v):
    if isinstance(v, str):
        return v
    if isinstance(v, CelType):
        return v.name
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            raise CelError("invalid UTF-8 in bytes")
    raise no_such_overload("string", v)


def _to_bool(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        low = v.lower()
        if low in ("true", "t", "1"):
            return True
        if low in ("false", "f", "0"):
            return False
        raise CelError(f"cannot convert '{v}' to bool")
    raise no_such_overload("bool", v)


def _type_of(v) -> CelType:
    return CelType(type_name(v) if not isinstance(v, CelType) else "type")


def _call(name: str, args: List[Any], env: Env):
    if name == "size" and len(args) == 1:
        return _size(args[0])
    if name == "int" and len(args) == 1:
        return _to_int(args[0])
    if name == "uint" and len(args) == 1:
        return _to_int(args[0])
    if name == "double" and len(args) == 1:
        return _to_double(args[0])
    if name == "string" and len(args) == 1:
        return _to_string(args[0])
    if name == "bool" and len(args) == 1:
        return _to_bool(args[0])
    if name == "bytes" and len(args) == 1:
        if isinstance(args[0], bytes):
            return args[0]
        if isinstance(args[0], str):
            return args[0].encode("utf-8")
        raise no_such_overload("bytes", args[0])
    if name == "type" and len(args) == 1:
        return _type_of(args[0])
    if name == "dyn" and len(args) == 1:
        return args[0]
    if name == "matches" and len(args) == 2:
        return _method(args[0], "matches", [args[1]])
    # the k8s 'optional' namespace arrives as select-on-ident calls —
    # handled in _method via the 'optional' pseudo-target
    try:
        fn = env.lookup(name)
    except CelError:
        raise CelError(f"unknown function '{name}'")
    if callable(fn):
        return fn(*args)
    raise CelError(f"'{name}' is not callable")


_OPTIONAL_NS = CelType("optional-namespace")


def _method(target, name: str, args: List[Any]):
    # optional.of / optional.none / optional.ofNonZeroValue
    if isinstance(target, CelType) and target.name == "optional-namespace":
        if name == "of":
            return Optional_(True, args[0])
        if name == "none":
            return OPT_NONE
        if name == "ofNonZeroValue":
            v = args[0]
            zero = v is None or v == 0 or v == "" or v == [] or v == {} or v is False
            return Optional_(not zero, None if zero else v)
        raise CelError(f"unknown optional function '{name}'")
    if name == "size":
        return _size(target)
    if name == "contains":
        if isinstance(target, str) and len(args) == 1 and isinstance(args[0], str):
            return args[0] in target
        raise no_such_overload("contains", target, *args)
    if name == "startsWith":
        if isinstance(target, str) and len(args) == 1 and isinstance(args[0], str):
            return target.startswith(args[0])
        raise no_such_overload("startsWith", target, *args)
    if name == "endsWith":
        if isinstance(target, str) and len(args) == 1 and isinstance(args[0], str):
            return target.endswith(args[0])
        raise no_such_overload("endsWith", target, *args)
    if name == "matches":
        if isinstance(target, str) and len(args) == 1 and isinstance(args[0], str):
            # linear-time RE2-subset engine (re2.py): cel-go parity and
            # no backtracking blowup holding the GIL past the webhook
            # timeout — Python's re cannot be interrupted mid-match
            try:
                return _re2_search(args[0], target)
            except Re2Error as e:
                raise CelError(f"invalid regex: {e}")
        raise no_such_overload("matches", target, *args)
    if name in ("lowerAscii", "upperAscii"):
        if isinstance(target, str):
            table = str.lower if name == "lowerAscii" else str.upper
            return "".join(table(c) if ord(c) < 128 else c for c in target)
        raise no_such_overload(name, target)
    if name == "trim":
        if isinstance(target, str):
            return target.strip()
        raise no_such_overload("trim", target)
    if name == "replace":
        if isinstance(target, str) and len(args) in (2, 3):
            limit = args[2] if len(args) == 3 else -1
            return target.replace(args[0], args[1], limit if limit >= 0 else -1)
        raise no_such_overload("replace", target, *args)
    if name == "split":
        if isinstance(target, str) and len(args) in (1, 2):
            sep = args[0]
            if not isinstance(sep, str):
                raise no_such_overload("split", target, *args)
            # Go strings.Split("abc", "") -> ["a","b","c"]
            parts = list(target) if sep == "" else target.split(sep)
            if len(args) == 2:
                # Go strings.SplitN: n<0 all, n==0 none, n>0 at most n
                n_limit = args[1]
                if n_limit == 0:
                    return []
                if n_limit < 0 or n_limit >= len(parts):
                    return parts
                return parts[:n_limit - 1] + [sep.join(parts[n_limit - 1:])]
            return parts
        raise no_such_overload("split", target, *args)
    if name == "join":
        if isinstance(target, list):
            sep = args[0] if args else ""
            if all(isinstance(x, str) for x in target):
                return sep.join(target)
        raise no_such_overload("join", target, *args)
    if name == "indexOf":
        if isinstance(target, str) and args and isinstance(args[0], str):
            return target.find(args[0], *(args[1:] or ()))
        raise no_such_overload("indexOf", target, *args)
    if name == "substring":
        if isinstance(target, str) and args:
            start = args[0]
            end = args[1] if len(args) > 1 else len(target)
            if not (0 <= start <= end <= len(target)):
                raise CelError("index out of range")
            return target[start:end]
        raise no_such_overload("substring", target, *args)
    if name == "isSorted" and isinstance(target, list):
        try:
            return all(not _cmp(">", target[i], target[i + 1]) for i in range(len(target) - 1))
        except CelError:
            raise
    if name == "sum" and isinstance(target, list):
        total = 0
        for x in target:
            total = _binop("+", total, x)
        return total
    if name == "min" and isinstance(target, list):
        if not target:
            raise CelError("min called on empty list")
        out = target[0]
        for x in target[1:]:
            if _cmp("<", x, out):
                out = x
        return out
    if name == "max" and isinstance(target, list):
        if not target:
            raise CelError("max called on empty list")
        out = target[0]
        for x in target[1:]:
            if _cmp(">", x, out):
                out = x
        return out
    raise CelError(f"unknown method '{name}' on {type_name(target)}")


def _optional_method(target, name: str, arg_nodes, env: Env):
    if not isinstance(target, Optional_):
        if name == "orValue":  # orValue on a plain value is identity
            return target
        raise no_such_overload(name, target)
    if name == "orValue":
        return target.val if target.present else _eval(arg_nodes[0], env)
    if name == "hasValue":
        return target.present
    if name == "value":
        if target.present:
            return target.val
        raise CelError("optional.none() dereference")
    if name == "optMap":
        if not target.present:
            return OPT_NONE
        var = arg_nodes[0]
        if var[0] != "ident":
            raise CelError("optMap requires an iteration variable")
        return Optional_(True, _eval(arg_nodes[1], env.child(var[1], target.val)))
    if name == "optFlatMap":
        if not target.present:
            return OPT_NONE
        var = arg_nodes[0]
        if var[0] != "ident":
            raise CelError("optFlatMap requires an iteration variable")
        out = _eval(arg_nodes[1], env.child(var[1], target.val))
        if not isinstance(out, Optional_):
            raise CelError("optFlatMap body must return an optional")
        return out
    raise CelError(f"unknown optional method '{name}'")


def _macro(node, env: Env):
    _, kind, target_ast, var, body = node
    target = _eval(target_ast, env)
    if isinstance(target, dict):
        items: List[Any] = list(target.keys())
    elif isinstance(target, list):
        items = target
    else:
        raise no_such_overload(kind, target)
    pred = body[0]
    if kind in ("all", "exists"):
        absorb_val = kind == "exists"  # exists=OR, all=AND
        err: CelError = None
        for item in items:
            try:
                v = _truth(_eval(pred, env.child(var, item)))
                if v is absorb_val:
                    return absorb_val
            except CelError as e:
                err = err or e
        if err is not None:
            raise err
        return not absorb_val
    if kind == "exists_one":
        count = 0
        for item in items:
            if _truth(_eval(pred, env.child(var, item))):
                count += 1
        return count == 1
    if kind == "filter":
        return [item for item in items
                if _truth(_eval(pred, env.child(var, item)))]
    if kind == "map":
        if len(body) == 2:  # map(x, filter, transform)
            return [_eval(body[1], env.child(var, item)) for item in items
                    if _truth(_eval(body[0], env.child(var, item)))]
        return [_eval(pred, env.child(var, item)) for item in items]
    raise CelError(f"unknown macro {kind}")


def base_env(variables: Dict[str, Any]) -> Env:
    v = dict(variables)
    v.setdefault("optional", _OPTIONAL_NS)
    return Env(v)
