# Copied verbatim from kyverno_tpu/engine/variables.py.
"""Variable `{{...}}` and reference `$(...)` substitution.

Re-implementation of pkg/engine/variables/vars.go + regex/regex.go:

- ``{{ expr }}`` resolves against the JSON context via JMESPath; a
  leading backslash escapes. If the variable is the entire string the
  typed value replaces it; embedded variables stringify (JSON for
  non-strings).
- ``{{ @ }}`` expands to a JMESPath of the current position within the
  rule, prefixed with ``request.object`` (or ``target`` when present),
  skipping the first two path segments and any ``foreach``
  (vars.go:332-344).
- ``$(./../x)`` references resolve against the document itself,
  relative to the reference's position; a resolved operator prefix is
  re-attached (vars.go:245-300, 420-460).
- DELETE requests rewrite ``request.object`` to ``request.oldObject``
  (vars.go:346-348).
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, List, Optional, Tuple

from .context import Context, InvalidVariableError
from .operator import Operator, get_operator_from_string_pattern

# regex/regex.go ports
REGEX_VARIABLES = re.compile(r"(^|[^\\])(\{\{(?:\{[^{}]*\}|[^{}])*\}\})")
REGEX_ESCP_VARIABLES = re.compile(r"\\\{\{(?:\{[^{}]*\}|[^{}])*\}\}")
REGEX_REFERENCES = re.compile(r"^\$\(.[^\ ]*\)|[^\\]\$\(.[^\ ]*\)")
REGEX_ESCP_REFERENCES = re.compile(r"\\\$\(.[^\ \)]*\)")
REGEX_VARIABLE_INIT = re.compile(r"^\{\{(?:\{[^{}]*\}|[^{}])*\}\}")


class SubstitutionError(Exception):
    pass


class NotResolvedReferenceError(SubstitutionError):
    pass


def is_variable(value: str) -> bool:
    return isinstance(value, str) and REGEX_VARIABLES.search(value) is not None


def is_reference(value: str) -> bool:
    return isinstance(value, str) and REGEX_REFERENCES.search(value) is not None


VariableResolver = Callable[[Optional[Context], str], Any]


def default_resolver(ctx: Optional[Context], variable: str) -> Any:
    if ctx is None:
        raise InvalidVariableError(f"no context to resolve {variable!r}")
    return ctx.query(variable)


def precondition_resolver(ctx: Optional[Context], variable: str) -> Any:
    """Preconditions resolver (vars.go:42 newPreconditionsVariableResolver).
    Despite its stale upstream comment, it PROPAGATES evaluation errors
    (vars.go:45-53 logs and returns err; vars.go:351-359 surfaces it).
    Unset variables already resolve to None naturally — JMESPath
    returns null for missing paths without erroring — so the lenient
    behavior preconditions need comes from query semantics, not from
    swallowing genuine evaluation errors (type errors, bad syntax)."""
    return default_resolver(ctx, variable)


def substitute_all(ctx: Optional[Context], document: Any, resolver: VariableResolver = default_resolver) -> Any:
    """Port of SubstituteAll (vars.go:58): variables first, then
    references (resolved against the substituted document)."""
    substituted = _walk(document, "/", lambda value, path: _substitute_vars_in_string(ctx, value, path, resolver))
    out = _walk(
        substituted,
        "/",
        lambda value, path: _substitute_refs_in_string(substituted, value, path),
    )
    return out


def substitute_all_in_preconditions(ctx: Optional[Context], document: Any) -> Any:
    return substitute_all(ctx, document, precondition_resolver)


def substitute_vars_only(ctx: Optional[Context], document: Any, resolver: VariableResolver = default_resolver) -> Any:
    return _walk(document, "/", lambda value, path: _substitute_vars_in_string(ctx, value, path, resolver))


def _walk(node: Any, path: str, leaf_fn) -> Any:
    """jsonutils OnlyForLeafsAndKeys traversal: strings (leaves and map
    keys) get transformed; structure is rebuilt."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            new_k = leaf_fn(k, path) if isinstance(k, str) else k
            if not isinstance(new_k, str):
                new_k = json.dumps(new_k) if not isinstance(new_k, str) else new_k
            out[new_k] = _walk(v, f"{path}{k}/", leaf_fn)
        return out
    if isinstance(node, list):
        return [_walk(v, f"{path}{i}/", leaf_fn) for i, v in enumerate(node)]
    if isinstance(node, str):
        return leaf_fn(node, path)
    return node


def _path_to_jmespath(segments: List[str]) -> str:
    out = ""
    for seg in segments:
        if seg.isdigit():
            out += f"[{seg}]"
        elif re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", seg):
            out = f"{out}.{seg}" if out else seg
        else:
            quoted = '"%s"' % seg.replace('"', '\\"')
            out = f"{out}.{quoted}" if out else quoted
    return out


def _expand_at(variable: str, path: str, ctx: Optional[Context]) -> str:
    # vars.go:332-344: {{@}} -> request.object.<path minus 2 leading
    # segments, skipping past "foreach">
    path_prefix = "request.object"
    if ctx is not None:
        try:
            if ctx.query("target") is not None:
                path_prefix = "target"
        except InvalidVariableError:
            pass
    segments = [s for s in path.split("/") if s]
    if "foreach" in segments:
        segments = segments[segments.index("foreach") + 1:]
    segments = segments[2:]
    val = _path_to_jmespath(path_prefix.split(".") + segments)
    return variable.replace("@", val)


def _substitute_vars_in_string(ctx: Optional[Context], value: str, path: str, resolver: VariableResolver) -> Any:
    while True:
        matches = [(m.start(2), m.group(2)) for m in REGEX_VARIABLES.finditer(value)]
        if not matches:
            break
        original_pattern = value
        for _, var_text in matches:
            variable = var_text[2:-2].strip()
            # only the bare {{@}} expands (vars.go:332 `variable == "@"`);
            # an @ inside an expression (keys(@)) is JMESPath current-node
            if variable == "@":
                variable = _expand_at(variable, path, ctx)
            if ctx is not None and ctx.query_operation() == "DELETE":
                variable = variable.replace("request.object", "request.oldObject")
            try:
                substituted = resolver(ctx, variable)
            except InvalidVariableError as e:
                raise SubstitutionError(f"failed to resolve {variable} at path {path}: {e}")
            if original_pattern == var_text:
                return substituted  # full-string variable keeps its type
            if isinstance(substituted, str):
                replacement = substituted
            else:
                replacement = json.dumps(substituted, separators=(",", ":"))
            value = value.replace(var_text, replacement, 1)
        if value == original_pattern:
            break
    # unescape \{{...}}
    value = REGEX_ESCP_VARIABLES.sub(lambda m: m.group(0)[1:], value)
    return value


def _substitute_refs_in_string(document: Any, value: str, path: str) -> Any:
    # vars.go substituteReferencesIfAny
    while True:
        m = REGEX_REFERENCES.search(value)
        if not m:
            break
        full = m.group(0)
        initial = full.startswith("$(")
        ref = full if initial else full[1:]
        resolved = _resolve_reference(document, ref, path)
        if resolved is None:
            raise NotResolvedReferenceError(f"reference {ref} not resolved at path {path}")
        if isinstance(resolved, str):
            replacement = ("" if initial else full[0]) + resolved
            value = value.replace(full, replacement, 1)
            continue
        raise NotResolvedReferenceError(f"reference {ref} not resolved at path {path}")
    value = REGEX_ESCP_REFERENCES.sub(lambda m: m.group(0)[1:], value)
    return value


def _resolve_reference(document: Any, reference: str, absolute_path: str) -> Optional[str]:
    # vars.go resolveReference:432-460
    path = reference.strip("$()")
    op = get_operator_from_string_pattern(path)
    path = path[len(op.value):]
    if not path:
        return None
    abs_segments = _form_absolute_path(path, absolute_path)
    val = _get_value_by_path(document, abs_segments)
    if val is None:
        return None
    if op is Operator.EQUAL:
        if isinstance(val, str):
            return val
        return _val_to_string(val)
    s = _val_to_string(val)
    if s is None:
        return None
    return op.value + s


def _val_to_string(value: Any) -> Optional[str]:
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return None
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return "%f" % value
    return None


def _form_absolute_path(reference_path: str, absolute_path: str) -> List[str]:
    if reference_path.startswith("/"):
        return [s for s in reference_path.split("/") if s]
    base = [s for s in absolute_path.split("/") if s]
    for seg in reference_path.split("/"):
        if seg == "." or seg == "":
            continue
        elif seg == "..":
            if base:
                base.pop()
        else:
            base.append(seg)
    return base


def _get_value_by_path(document: Any, segments: List[str]) -> Any:
    node = document
    for seg in segments:
        if isinstance(node, dict):
            if seg in node:
                node = node[seg]
            else:
                # anchored keys resolve by their inner key
                from . import anchor as anchorpkg

                found = None
                for k in node:
                    a = anchorpkg.parse(k)
                    if a is not None and a.key == seg:
                        found = node[k]
                        break
                if found is None:
                    return None
                node = found
        elif isinstance(node, list):
            if seg.isdigit() and int(seg) < len(node):
                node = node[int(seg)]
            else:
                return None
        else:
            return None
    return node
