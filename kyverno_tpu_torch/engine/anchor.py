# Copied verbatim from kyverno_tpu/engine/anchor.py.
"""Anchor parsing, handlers, and error bookkeeping.

Re-implementation of the reference's pkg/engine/anchor package:

- anchor.go:10-19 — anchor kinds: Condition ``()``, Global ``<()``,
  Negation ``X()``, AddIfNotPresent ``+()``, Equality ``=()``,
  Existence ``^()``; parse regex ``^[+<=X^]?\\(key\\)$``.
- handlers.go:31-275 — per-anchor element handlers used by the
  validate tree walk.
- anchormap.go — AnchorMap bookkeeping ("did the anchored key appear
  anywhere in the resource?") used to distinguish fail vs skip when a
  pattern does not match.
- error.go — typed anchor errors; classification falls back to
  message-substring matching because combined (multierr) messages must
  still classify, which we reproduce.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Anchor model


CONDITION = ""
GLOBAL = "<"
NEGATION = "X"
ADD_IF_NOT_PRESENT = "+"
EQUALITY = "="
EXISTENCE = "^"

_ANCHOR_RE = re.compile(r"^(?P<modifier>[+<=X^])?\((?P<key>.+)\)$")


class Anchor:
    __slots__ = ("modifier", "key")

    def __init__(self, modifier: str, key: str):
        self.modifier = modifier
        self.key = key

    def __str__(self) -> str:
        return f"{self.modifier}({self.key})"


def parse(s: str) -> Optional[Anchor]:
    """Port of anchor.Parse (anchor.go:37)."""
    if not isinstance(s, str):
        return None
    m = _ANCHOR_RE.match(s.strip())
    if not m:
        return None
    return Anchor(m.group("modifier") or "", m.group("key"))


def anchor_string(modifier: str, key: str) -> str:
    return f"{modifier}({key})" if key else ""


def is_condition(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == CONDITION


def is_global(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == GLOBAL


def is_negation(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == NEGATION


def is_add_if_not_present(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == ADD_IF_NOT_PRESENT


def is_equality(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == EQUALITY


def is_existence(a: Optional[Anchor]) -> bool:
    return a is not None and a.modifier == EXISTENCE


# ---------------------------------------------------------------------------
# Errors (error.go)

NEGATION_ANCHOR_ERR_MSG = "negation anchor matched in resource"
CONDITIONAL_ANCHOR_ERR_MSG = "conditional anchor mismatch"
GLOBAL_ANCHOR_ERR_MSG = "global anchor mismatch"

_COND, _GLOBAL, _NEG = 0, 1, 2


class EngineError(Exception):
    """A plain validation error (Go's fmt.Errorf)."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:
        return self.message


class AnchorTypedError(EngineError):
    def __init__(self, kind: int, prefix: str, msg: str):
        super().__init__(f"{prefix}: {msg}")
        self.kind = kind


def new_negation_anchor_error(msg: str) -> AnchorTypedError:
    return AnchorTypedError(_NEG, NEGATION_ANCHOR_ERR_MSG, msg)


def new_conditional_anchor_error(msg: str) -> AnchorTypedError:
    return AnchorTypedError(_COND, CONDITIONAL_ANCHOR_ERR_MSG, msg)


def new_global_anchor_error(msg: str) -> AnchorTypedError:
    return AnchorTypedError(_GLOBAL, GLOBAL_ANCHOR_ERR_MSG, msg)


def _is_error(err: Optional[EngineError], kind: int, msg: str) -> bool:
    if err is None:
        return False
    if isinstance(err, AnchorTypedError):
        return err.kind == kind
    # fallback: combined/wrapped errors classify by message substring
    return msg in err.message


def is_negation_anchor_error(err) -> bool:
    return _is_error(err, _NEG, NEGATION_ANCHOR_ERR_MSG)


def is_conditional_anchor_error(err) -> bool:
    return _is_error(err, _COND, CONDITIONAL_ANCHOR_ERR_MSG)


def is_global_anchor_error(err) -> bool:
    return _is_error(err, _GLOBAL, GLOBAL_ANCHOR_ERR_MSG)


# ---------------------------------------------------------------------------
# AnchorMap (anchormap.go)


class AnchorMap:
    def __init__(self):
        self.anchor_map: Dict[str, bool] = {}
        self.anchor_error: Optional[EngineError] = None

    def keys_are_missing(self) -> bool:
        for k, v in self.anchor_map.items():
            if not v:
                if is_negation(parse(k)):
                    continue  # negations should be absent; not "missing"
                return True
        return False

    def check_anchor_in_resource(self, pattern: Dict[str, Any], resource: Any) -> None:
        for key in pattern:
            a = parse(key)
            if is_condition(a) or is_existence(a) or is_negation(a):
                val = self.anchor_map.get(key)
                if val is None:
                    self.anchor_map[key] = False
                elif val:
                    continue
                if _resource_has_value_for_key(resource, a.key):
                    self.anchor_map[key] = True


def _resource_has_value_for_key(resource: Any, key: str) -> bool:
    # anchor/utils.go resourceHasValueForKey
    if isinstance(resource, dict):
        return key in resource
    if isinstance(resource, list):
        return any(_resource_has_value_for_key(v, key) for v in resource)
    return False


def get_anchors_resources_from_map(pattern_map: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Port of GetAnchorsResourcesFromMap (anchor/utils.go)."""
    anchors: Dict[str, Any] = {}
    resources: Dict[str, Any] = {}
    for key, value in pattern_map.items():
        a = parse(key)
        if is_condition(a) or is_existence(a) or is_equality(a) or is_negation(a):
            anchors[key] = value
        else:
            resources[key] = value
    return anchors, resources


def remove_anchors_from_path(path: str) -> str:
    """Port of RemoveAnchorsFromPath (anchor/utils.go)."""
    parts = path.split("/")
    if parts and parts[0] == "":
        parts = parts[1:]
    out = []
    for part in parts:
        a = parse(part)
        out.append(a.key if a is not None else part)
    joined = "/".join(p for p in out if p)
    if path.startswith("/"):
        joined = "/" + joined
    return joined


# ---------------------------------------------------------------------------
# Element handlers (handlers.go)
#
# handler protocol mirrors resourceElementHandler: a callable
# (resource_element, pattern_element, origin_pattern, path, ac) ->
# (path, err|None). Handlers return ("", None) on success.

ElementHandler = Callable[[Any, Any, Any, str, AnchorMap], Tuple[str, Optional[EngineError]]]


def handle_element(
    element: str,
    pattern: Any,
    path: str,
    handler: ElementHandler,
    resource_map: Dict[str, Any],
    origin_pattern: Any,
    ac: AnchorMap,
) -> Tuple[str, Optional[EngineError]]:
    """Dispatch equivalent of CreateElementHandler(...).Handle(...)."""
    a = parse(element)
    if is_condition(a):
        return _handle_condition(a, pattern, path, handler, resource_map, origin_pattern, ac)
    if is_global(a):
        return _handle_global(a, pattern, path, handler, resource_map, origin_pattern, ac)
    if is_existence(a):
        return _handle_existence(a, pattern, path, handler, resource_map, origin_pattern, ac)
    if is_equality(a):
        return _handle_equality(a, pattern, path, handler, resource_map, origin_pattern, ac)
    if is_negation(a):
        return _handle_negation(a, pattern, path, handler, resource_map, origin_pattern, ac)
    return _handle_default(element, pattern, path, handler, resource_map, origin_pattern, ac)


def _handle_negation(a, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:66-77 — key present in resource => fail
    current_path = path + a.key + "/"
    if a.key in resource_map:
        ac.anchor_error = new_negation_anchor_error(f"{current_path} is not allowed")
        return current_path, ac.anchor_error
    return "", None


def _handle_equality(a, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:96-109 — validate value only if key present
    current_path = path + a.key + "/"
    if a.key in resource_map:
        return_path, err = handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
        if err is not None:
            return return_path, err
    return "", None


def _handle_default(element, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:128-141 — "*" means "key must exist with non-nil value"
    current_path = path + element + "/"
    if pattern == "*" and resource_map.get(element) is not None:
        return "", None
    if pattern == "*" and resource_map.get(element) is None:
        return path, EngineError(f"{path}/{element} not found")
    return_path, err = handler(resource_map.get(element), pattern, origin_pattern, current_path, ac)
    if err is not None:
        return return_path, err
    return "", None


def _handle_condition(a, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:160-176
    current_path = path + a.key + "/"
    if a.key in resource_map:
        return_path, err = handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
        if err is not None:
            ac.anchor_error = new_conditional_anchor_error(err.message)
            return return_path, ac.anchor_error
        return "", None
    return current_path, new_conditional_anchor_error(
        "conditional anchor key doesn't exist in the resource"
    )


def _handle_global(a, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:195-209
    current_path = path + a.key + "/"
    if a.key in resource_map:
        return_path, err = handler(resource_map[a.key], pattern, origin_pattern, current_path, ac)
        if err is not None:
            ac.anchor_error = new_global_anchor_error(err.message)
            return return_path, ac.anchor_error
    return "", None


def _handle_existence(a, pattern, path, handler, resource_map, origin_pattern, ac):
    # handlers.go:228-275 — each pattern-list element must match at
    # least one resource-list element
    current_path = path + a.key + "/"
    if a.key not in resource_map:
        return "", None
    value = resource_map[a.key]
    if not isinstance(value, list):
        return current_path, EngineError(
            f"invalid resource type {type(value).__name__}: "
            "Existence ^ () anchor can be used only on list/array type resource"
        )
    if not isinstance(pattern, list):
        return current_path, EngineError(
            f"invalid pattern type {type(pattern).__name__}: "
            "Pattern has to be of list to compare against resource"
        )
    error_path = ""
    for pattern_map in pattern:
        if not isinstance(pattern_map, dict):
            return current_path, EngineError(
                f"invalid pattern type {type(pattern).__name__}: "
                "Pattern has to be of type map to compare against items in resource"
            )
        error_path, err = _validate_existence_list(
            handler, value, pattern_map, origin_pattern, current_path, ac
        )
        if err is not None:
            return error_path, err
    return error_path, None


def _validate_existence_list(handler, resource_list, pattern_map, origin_pattern, path, ac):
    for i, resource_element in enumerate(resource_list):
        current_path = f"{path}{i}/"
        _, err = handler(resource_element, pattern_map, origin_pattern, current_path, ac)
        if err is None:
            return "", None  # satisfied at least once
    return path, EngineError(f"existence anchor validation failed at path {path}")
