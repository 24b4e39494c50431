# Copied verbatim from kyverno_tpu/engine/context.py.
"""Per-request JSON context with checkpoint/restore.

Re-implementation of pkg/engine/context/context.go: a JSON document
holding ``request`` (object/oldObject/userInfo/operation...),
``element``/``elementIndex`` (foreach scope), ``images``, and named
context entries, queried via JMESPath. Checkpoint/Restore snapshots
give per-rule isolation (engine.go:258-266).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional

from . import jmespath as jp
from .jmespath.errors import JMESPathError


class InvalidVariableError(Exception):
    pass


class VariableNotFoundError(InvalidVariableError):
    """The reference's forked go-jmespath returns a NotFoundError when
    a plain field path does not exist in the document (as opposed to
    existing with a null value). Substitution propagates it
    (vars.go:351-359), so conditions over missing paths surface as
    rule errors — the behavior the nil-values-in-variables fixtures
    pin down."""


class ContextEntryError(Exception):
    """A registered context-entry loader failed. Deliberately NOT an
    InvalidVariableError: the preconditions resolver maps unresolved
    variables to null, but a failed context load must surface as a rule
    error (engine.go:269-276), not evaluate as null."""


class Context:
    """JSON context (context.go:46 Interface)."""

    def __init__(self):
        self._root: Dict[str, Any] = {"request": {}}
        self._checkpoints: List[Dict[str, Any]] = []
        self._deferred = []  # (name, loader) pairs, see deferred loading
        # CLI-store values: entry names pinned here override context
        # loaders (the reference CLI's store-backed context loader,
        # processor/policy_processor.go:75-85 + store.ContextVar)
        self._pinned: set = set()

    # -- builders

    def add_request(self, request: Dict[str, Any]) -> None:
        self._root["request"] = request

    def add_resource(self, resource: Dict[str, Any]) -> None:
        self._root.setdefault("request", {})["object"] = resource

    def add_old_resource(self, resource: Dict[str, Any]) -> None:
        self._root.setdefault("request", {})["oldObject"] = resource

    def add_target_resource(self, resource: Dict[str, Any]) -> None:
        self._root["target"] = resource

    def add_operation(self, operation: str) -> None:
        self._root.setdefault("request", {})["operation"] = operation

    def add_user_info(self, user_info: Dict[str, Any]) -> None:
        self._root.setdefault("request", {})["userInfo"] = user_info

    def add_service_account(self, username: str) -> None:
        """context.go AddServiceAccount: derive serviceAccountName /
        serviceAccountNamespace from a system:serviceaccount username."""
        sa_name, sa_ns = "", ""
        prefix = "system:serviceaccount:"
        if username.startswith(prefix):
            rest = username[len(prefix):]
            if rest.count(":") == 1:
                sa_ns, sa_name = rest.split(":")
        self._root["serviceAccountName"] = sa_name
        self._root["serviceAccountNamespace"] = sa_ns

    def add_namespace(self, namespace: str) -> None:
        self._root.setdefault("request", {})["namespace"] = namespace

    def add_element(self, element: Any, index: int, nesting: int = 0) -> None:
        # element / elementIndex, plus elementIndexN for nested foreach
        self._root["element"] = element
        self._root["elementIndex"] = index
        self._root[f"elementIndex{nesting}"] = index

    def add_image_infos(self, images: Dict[str, Any]) -> None:
        self._root["images"] = images

    def add_variable(self, name: str, value: Any) -> None:
        """Set a dotted-name variable (context entries, CLI values).
        Quoted segments keep their dots: `a."x.y/z".b` has three
        segments, matching JMESPath navigation."""
        parts = _split_dotted(name)
        node = self._root
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def pin_variable(self, name: str, value: Any) -> None:
        """CLI-store value: set AND shadow any context entry of the
        same root name (deferred loaders for it will not fire)."""
        self.add_variable(name, value)
        self._pinned.add(_split_dotted(name)[0])

    def add_context_entry(self, name: str, value: Any) -> None:
        self.add_variable(name, value)

    def add_json(self, data: Dict[str, Any]) -> None:
        """Merge raw JSON into the root (context.go addJSON)."""
        _merge(self._root, data)

    # -- queries

    def query(self, query: str) -> Any:
        query = query.strip()
        if not query:
            raise InvalidVariableError("invalid query (nil)")
        self._load_deferred(query)
        try:
            result = jp.search(query, self._root)
        except JMESPathError as e:
            raise InvalidVariableError(f"failed to query {query!r}: {e}") from e
        if result is None and _is_bare_path(query) \
                and not _path_exists(self._root, query):
            raise VariableNotFoundError(f"variable {query} not found")
        return result

    def query_operation(self) -> str:
        req = self._root.get("request") or {}
        return req.get("operation") or ""

    def has_changed(self, jmespath_expr: str) -> bool:
        """context.go HasChanged: object vs oldObject at a path."""
        new = jp.search("request.object." + jmespath_expr, self._root)
        old = jp.search("request.oldObject." + jmespath_expr, self._root)
        return new != old

    # -- deferred loaders (deferred.go)

    def add_deferred_loader(self, name: str, loader) -> None:
        if name in self._pinned:
            return  # CLI-store value wins over the context source
        self._deferred.append((name, loader))

    def _load_deferred(self, query: str) -> None:
        if not self._deferred:
            return
        matched = [e for e in self._deferred if _query_references(query, e[0])]
        for entry in matched:
            # unregister BEFORE invoking: a loader that itself queries
            # another deferred entry (or raises) must never cause an
            # already-executed loader to be resurrected and re-run
            if entry not in self._deferred:
                continue  # a nested query already loaded it
            self._deferred.remove(entry)
            name, loader = entry
            try:
                value = loader()
            except Exception as e:  # loader errors surface on query
                raise ContextEntryError(f"failed to load context entry {name!r}: {e}")
            self.add_context_entry(name, value)

    def shallow_fork(self) -> "Context":
        """Cheap clone for per-slot dyn-operand encoding (tpu/engine.py
        _encode_dyn_cells): the expensive context build (resource,
        image extraction) happens once per resource; each operand slot
        loads its entries into a fork. The fork shares the request/
        images subtrees BY REFERENCE but owns its top-level spine, so
        entries one slot loads never leak into another slot's
        substitution or query. Safe because context entry names may not
        shadow reserved roots (request/images/element — policy
        validation rejects them), so loads only ever create new
        top-level keys."""
        out = Context()
        out._root = dict(self._root)
        out._pinned = set(self._pinned)
        out._deferred = list(self._deferred)
        return out

    # -- checkpointing (context.go Checkpoint/Restore/Reset)

    def checkpoint(self) -> None:
        self._checkpoints.append((copy.deepcopy(self._root), list(self._deferred)))

    def restore(self) -> None:
        if self._checkpoints:
            self._root, self._deferred = self._checkpoints.pop()

    def reset(self) -> None:
        """Revert to the last checkpoint without popping it."""
        if self._checkpoints:
            root, deferred = self._checkpoints[-1]
            self._root = copy.deepcopy(root)
            self._deferred = list(deferred)

    # -- introspection

    def root(self) -> Dict[str, Any]:
        return self._root

    def json(self) -> str:
        return json.dumps(self._root)


def _split_dotted(name: str):
    """Split a dotted path, honoring double-quoted segments
    (`a."x.y/z".b` -> ['a', 'x.y/z', 'b'])."""
    parts, buf, quoted = [], [], False
    for ch in name:
        if ch == '"':
            quoted = not quoted
        elif ch == "." and not quoted:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return [p for p in parts if p != ""] or [name]


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


_BARE_SEGMENT = r'(?:[A-Za-z_][A-Za-z0-9_]*|"(?:[^"\\]|\\.)*")(?:\[\d+\])*'
_BARE_PATH_RE = None  # compiled lazily


def _is_bare_path(query: str) -> bool:
    """True for plain field paths (identifiers/quoted keys/numeric
    indexes) — the shape whose missing-path lookups raise the forked
    go-jmespath NotFoundError. Expressions (functions, projections,
    pipes, operators) keep standard null semantics."""
    import re

    global _BARE_PATH_RE
    if _BARE_PATH_RE is None:
        _BARE_PATH_RE = re.compile(
            rf"^{_BARE_SEGMENT}(?:\.{_BARE_SEGMENT})*$")
    return _BARE_PATH_RE.match(query) is not None


def _bare_segments(query: str):
    """Split a bare path into (key, [indexes]) pairs."""
    import re

    out = []
    for m in re.finditer(_BARE_SEGMENT, query):
        seg = m.group(0)
        idx = [int(i) for i in re.findall(r"\[(\d+)\]", seg)]
        key = re.sub(r"\[\d+\]", "", seg)
        if key.startswith('"'):
            key = key[1:-1].replace('\\"', '"')
        out.append((key, idx))
    return out


def _path_exists(root: Any, query: str) -> bool:
    node = root
    for key, indexes in _bare_segments(query):
        if not isinstance(node, dict) or key not in node:
            return False
        node = node[key]
        for i in indexes:
            if not isinstance(node, list) or i >= len(node):
                return False
            node = node[i]
    return True


def _query_references(query: str, name: str) -> bool:
    """Rough equivalent of deferred.go matching: the query mentions the
    entry name as an identifier."""
    import re

    return re.search(r"(^|[^\w.])" + re.escape(name) + r"($|[^\w])", query) is not None
