# Copied verbatim from kyverno_tpu/engine/contextloaders.py.
"""Context-entry loaders.

Re-implementation of pkg/engine/context/loaders/*: each rule may
declare ``context:`` entries sourced from inline variables, ConfigMaps,
API calls, image registries, or GlobalContext entries. Loading is
deferred — the entry materializes only when a query references it
(deferred.go, toggle enableDeferredLoading).

The data sources are pluggable: the admission/background services
install informer-backed sources; the CLI installs file/value-backed
stubs (matching the reference CLI's store-backed loader,
cmd/cli/kubectl-kyverno/processor/policy_processor.go:75-85).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..resilience.faults import (SITE_CONTEXT_API_CALL,
                                 SITE_CONTEXT_IMAGE_DATA, global_faults)
from ..resilience.retry import PermanentError, RetryPolicy, retry_call
from .context import Context, InvalidVariableError
from .jmespath import search as jp_search
from .jmespath.errors import JMESPathError
from .variables import substitute_all


class ContextLoaderError(Exception):
    pass


# reference APICall client semantics: a handful of quick retries with
# backoff, bounded by a per-entry deadline budget well under the
# webhook's 10 s — a flaky backend costs one bounded stall, never an
# unhandled exception out of the rule
DEFAULT_BACKEND_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                    max_delay_s=0.5, deadline_s=2.0)


class DataSources:
    """Pluggable backends for context entries. A ``None`` backend means
    the source is unavailable: entries of that kind are silently
    disabled, matching the reference factory's behavior when the
    resolver/client is nil (factories/contextloaderfactory.go:103-131
    logs "disabled loading of ... context entry" and registers no
    loader). A present backend that fails a lookup is still an error —
    retried per ``retry`` (jittered backoff inside the entry's deadline
    budget) before it surfaces. A backend that KNOWS a failure is
    deterministic (missing object, rejected reference) should raise
    ``resilience.PermanentError`` to skip the retries: every other
    exception is treated as transient and costs the full retry budget
    on every admission that touches the entry."""

    def __init__(
        self,
        configmaps: Optional[Dict[str, Dict[str, Any]]] = None,
        api_call: Optional[Callable[[Dict[str, Any]], Any]] = None,
        image_data: Optional[Callable[[str], Dict[str, Any]]] = None,
        global_context: Optional[Dict[str, Any]] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        # configmaps: "namespace/name" -> configmap object dict
        self.configmaps = configmaps
        self.api_call = api_call
        self.image_data = image_data
        self.global_context = global_context
        self.retry = retry if retry is not None else DEFAULT_BACKEND_RETRY
        # batch-scoped poison set (see begin_batch): thread-local so
        # two engines encoding through one shared DataSources cannot
        # stomp each other's batch, and loads outside any batch (scalar
        # rule evaluation, cleanup conditions) are never poisoned
        self._batch_local = threading.local()

    def begin_batch(self) -> None:
        """Start a new encode batch on THIS thread: a backend whose
        retries exhaust is marked DOWN for the remainder of the batch
        and subsequent cells fail fast into the load-error lane instead
        of each paying the full retry budget. Without this, a batch of
        N request-dependent entries against a dead backend stalls the
        one flusher thread for N x deadline_s — minutes of serial
        backoff for an answer (\"backend down\") the first cell already
        established. Callers MUST pair with end_batch (try/finally) or
        the poison outlives the batch."""
        self._batch_local.down = set()

    def end_batch(self) -> None:
        """Close the thread's batch scope; later loads retry normally."""
        self._batch_local.down = None

    def _down_sites(self) -> Optional[set]:
        return getattr(self._batch_local, "down", None)


def load_context_entries(
    ctx: Context,
    entries: List[Dict[str, Any]],
    sources: Optional[DataSources] = None,
    deferred: bool = True,
) -> None:
    """Register (or eagerly load) each context entry into ``ctx``."""
    sources = sources or DataSources()
    for entry in entries:
        name = entry.get("name")
        if not name:
            raise ContextLoaderError("context entry without name")
        loader = _make_loader(ctx, entry, sources)
        if loader is None:
            continue  # backend unavailable: entry disabled, not an error
        if deferred:
            ctx.add_deferred_loader(name, loader)
        else:
            ctx.add_context_entry(name, loader())


def _make_loader(ctx: Context, entry: Dict[str, Any], sources: DataSources):
    name = entry["name"]
    if "variable" in entry:
        return lambda: _load_variable(ctx, entry["variable"])
    if "configMap" in entry:
        if sources.configmaps is None:
            return None
        return lambda: _load_configmap(ctx, entry["configMap"], sources)
    if "apiCall" in entry:
        if sources.api_call is None:
            return None
        return lambda: _load_apicall(ctx, entry["apiCall"], sources)
    if "imageRegistry" in entry:
        if sources.image_data is None:
            return None
        return lambda: _load_image_registry(ctx, entry["imageRegistry"], sources)
    if "globalReference" in entry:
        if sources.global_context is None:
            return None
        return lambda: _load_global(ctx, entry["globalReference"], sources)
    raise ContextLoaderError(f"context entry {name!r} has no recognized source")


def _load_variable(ctx: Context, spec: Dict[str, Any]) -> Any:
    # loaders/variable.go: value / jmesPath / default
    value = spec.get("value")
    jmes = spec.get("jmesPath")
    default = spec.get("default")
    result = None
    if value is not None:
        result = substitute_all(ctx, value)
        if jmes:
            try:
                result = jp_search(substitute_all(ctx, jmes), result)
            except JMESPathError as e:
                raise ContextLoaderError(f"variable jmesPath failed: {e}")
    elif jmes:
        expr = substitute_all(ctx, jmes)
        try:
            result = ctx.query(expr)
        except InvalidVariableError as e:
            if default is None:
                raise ContextLoaderError(str(e))
            result = None
    if result is None and default is not None:
        # defaults may themselves contain variables
        # (loaders/variable.go applies substitution to the default)
        result = substitute_all(ctx, default)
    return result


def _load_configmap(ctx: Context, spec: Dict[str, Any], sources: DataSources) -> Any:
    # loaders/configmap.go: exposes the configmap object under the
    # entry name, with .data values as strings
    name = substitute_all(ctx, spec.get("name", ""))
    namespace = substitute_all(ctx, spec.get("namespace", "") or "default")
    cm = sources.configmaps.get(f"{namespace}/{name}")
    if cm is None:
        raise ContextLoaderError(f"configmap {namespace}/{name} not found")
    return cm


def _call_backend(site: str, fn: Callable[[], Any],
                  sources: DataSources) -> Any:
    """One retried backend call: the armed fault site fires on EVERY
    attempt (so a count-based fault models a backend that heals), and
    backoff stays inside the entry's deadline budget. Inside a batch
    (begin_batch), a site whose retries exhaust poisons itself for the
    remaining cells — they fail fast instead of re-paying the budget."""
    down = sources._down_sites()
    if down is not None and site in down:
        raise ContextLoaderError(
            f"{site} backend marked down for this batch")

    def attempt():
        global_faults.fire(site)
        return fn()

    try:
        return retry_call(attempt, policy=sources.retry, site=site)
    except PermanentError:
        raise  # per-cell deterministic failure, not a down backend
    except Exception:
        if down is not None:
            down.add(site)
        raise


def _load_apicall(ctx: Context, spec: Dict[str, Any], sources: DataSources) -> Any:
    substituted = substitute_all(ctx, dict(spec))
    data = _call_backend(SITE_CONTEXT_API_CALL,
                         lambda: sources.api_call(substituted), sources)
    jmes = substituted.get("jmesPath")
    if jmes:
        try:
            data = jp_search(jmes, data)
        except JMESPathError as e:
            raise ContextLoaderError(f"apiCall jmesPath failed: {e}")
    return data


def _load_image_registry(ctx: Context, spec: Dict[str, Any], sources: DataSources) -> Any:
    reference = substitute_all(ctx, spec.get("reference", ""))
    data = _call_backend(SITE_CONTEXT_IMAGE_DATA,
                         lambda: sources.image_data(reference), sources)
    jmes = spec.get("jmesPath")
    if jmes:
        try:
            data = jp_search(substitute_all(ctx, jmes), data)
        except JMESPathError as e:
            raise ContextLoaderError(f"imageRegistry jmesPath failed: {e}")
    return data


def _load_global(ctx: Context, spec: Dict[str, Any], sources: DataSources) -> Any:
    name = spec.get("name", "")
    try:
        data = sources.global_context[name]
    except KeyError:
        raise ContextLoaderError(f"global context entry {name!r} not found")
    except Exception as e:
        # a present-but-failing entry (stale external API, stopped
        # watch) is a context-load error, not silently-empty data
        # (pkg/globalcontext/invalid/entry.go)
        raise ContextLoaderError(f"global context entry {name!r}: {e}")
    jmes = spec.get("jmesPath")
    if jmes:
        try:
            data = jp_search(substitute_all(ctx, jmes), data)
        except JMESPathError as e:
            raise ContextLoaderError(f"globalReference jmesPath failed: {e}")
    return data
