# Copied verbatim from kyverno_tpu/lifecycle/watch.py.
"""Policy directory watcher — `serve --policy-watch DIR`.

Polls a directory of policy YAML/JSON files on an interval (mtime +
size signature first, content hash on movement) and reconciles the
PolicyCache to the directory's contents: new/changed policies are
set (only when their content hash actually moved — a touch without a
content change never burns a revision), policies that disappear from
every file are unset. Each cache mutation then flows through the
lifecycle manager's compile-ahead ladder, so a `kubectl cp`-style
deploy of a policy file hot-swaps the compiled set without a restart.

A file that fails to parse is SKIPPED (its previously loaded policies
stay live): a truncated write observed mid-poll must not unload half
the policy set. The parse error is kept in state() for /debug/state.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

import yaml

from ..api.policy import ClusterPolicy, is_policy_document
from .snapshot import policy_content_hash, policy_key

_POLICY_EXTS = (".yaml", ".yml", ".json")


class PolicyDirWatcher:
    def __init__(self, path: str, cache, interval_s: float = 2.0) -> None:
        self.path = path
        self.cache = cache
        self.interval_s = interval_s
        self._sig: Dict[str, Tuple[float, int]] = {}     # guarded-by: _lock  (file -> (mtime, size))
        self._content: Dict[str, str] = {}               # guarded-by: _lock  (file -> content hash)
        self._file_keys: Dict[str, Set[str]] = {}        # guarded-by: _lock  (file -> policy keys)
        self._loaded_hash: Dict[str, str] = {}           # guarded-by: _lock  (policy key -> hash)
        self._errors: Dict[str, str] = {}                # guarded-by: _lock  (file -> parse error)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"polls": 0, "syncs": 0, "set": 0, "unset": 0,
                      "parse_errors": 0}

    # -- polling

    def _list_files(self) -> List[str]:
        out: List[str] = []
        for root, _dirs, files in os.walk(self.path):
            for f in sorted(files):
                if f.lower().endswith(_POLICY_EXTS):
                    out.append(os.path.join(root, f))
        return sorted(out)

    def _parse_file(self, path: str) -> List[ClusterPolicy]:
        with open(path, "rb") as f:
            raw = f.read()
        policies = []
        for doc in yaml.safe_load_all(raw.decode("utf-8")):
            if isinstance(doc, dict) and is_policy_document(doc):
                policies.append(ClusterPolicy.from_dict(doc))
        return policies

    def sync_once(self) -> bool:
        """One poll pass; returns True when any cache mutation landed.

        The IO half (directory walk, stat/hash of every file, YAML
        parse of changed ones) runs WITHOUT the lock against a locked
        snapshot of the signature maps — state() is served on the HTTP
        debug thread and must never stall behind a slow disk or a big
        parse. Only the apply half (ownership/ledger mutations and the
        cache set/unset calls) runs under _lock, so a scrape mid-pass
        sees either the old maps or the new ones, never a resize in
        flight. Poll passes themselves never run concurrently (one
        watcher thread; manual sync_once callers are sequential), so
        reading the snapshot and applying later cannot lose updates."""
        with self._lock:
            self.stats["polls"] += 1
            sig_snap = dict(self._sig)
            content_snap = dict(self._content)
            known_files = list(self._file_keys)
        files = self._list_files()
        present = set(files)
        # cheap signature pass first, content hash only on movement,
        # parse only on content movement — all outside the lock
        new_sigs: Dict[str, Tuple[float, int]] = {}
        new_content: Dict[str, str] = {}
        parsed: Dict[str, List[ClusterPolicy]] = {}
        parse_errors: Dict[str, str] = {}
        for path in files:
            try:
                st = os.stat(path)
                sig = (st.st_mtime, st.st_size)
            except OSError:
                continue  # raced a delete; next poll settles it
            if sig_snap.get(path) == sig:
                continue
            try:
                with open(path, "rb") as f:
                    h = hashlib.sha256(f.read()).hexdigest()
            except OSError:
                continue
            new_sigs[path] = sig
            if content_snap.get(path) != h:
                new_content[path] = h
                try:
                    parsed[path] = self._parse_file(path)
                except Exception as e:  # noqa: BLE001 — bad file, keep prior
                    parse_errors[path] = f"{type(e).__name__}: {e}"
        removed_files = [p for p in known_files if p not in present]
        if not new_sigs and not removed_files:
            return False
        with self._lock:
            return self._apply_locked(new_sigs, new_content, parsed,
                                      parse_errors, removed_files)

    def _apply_locked(self, new_sigs, new_content, parsed, parse_errors,
                      removed_files) -> bool:
        self._sig.update(new_sigs)
        self._content.update(new_content)
        if not new_content and not removed_files and not parse_errors:
            return False
        mutated = False
        # phase 1: apply every set and update EVERY file's ownership
        # before any unset decision — a policy that moved between two
        # files in the same poll must never be transiently unloaded
        # (the stale ownership map would call it unowned mid-pass)
        gone: Set[str] = set()
        for path, err in parse_errors.items():
            self._errors[path] = err
            self.stats["parse_errors"] += 1
        for path, policies in parsed.items():
            self._errors.pop(path, None)
            new_keys = set()
            for p in policies:
                key = policy_key(p)
                new_keys.add(key)
                h = policy_content_hash(p)
                if self._loaded_hash.get(key) != h:
                    self.cache.set(p)
                    self._loaded_hash[key] = h
                    self.stats["set"] += 1
                    mutated = True
            gone |= self._file_keys.get(path, set()) - new_keys
            self._file_keys[path] = new_keys
        for path in removed_files:
            gone |= self._file_keys.pop(path, set())
            self._sig.pop(path, None)
            self._content.pop(path, None)
            self._errors.pop(path, None)
        # phase 2: unload what no watched file declares anymore
        mutated |= self._unset_unowned_locked(gone)
        if mutated:
            self.stats["syncs"] += 1
        return mutated

    def _unset_unowned_locked(self, keys: Set[str]) -> bool:
        mutated = False
        for key in keys:
            if any(key in owned for owned in self._file_keys.values()):
                continue  # still declared by another file
            ns, _, name = key.rpartition("/")
            self.cache.unset(name, ns)
            self._loaded_hash.pop(key, None)
            self.stats["unset"] += 1
            mutated = True
        return mutated

    # -- thread lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="policy-dir-watcher")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:  # the watcher must outlive any poll error
                pass
            self._stop.wait(self.interval_s)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        self._thread = None

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "interval_s": self.interval_s,
                "files": len(self._sig),
                "loaded_policies": len(self._loaded_hash),
                "parse_errors": dict(self._errors),
                "stats": dict(self.stats),
            }
