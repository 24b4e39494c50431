# Copied verbatim from kyverno_tpu/reports/journal.py.
"""Report journal — length-prefixed, checksummed delta log + snapshots.

The report store's crash-consistency substrate. Every fold delta is
framed as::

    u32 payload-length | u32 CRC32(payload) | payload (canonical JSON)

and appended (write + flush, so a SIGKILL'd process loses nothing the
kernel already has). Periodically the store compacts: the full base
row set is written as an atomic snapshot (``.tmp`` + ``os.replace``,
sha256-checksummed — the same validate-or-rebuild-cold ladder as the
mmap columnar store) and the journal resets.

Recovery walks the journal until the FIRST record that fails framing,
CRC, or decode, truncates the file to that good prefix, and counts the
reason on ``kyverno_reports_recoveries_total`` — a torn write degrades
the report to an older consistent state, never a wrong one. Records
whose monotonic ``seq`` is not strictly newer than what the snapshot
(or an earlier record) already covers are duplicate replays — skipped
and counted, so a crash between snapshot-replace and journal-truncate
cannot double-fold a delta.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

_HEADER = struct.Struct("<II")  # payload length, CRC32(payload)

JOURNAL_NAME = "journal.wal"
SNAPSHOT_NAME = "snapshot.json"
SNAPSHOT_VERSION = 1

# recovery-ladder reasons — the label set of
# kyverno_reports_recoveries_total{reason}
REASON_SHORT_HEADER = "short_header"      # trailing bytes < header size
REASON_TRUNCATED = "truncated_record"     # header promises more bytes than exist
REASON_CHECKSUM = "checksum"              # CRC mismatch (bit flip / torn write)
REASON_DECODE = "decode"                  # CRC ok but payload not valid JSON
REASON_DUPLICATE = "duplicate"            # seq already covered (double replay)
REASON_SNAPSHOT = "snapshot"              # snapshot failed validation, cold start
REASON_REPLAY = "replay"                  # unclean shutdown: journal replayed
REASON_APPEND_ERROR = "append_error"      # live append failed; delta not logged


def canonical(obj: Any) -> str:
    """Canonical JSON — the byte-stable serialization digests and
    checksums are computed over."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def frame(payload: bytes, wire: Optional[bytes] = None) -> bytes:
    """Frame one record. Length and CRC always describe ``payload``;
    the bytes actually written are ``wire`` when given — the
    corrupt-fault hook point: a mangled wire payload is exactly what
    the CRC catches at replay."""
    return _HEADER.pack(len(payload), zlib.crc32(payload)) \
        + (payload if wire is None else wire)


def scan_records(data: bytes) -> Tuple[List[Dict[str, Any]], int,
                                       Optional[str]]:
    """Walk framed records -> (docs, good_prefix_bytes, bad_reason).

    Stops at the first record that fails framing/CRC/decode; everything
    before it is the good prefix. ``bad_reason`` is None on a clean
    walk, else the recovery-ladder reason for the failure."""
    docs: List[Dict[str, Any]] = []
    off = 0
    n = len(data)
    while off < n:
        if n - off < _HEADER.size:
            return docs, off, REASON_SHORT_HEADER
        length, crc = _HEADER.unpack_from(data, off)
        start = off + _HEADER.size
        if n - start < length:
            return docs, off, REASON_TRUNCATED
        payload = data[start:start + length]
        if zlib.crc32(payload) != crc:
            return docs, off, REASON_CHECKSUM
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return docs, off, REASON_DECODE
        if not isinstance(doc, dict):
            return docs, off, REASON_DECODE
        docs.append(doc)
        off = start + length
    return docs, off, None


def _rows_checksum(seq: int, rows: List[Any]) -> str:
    return hashlib.sha256(canonical([seq, rows]).encode("utf-8")).hexdigest()


def write_snapshot(path: str, seq: int, rows: List[Any]) -> None:
    """Atomic compacted snapshot: serialized to ``.tmp``, fsynced,
    renamed into place — a crash mid-write leaves the previous
    snapshot untouched. Every step routes through the storage shim
    (surface ``reports``) so a full/erroring disk degrades the store
    to memory-only folding instead of raising out of compaction."""
    from ..resilience import storage as st

    body = {"version": SNAPSHOT_VERSION, "seq": seq, "rows": rows,
            "checksum": _rows_checksum(seq, rows)}
    tmp = path + ".tmp"
    try:
        with st.open_truncate(tmp, st.SURFACE_REPORTS) as f:
            st.write_frame(f, canonical(body), st.SURFACE_REPORTS, path=tmp)
            st.fsync(f, st.SURFACE_REPORTS, path=tmp)
        st.atomic_replace(tmp, path, st.SURFACE_REPORTS)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_snapshot(path: str) -> Optional[Tuple[int, List[Any]]]:
    """-> (seq, rows), or None on ANY validation failure — the
    validate-or-rebuild-cold ladder: a snapshot that fails version,
    shape, or checksum checks is discarded wholesale, never partially
    trusted."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            body = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(body, dict) or body.get("version") != SNAPSHOT_VERSION:
        return None
    seq, rows = body.get("seq"), body.get("rows")
    if not isinstance(seq, int) or not isinstance(rows, list):
        return None
    if body.get("checksum") != _rows_checksum(seq, rows):
        return None
    return seq, rows
