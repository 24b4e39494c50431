# Copied from kyverno_tpu/encode/tasks.py (encode_vocab_host only).
"""The vocabulary-form host encode of one scan tile — pure NumPy/stdlib.

The reference runs this body both in-process (ShardedScanner.encode)
and inside its encoder-pool workers; the port has no pool yet and runs
it in-process only."""

from __future__ import annotations

from ..tpu.flatten import encode_resources_vocab
from ..tpu.metadata import encode_metadata


def encode_vocab_host(resources, ns_labels, operations, encode_cfg,
                      byte_paths, key_byte_paths, meta_cfg, meta_need,
                      used_keys, pad_multiple, buckets, encoder=None):
    """THE vocab-form encode body — pad to the mesh multiple,
    vocab-encode rows + metadata, grow the shape buckets (monotone
    doubling so shapes converge and XLA programs are reused), build
    the transfer-ready host dict filtered to the used lanes. Shared by
    ShardedScanner.encode (in-process) and run_vocab (pool workers):
    one implementation, so the two paths cannot drift and the
    bit-identity contract survives future encode changes."""
    n = len(resources)
    d = max(pad_multiple, 1)
    # batch-axis bucket: powers of two (floor 16, the engine's
    # MIN_BUCKET rationale) so arbitrary chunk sizes reuse at most
    # ~log2 jitted programs. Without this every distinct ragged-tail
    # size — e.g. each incremental scan tick's dirty count — is a new
    # N shape and a full XLA recompile (~tens of seconds and hundreds
    # of MB of program cache per tick on an endurance soak). Pads are
    # empty resources excluded from the returned ``n``, exactly like
    # the mesh-multiple pads below.
    b = 16
    while b < n:
        b *= 2
    padded = ((b + d - 1) // d) * d
    res = list(resources) + [{} for _ in range(padded - n)]
    ops = (list(operations) + [""] * (padded - n)) if operations else None
    # ``encoder`` is the row-encoder seam: ShardedScanner routes its
    # module-level encode_resources_vocab through here so callers (and
    # tests) that patch it still intercept every in-process encode
    vb = (encoder or encode_resources_vocab)(res, encode_cfg, byte_paths,
                                             key_byte_paths)
    meta = encode_metadata(res, ns_labels, ops, cfg=meta_cfg, need=meta_need)
    vbucket, sbucket, rbucket = buckets or (1024, 256, 64)
    while vbucket < vb.vocab_size:
        vbucket *= 2
    while sbucket < len(vb.strs):
        sbucket *= 2
    max_rows = encode_cfg.max_rows
    rbucket = min(rbucket, max_rows)
    while (rbucket < int(vb.n_rows.max(initial=0)) and rbucket < max_rows):
        rbucket = min(rbucket * 2, max_rows)
    host = vb.to_host(meta, vbucket, sbucket, rbucket)
    if used_keys is not None:
        host = {k: v for k, v in host.items() if k in used_keys}
    return host, n, (vbucket, sbucket, rbucket)
