# Copied verbatim from kyverno_tpu/cluster/__init__.py.
"""Host-plane cluster services: snapshot store, policy cache,
background scan service, reports, events — the controllers layer
(SURVEY §2.2/§2.4) re-expressed for the TPU scan engine."""

from .policycache import PolicyCache, PolicyType
from .reports import PolicyReport, ReportAggregator
from .scanner import BackgroundScanService
from .snapshot import ClusterSnapshot
