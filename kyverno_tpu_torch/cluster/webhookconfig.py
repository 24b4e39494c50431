# Copied from kyverno_tpu/cluster/webhookconfig.py (MANAGED_BY_LABEL only).
"""Webhook-configuration generation from the live policy set, as far as
the background scan needs it: the label that marks kyverno's own
materialized admission plumbing, which scans skip."""

MANAGED_BY_LABEL = "webhook.kyverno.io/managed-by"
