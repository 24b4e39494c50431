"""Cluster-side helpers of the port (copies of the parts of
``kyverno_tpu/cluster`` that the port needs)."""
