"""Fault-injection sites, retry budgets, the circuit breaker of the
device plane and the storage ladder every durable write goes through
(copies of ``kyverno_tpu/resilience/{faults,retry,breaker,storage}.py``)."""
