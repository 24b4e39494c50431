"""Fault-injection sites, retry budgets and the circuit breaker of the
device plane (copies of ``kyverno_tpu/resilience/{faults,retry,
breaker}.py``). The storage ladder is not part of the port yet."""
