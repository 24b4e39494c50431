"""Fault-injection sites and retry budgets used by the context loaders
(copies of ``kyverno_tpu/resilience/{faults,retry}.py``). The circuit
breaker and the storage ladder are not part of the port yet."""
