"""Host encode tasks of the port (copies of the parts of
``kyverno_tpu/encode`` that the background scan needs; the encoder
pool is not ported)."""
