"""kyverno_tpu_torch — the PyTorch/CUDA port of the device plane.

The port runs the validate scan of a compiled policy set on an NVIDIA
H100: the host closure (policy loading, IR lowering, row encoding) is
carried over from ``kyverno_tpu`` as copies, and the device half is
rewritten as PyTorch code around hand-written CUDA kernels
(``csrc/*.cu``, loaded by ``kernels.py``).

Entry points: ``kyverno_tpu_torch.tpu.engine.TorchEngine`` (a batch
scan, dense lanes, completed on the scalar engine) and
``kyverno_tpu_torch.parallel.ShardedScanner`` (the tiled background
scan over the vocabulary form), which ``tpu.pipeline.PipelinedScanner``
drives with its encode on a feed thread or an ``encode.EncoderPool`` of
spawned worker processes; above them, the AdmissionReview webhook
server (``webhooks.build_handlers``, ``webhooks.AdmissionServer``) and
the command line, ``python -m kyverno_tpu_torch`` (``apply``,
``analyze``, ``serve`` and the reference's other commands). They run on
``device="cuda"`` unless the caller asks for ``device="cpu"``
(``--device cpu`` on the command line), where every kernel is replaced
by its plain PyTorch twin.

This package imports ``torch`` and ``numpy``, never ``jax`` and
nothing of ``kyverno_tpu``.
"""
