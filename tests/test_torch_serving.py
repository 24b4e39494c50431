"""The port's admission serving (``kyverno_tpu_torch/serving``, the
micro-batcher of ``webhooks/``) against the JAX package's, on the CPU
(tolerance: exact).

- The class-aware ``AdmissionQueue`` under a fixed clock: the same
  seeded stream of puts (class, deadline), drains (size) and flush-timer
  reads gives the same admissions and sheds, drain orders, drain info,
  wake times and shape buckets in both packages.
- The scheduler's pure functions (``classify_request``,
  ``parse_class_weights``, ``burn_shed_threshold``) agree case by case.
- ``AdmissionPipeline`` wired to ``TorchEngine(device="cpu")`` and the
  reference's wired to ``TpuEngine``: the evaluate function is the
  admission server's core (pad slots are empty resources, ``scan(...,
  live_n=real)``, one ``resource_verdicts`` row list a real column);
  every request's rows and blocked flag are the same.
- ``MicroBatcher`` over both engines: the same.
- The flight recorder's lazy ``serving.queue`` import resolves to the
  port's module."""

import concurrent.futures
import copy
import random
import sys

import pytest

from kyverno_tpu import serving as jserving
from kyverno_tpu.policies import load_pss_policies as jload_pss
from kyverno_tpu.policy.autogen import expand_policy as jexpand
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu.tpu.flatten import EncodeConfig as JEncodeConfig
from kyverno_tpu.webhooks.batcher import MicroBatcher as JMicroBatcher
from kyverno_tpu_torch import serving as tserving
from kyverno_tpu_torch.policies import load_pss_policies as tload_pss
from kyverno_tpu_torch.policy.autogen import expand_policy as texpand
from kyverno_tpu_torch.serving import queue as tqueue
from kyverno_tpu_torch.serving import scheduler as tsched
from kyverno_tpu_torch.tpu.engine import TorchEngine
from kyverno_tpu_torch.tpu.evaluator import FAIL
from kyverno_tpu_torch.tpu.flatten import EncodeConfig
from kyverno_tpu_torch.webhooks import MicroBatcher

from test_tpu_pss_parity import _resource
from torch_parity_util import fresh_port_state  # noqa: F401

from kyverno_tpu.serving import scheduler as jsched


# ---------------------------------------------------------------------------
# the queue under a fixed clock


def _classes(pkg):
    RC = pkg.RequestClass
    return [None] + [RC(t, op, pri) for t in ("t1", "t2", "t3")
                     for op in ("CREATE", "UPDATE")
                     for pri in ("critical", "default", "bulk")]


def _queue_trace(pkg, seed, **cfg_kw):
    """Replay one seeded stream through ``pkg``'s queue; every outcome
    the scheduler decides, in order."""
    rng = random.Random(seed)
    cfg = pkg.BatchConfig(**cfg_kw)
    q = pkg.AdmissionQueue(cfg.high_water, config=cfg)
    classes = _classes(pkg)
    now = 1000.0
    out = []
    for step in range(600):
        now += rng.choice((0.0, 0.0005, 0.001, 0.003, 0.02))
        op = rng.random()
        if op < 0.7:
            cls = rng.choice(classes)
            deadline = now + rng.choice((0.004, 0.015, 0.05, 0.5, 5.0))
            try:
                q.put(f"r{step}", deadline, now=now, cls=cls)
                out.append(("put", step))
            except pkg.QueueFullError as e:
                out.append(("shed", step, e.reason))
        elif op < 0.9:
            size = rng.choice((1, 4, 16, 24, 64))
            with q.cv:
                out.append(("wake", sorted(
                    (k, round(v - 1000.0, 9))
                    for k, v in q.wake_times(cfg).items())))
                batch = q.drain(size, now=now, config=cfg,
                                stopping=rng.random() < 0.05)
                info = dict(q.last_drain_info)
            out.append(("drain", [r.payload for r in batch],
                        cfg.bucket(len(batch)) if batch else 0,
                        sorted(info.items())))
        else:
            out.append(("depth", q.depth(), sorted(q.depth_by_class().items())))
    with q.cv:
        out.append(("rest", [r.payload for r in q.drain_all()]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [
    {},
    {"high_water": 40, "bulk_share": 0.3, "critical_reserve": 0.2,
     "bulk_max_wait_ms": 25.0, "urgent_ms": 5.0},
    {"high_water": 256, "bulk_share": 0.5, "critical_reserve": 0.1,
     "bulk_max_wait_ms": 25.0, "max_batch_size": 64,
     "class_weights": {"critical": 16.0, "default": 2.0, "bulk": 1.0}},
])
def test_queue_drain_order_sheds_and_wake_times_equal_reference(seed, cfg):
    want = _queue_trace(jserving, seed, **cfg)
    got = _queue_trace(tserving, seed, **cfg)
    assert got == want
    assert any(e[0] == "drain" and e[1] for e in got)


@pytest.mark.parametrize("kw", [
    {"operation": "CREATE", "username": "alice", "namespace": "apps"},
    {"username": "system:node:worker-1", "namespace": "ns"},
    {"username": "system:serviceaccount:kube-system:gc"},
    {"username": "alice", "dry_run": True},
    {"username": "alice", "groups": ["system:nodes"]},
    {"username": "deploy-bot-7"},
    {"username": "alice", "resource": {"metadata": {"annotations": {
        "policies.kyverno.io/priority": "critical"}}}},
    {"username": "deploy-bot-7", "resource": {"metadata": {"annotations": {
        "policies.kyverno.io/priority": "bulk"}}}},
    {"username": "alice", "resource": {"metadata": {"annotations": {
        "policies.kyverno.io/priority": "turbo"}}}},
    {},
])
@pytest.mark.parametrize("trust", [False, True])
def test_classify_request_equals_reference(kw, trust):
    def run(sched):
        cfg = sched.ClassifyConfig(critical_users=("deploy-bot*",),
                                   trust_annotation_critical=trust)
        return tuple(sched.classify_request(cfg, **copy.deepcopy(kw)))

    assert run(tsched) == run(jsched)


@pytest.mark.parametrize("text", ["bulk=2,critical=16", "default=1",
                                  "turbo=1", "bulk=0", "bulk=nan",
                                  "critical=inf", ""])
def test_parse_class_weights_equals_reference(text):
    def run(sched):
        try:
            return sorted(sched.parse_class_weights(text).items())
        except ValueError:
            return "ValueError"

    assert run(tsched) == run(jsched)


@pytest.mark.parametrize("burn", [(1.0, 0.0), (0.5, 2.0), (0.0, 0.0)])
def test_burn_shed_threshold_equals_reference(burn):
    for jcls, tcls in zip(_classes(jserving), _classes(tserving)):
        got = tsched.burn_shed_threshold(tserving.BatchConfig(
            shed_burn_bulk=burn[0], shed_burn_default=burn[1]), tcls)
        want = jsched.burn_shed_threshold(jserving.BatchConfig(
            shed_burn_bulk=burn[0], shed_burn_default=burn[1]), jcls)
        assert got == want


# ---------------------------------------------------------------------------
# the pipeline and the micro-batcher over both engines


SUBSET = ("disallow-privileged", "disallow-host", "restrict-seccomp")


@pytest.fixture(scope="module")
def engines():
    """A PSS subset compiled by each package (small enough that the JAX
    program's CPU jit at buckets 16 and 32 stays cheap)."""
    jpols = [jexpand(p) for s in SUBSET for p in jload_pss(s)]
    tpols = [texpand(p) for s in SUBSET for p in tload_pss(s)]
    # max_rows fixed, as the admission engine's (bench.py): every batch
    # of a bucket then has one lane shape
    engs = (TpuEngine(jpols, encode_cfg=JEncodeConfig(max_rows=128)),
            TorchEngine(tpols, device="cpu",
                        encode_cfg=EncodeConfig(max_rows=128)))
    for eng in engs:  # the JAX jit at each bucket, before any deadline
        for n in (16, 32):
            eng.scan([{"kind": "Pod", "metadata": {"name": f"w{i}"}}
                      for i in range(n)])
    return engs


def _pods(n=200, seed=7):
    rng = random.Random(seed)
    return [_resource(rng, i) for i in range(n)]


def _evaluate(eng, pkg):
    """The admission server's batch evaluator core: pad slots scan as
    empty resources, the analytics see only the real columns."""

    def fn(padded):
        real = sum(1 for p in padded if p is not None)
        res = eng.scan([p if p is not None else {} for p in padded],
                       live_n=real)
        return [pkg.resource_verdicts(res, ci) for ci in range(real)]

    return fn


def _blocked(rows):
    return any(code == FAIL for _, code in rows)


def _serve(submit, pods, workers=8):
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(submit, [copy.deepcopy(p) for p in pods]))


@pytest.mark.parametrize("max_batch", [16, 32])
def test_pipeline_rows_equal_reference(engines, max_batch):
    jeng, teng = engines
    pods = _pods()
    outs = []
    for pkg, eng in ((jserving, jeng), (tserving, teng)):
        cfg = pkg.BatchConfig(max_batch_size=max_batch, max_wait_ms=2.0,
                              min_bucket=16, deadline_ms=120000.0)
        pipe = pkg.AdmissionPipeline(_evaluate(eng, pkg), config=cfg)
        try:
            outs.append(_serve(pipe.submit, pods))
            st = pipe.state()["stats"]
        finally:
            pipe.stop()
        assert st["evaluated"] == len(pods) and st["shed"] == 0
        assert set(st["flushes_by_bucket"]) <= {16, 32}
        if max_batch == 16:
            assert set(st["flushes_by_bucket"]) == {16}
    want, got = outs
    assert len(got) == len(want) == len(pods)
    for g, w in zip(got, want):
        assert g == w and _blocked(g) == _blocked(w)
    assert any(_blocked(w) for w in want) and not all(_blocked(w) for w in want)


def test_micro_batcher_rows_equal_reference(engines):
    jeng, teng = engines
    pods = _pods(120, 9)
    outs = []
    for cls, eng, pkg in ((JMicroBatcher, jeng, jserving),
                          (MicroBatcher, teng, tserving)):
        mb = cls(lambda ps, e=eng, p=pkg: [
            p.resource_verdicts(r, ci) for r in [e.scan(ps)]
            for ci in range(len(ps))], max_batch=16, max_wait_ms=2.0)
        try:
            outs.append(_serve(mb.submit, pods))
        finally:
            mb.stop()
    assert outs[0] == outs[1]
    assert [_blocked(r) for r in outs[0]] == [_blocked(r) for r in outs[1]]


def test_flight_recorder_deadline_import_resolves_to_the_port():
    from kyverno_tpu_torch.observability import flightrecorder as fr

    rec = fr.FlightRecorder
    assert rec.classify(None, "batched",
                        error=tqueue.DeadlineExceededError("x")) \
        == fr.OUTCOME_EXPIRED
    # the reference's error class is another class: an evaluator error
    assert rec.classify(None, "batched",
                        error=jserving.DeadlineExceededError("x")) \
        == fr.OUTCOME_ERROR
    assert sys.modules["kyverno_tpu_torch.serving.queue"] is tqueue
