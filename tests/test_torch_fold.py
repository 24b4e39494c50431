"""The class-logic tape (kyverno_tpu_torch/tpu/fold.py) and kernel K11's
plain twin (``kernels.class_fold_plain``).

- Seeded random tapes over every opcode, shape kind and input layout
  (bool, int32 and uint8 inputs; strided, broadcast and transposed
  views): what the tape computes, compiled whole or split into many
  launches, equals the same steps taken directly with torch operations.
- Operands of different shape kinds raise when recorded.
- A handle that reaches a torch function outside the tape is
  materialized and counted (``fold_forced``).
- Programs of every node kind (maps with anchors, a wildcard anchor,
  one- and two-level arrays of maps, array scalars, anyPattern, deny,
  foreach deny, preconditions, match/exclude with name and namespace
  lists, CEL expressions) equal the JAX package's ``build_program`` bit
  for bit, each rule one K11 call. Integer and bool outputs: tolerance 0."""

import numpy as np
import pytest
import torch

from kyverno_tpu.policies import load_pss_policies as jload_pss
from kyverno_tpu.policy.autogen import expand_policy as jexpand
from kyverno_tpu.tpu.compiler import compile_policy_set as jcompile
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu import fold
from kyverno_tpu_torch.tpu.engine import lanes_to_device

from test_tpu_foreach import ADD_CAPS_FOREACH, CAP_STRICT_FOREACH
from test_tpu_nested_wildcard import APPARMOR_RULE, HOST_PORTS_RULE
from test_tpu_parity import CAPABILITIES_DENY_RULE, make_policy
from torch_parity_util import port_engine


# ---------------------------------------------------------------------------
# random tapes against direct torch evaluation


def _random_tape(seed, N=11, I=5, steps=160):
    """A tape of ``steps`` random instructions over inputs of every kind
    and layout, beside the same steps in torch. Returns (tape, pool) with
    pool[kind] = [(handle, torch value)]."""
    rng = np.random.default_rng(seed)
    J = I
    tape = fold.Tape(N, I, J, "cpu", fold.FoldCache(), plain=True)
    shapes = ((N,), (N, I), (N, I, J))
    pool = {0: [], 1: [], 2: []}

    def add(kind, fv, ref):
        assert fv.kind == kind and tuple(ref.shape) == shapes[kind]
        pool[kind].append((fv, ref))

    for kind in range(3):
        for _ in range(3):
            b = torch.from_numpy(rng.random(shapes[kind]) < 0.5)
            add(kind, tape.input(b), b)
            v = torch.from_numpy(rng.integers(0, 7, shapes[kind])
                                 .astype(np.int32))
            add(kind, tape.input(v), v)
        u8 = torch.from_numpy(rng.integers(0, 3, shapes[kind])
                              .astype(np.uint8))
        add(kind, tape.input(u8), u8.to(torch.int32))
    # a strided column, a broadcast and a transposed view
    col = torch.from_numpy(rng.random((N, 3)) < 0.5)[:, 1]
    add(0, tape.input(col), col)
    bc = torch.from_numpy(rng.random((N, 1)) < 0.5).expand(N, I)
    add(1, tape.input(bc), bc)
    tr = torch.from_numpy(rng.integers(0, 7, (I, N)).astype(np.int32)).T
    add(1, tape.input(tr), tr)
    nij = torch.from_numpy(rng.integers(0, 3, (N, J, I)).astype(np.int32)
                           ).transpose(1, 2)
    add(2, tape.input(nij), nij)
    # the same tensor twice is one input
    assert tape.input(col) is pool[0][-1][0]

    def pick(kind, want=None):
        cand = [p for p in pool[kind] if want is None
                or (p[1].dtype == torch.bool) == (want == "bool")]
        return cand[int(rng.integers(0, len(cand)))]

    ops = ("and", "or", "not", "eqc", "nec", "eq", "where", "where_s",
           "fnp", "any", "all", "expand", "scan", "scanx", "const",
           "rand", "teq")
    for _ in range(steps):
        op = ops[int(rng.integers(0, len(ops)))]
        kind = int(rng.integers(0, 3))
        if op in ("and", "or", "rand"):
            (a, ra), (b, rb) = pick(kind, "bool"), pick(kind, "bool")
            if op == "and":
                add(kind, a & b, ra & rb)
            elif op == "or":
                add(kind, a | b, ra | rb)
            else:  # a tensor on the left
                add(kind, rb & a, ra & rb)
        elif op == "not":
            a, ra = pick(kind, "bool")
            add(kind, ~a, ~ra)
        elif op in ("eqc", "nec"):
            a, ra = pick(kind)
            c = int(rng.integers(0, 4))
            r = ra.to(torch.int32) == c
            add(kind, a == c if op == "eqc" else a != c,
                r if op == "eqc" else ~r)
        elif op in ("eq", "teq"):
            (a, ra), (b, rb) = pick(kind, "int"), pick(kind, "int")
            add(kind, (a == b) if op == "eq" else (rb == a), ra == rb)
        elif op == "where":
            c, rc = pick(kind, "bool")
            (a, ra), (b, rb) = pick(kind), pick(kind)
            add(kind, fold.where(c, a, b), torch.where(rc, ra, rb))
        elif op == "where_s":
            c, rc = pick(kind, "bool")
            b, rb = pick(kind, "int")
            s = int(rng.integers(0, 7))
            add(kind, fold.where(c, s, b),
                torch.where(rc, torch.full_like(rb, s), rb))
        elif op == "fnp":
            (a, ra), (b, rb) = pick(kind, "int"), pick(kind, "int")
            add(kind, fold.first_nonpass(a, b), torch.where(ra != 0, ra, rb))
        elif op in ("any", "all") and kind > 0:
            a, ra = pick(kind)
            rb = ra != 0
            add(kind - 1, a.any(dim=-1) if op == "any" else a.all(dim=-1),
                rb.any(dim=-1) if op == "any" else rb.all(dim=-1))
        elif op == "expand":
            a, ra = pick(0)
            add(1, fold.expand(a), ra[:, None].expand(N, I))
        elif op in ("scan", "scanx"):
            a, ra = pick(1, "bool")
            x = ra.to(torch.int32)
            s = torch.cumsum(x, dim=-1)
            add(1, fold.scan_or(a, exclusive=op == "scanx"),
                (s - x if op == "scanx" else s) > 0)
        elif op == "const":
            v = bool(rng.integers(0, 2))
            add(kind, tape.const(v, shapes[kind]),
                torch.full(shapes[kind], v, dtype=torch.bool))
    return tape, pool


def _run_and_compare(tape, pool, seed, n_out=8):
    rng = np.random.default_rng(seed + 1000)
    picks = []
    for _ in range(n_out):
        kind = int(rng.integers(0, 3))
        picks.append(pool[kind][-1 - int(rng.integers(0, 6))])
    dests = [torch.empty(tuple(r.shape), dtype=torch.bool
                         if fv.dtype == fold.BOOL else torch.int32)
             for fv, r in picks]
    tape.run([fv for fv, _ in picks], dests)
    for (fv, ref), d in zip(picks, dests):
        assert torch.equal(d.to(torch.int64), ref.to(torch.int64))
    return tape.cache._by_code[(tuple(tape.code),
                                tuple(fv.vid for fv, _ in picks), tape.J)]


@pytest.mark.parametrize("seed", range(6))
def test_random_tape_equals_direct_torch(seed):
    tape, pool = _random_tape(seed)
    comp = _run_and_compare(tape, pool, seed)
    assert len(comp.segments) == 1
    # every value the tape recorded is right, not only the outputs
    for kind in range(3):
        for fv, ref in pool[kind]:
            got = tape.force(fv)
            assert torch.equal(got.to(torch.int64), ref.to(torch.int64))


@pytest.mark.parametrize("seed", range(3))
def test_split_tape_equals_direct_torch(seed, monkeypatch):
    """A descriptor block of 8 splits the tape into many launches whose
    live values cross through scratch tensors."""
    monkeypatch.setattr(kernels, "CLASS_FOLD_MAX_IO", 8)
    tape, pool = _random_tape(seed)
    comp = _run_and_compare(tape, pool, seed)
    assert len(comp.segments) > 3 and comp.tmps
    for seg in comp.segments:
        assert seg.code.n_ext + seg.code.n_out <= 8
        assert seg.code.n_uniform + seg.code.n_lane >= 1


def test_compiled_slots_are_few_and_reused():
    """Slots are allocated by liveness: a chain of 200 steps keeps a
    handful of lane words, an NIJ value takes J of them, and an N value
    one word a warp."""
    N, I = 7, 4
    tape = fold.Tape(N, I, I, "cpu", fold.FoldCache(), plain=True)
    x = tape.input(torch.zeros((N, I), dtype=torch.bool))
    acc = tape.const(False, (N, I))
    for k in range(200):
        acc = fold.where(x, acc | (x == (k % 2)), ~acc)
    y = tape.input(torch.ones((N, I, I), dtype=torch.bool))
    out = torch.empty((N,), dtype=torch.bool)
    tape.run([(acc & y.any(dim=-1)).any(dim=-1)], [out])
    (seg,) = tape.cache._by_code[next(iter(tape.cache._by_code))].segments
    # x, x == 0, x == 1, acc, two steps; then y (J words)
    assert seg.code.n_lane <= 6 + I and seg.code.n_uniform == 1


def test_kind_mismatch_raises():
    N, I = 6, 3
    tape = fold.Tape(N, I, I, "cpu", fold.FoldCache(), plain=True)
    a = tape.input(torch.zeros((N,), dtype=torch.bool))
    b = tape.input(torch.zeros((N, I), dtype=torch.bool))
    c = tape.input(torch.zeros((N, I, I), dtype=torch.int32))
    with pytest.raises(fold.KindError):
        a & b
    with pytest.raises(fold.KindError):
        fold.where(a, b, 1)
    with pytest.raises(fold.KindError):
        b == c
    with pytest.raises(fold.KindError):
        fold.first_nonpass(c, b)
    with pytest.raises(fold.KindError):
        fold.expand(b)
    with pytest.raises(fold.KindError):
        fold.scan_or(a)
    with pytest.raises(fold.KindError):
        a.any(dim=-1)  # nothing to fold
    with pytest.raises(fold.KindError):
        c.any(dim=1)  # only the last axis
    with pytest.raises(fold.KindError):
        tape.input(torch.zeros((N, 7), dtype=torch.bool))  # a row plane
    with pytest.raises(fold.KindError):
        a | torch.zeros((N, I), dtype=torch.bool)  # torch would broadcast
    with pytest.raises(TypeError):
        bool(a)
    other = fold.Tape(N, I, I, "cpu", fold.FoldCache(), plain=True)
    with pytest.raises(ValueError):
        other.input(torch.zeros((N,), dtype=torch.bool)) & a


def test_forced_value_is_materialized_and_counted():
    N, I = 9, 4
    stats = {"fold_forced": 0}
    tape = fold.Tape(N, I, I, "cpu", fold.FoldCache(), plain=True,
                     stats=stats)
    rng = np.random.default_rng(5)
    ra = torch.from_numpy(rng.random((N, I)) < 0.5)
    rb = torch.from_numpy(rng.random((N, I)) < 0.5)
    v = tape.input(ra) & ~tape.input(rb)
    got = torch.logical_xor(v, rb)  # no tape op: the handle materializes
    assert torch.equal(got, torch.logical_xor(ra & ~rb, rb))
    assert stats["fold_forced"] == 1
    # the logical operators record instead
    w = rb | v
    assert isinstance(w, fold.FV) and stats["fold_forced"] == 1


# ---------------------------------------------------------------------------
# programs of every node kind against the JAX package


MAP_ANCHORS_RULE = {
    "name": "map-anchors",
    "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
    "validate": {"message": "anchors", "pattern": {
        "metadata": {"=(labels)": {"=(tier)": "web | db"}},
        "spec": {
            "X(hostIPC)": "null",
            "(dnsPolicy)": "ClusterFirst",
            "=(nodeName)": "?*",
            "containers": [{"(image)": "*:latest",
                            "imagePullPolicy": "Always"}],
        }}},
}

EXISTENCE_RULE = {
    "name": "existence-anchor",
    "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
    "validate": {"message": "an app container", "pattern": {
        "spec": {"^(containers)": [{"name": "app*"}]}}},
}

ARRAY_SCALAR_RULE = {
    "name": "drop-all",
    "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
    "validate": {"message": "drop ALL", "pattern": {
        "spec": {"=(containers)": [{"=(securityContext)": {
            "=(capabilities)": {"=(drop)": ["ALL"]}}}]}}},
}

ANY_PATTERN_RULE = {
    "name": "any-pattern",
    "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
    "validate": {"message": "one of", "anyPattern": [
        {"spec": {"hostNetwork": False}},
        {"metadata": {"labels": {"tier": "db"}}},
        {"spec": {"<(hostPID)": True, "dnsPolicy": "Default"}},
    ]},
}

PRECONDITION_DENY_RULE = {
    "name": "labelled-deny",
    "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
    "preconditions": {"all": [{"key": "{{ request.object.metadata.labels.tier || '' }}",
                               "operator": "NotEquals", "value": ""}],
                      "any": [{"key": "{{ request.operation || 'BACKGROUND' }}",
                               "operator": "AnyIn",
                               "value": ["CREATE", "UPDATE", "BACKGROUND"]}]},
    "validate": {"message": "no db on the host network", "deny": {
        "conditions": {"any": [
            {"key": "{{ request.object.spec.hostNetwork || `false` }}",
             "operator": "Equals", "value": True},
            {"key": "{{ request.object.metadata.labels.tier }}",
             "operator": "AnyIn", "value": ["db", "cache"]}]}}},
}

NAMES_RULE = {
    "name": "names-and-namespaces",
    "match": {"any": [{"resources": {
        "kinds": ["Pod"], "names": ["p1*", "p2?", "x"],
        "namespaces": ["prod-*", "default", "team-?"]}}]},
    "exclude": {"any": [{"resources": {"namespaces": ["kube-*"]}}]},
    "validate": {"message": "labelled", "pattern": {
        "metadata": {"labels": {"team": "?*"}}}},
}


def _fold_pods(seed, n=40):
    rng = np.random.default_rng(seed)
    nss = ["default", "prod-a", "team-b", "kube-system", "other"]
    out = []
    for i in range(n):
        labels = {}
        if rng.random() < 0.5:
            labels["tier"] = ["web", "db", "cache", ""][int(rng.integers(0, 4))]
        if rng.random() < 0.4:
            labels["team"] = ["a", ""][int(rng.integers(0, 2))]
        ctrs = []
        for j in range(int(rng.integers(0, 4))):
            c = {"name": ["app", "sidecar", "app2"][int(rng.integers(0, 3))],
                 "image": ["nginx:latest", "nginx:1.2"][int(rng.integers(0, 2))]}
            if rng.random() < 0.6:
                c["imagePullPolicy"] = ["Always", "IfNotPresent"][
                    int(rng.integers(0, 2))]
            if rng.random() < 0.5:
                c["securityContext"] = {"capabilities": {
                    "drop": [["ALL"], ["NET_RAW"], ["ALL", "KILL"], []][
                        int(rng.integers(0, 4))],
                    "add": [["SYS_ADMIN"], ["NET_BIND_SERVICE"], []][
                        int(rng.integers(0, 3))]}}
            if rng.random() < 0.4:
                c["ports"] = [{"containerPort": 80,
                               "hostPort": [0, 8080][int(rng.integers(0, 2))]}
                              for _ in range(int(rng.integers(1, 3)))]
            ctrs.append(c)
        spec = {"containers": ctrs}
        for k, vals in (("hostNetwork", [True, False]),
                        ("hostPID", [True, False]), ("hostIPC", [None, True]),
                        ("dnsPolicy", ["ClusterFirst", "Default"]),
                        ("nodeName", ["n1", ""])):
            if rng.random() < 0.4:
                spec[k] = vals[int(rng.integers(0, len(vals)))]
        ann = {}
        if rng.random() < 0.4:
            ann["container.apparmor.security.beta.kubernetes.io/app"] = \
                ["runtime/default", "unconfined"][int(rng.integers(0, 2))]
        out.append({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": ["p1a", "p22", "x", "q"][i % 4] + str(i % 3),
                                 "namespace": nss[int(rng.integers(0, len(nss)))],
                                 "labels": labels, "annotations": ann},
                    "spec": spec})
    return out


CEL_RULES = [
    {"name": "cel-combo", "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
     "validate": {"cel": {"expressions": [
         {"expression": "has(object.spec.hostNetwork) || "
                        "object.metadata.name == 'x0'"},
         {"expression": "object.metadata.name.matches('^[a-z][a-z0-9]*$')"},
     ]}}},
    {"name": "cel-absorb", "match": {"any": [{"resources": {"kinds": ["Pod"]}}]},
     "validate": {"cel": {"expressions": [
         {"expression": "object.spec.nodeName.matches('^n') || true"},
         {"expression": "!(false && object.spec.missing.matches('x'))"},
         {"expression": "object.spec.dnsPolicy != 'Default'"},
     ]}}},
]

NODE_KIND_SETS = {
    "map-anchors": [MAP_ANCHORS_RULE, EXISTENCE_RULE],
    "wildcard-anchor": [APPARMOR_RULE],
    "arrays": [HOST_PORTS_RULE, ARRAY_SCALAR_RULE],
    "any-pattern": [ANY_PATTERN_RULE],
    "deny": [CAPABILITIES_DENY_RULE, PRECONDITION_DENY_RULE],
    "foreach": [CAP_STRICT_FOREACH, ADD_CAPS_FOREACH],
    "match-lists": [NAMES_RULE],
    "cel": CEL_RULES,
}


@pytest.mark.parametrize("name", list(NODE_KIND_SETS))
def test_node_kind_program_equals_reference(name, monkeypatch):
    jeng = TpuEngine(cps=jcompile([make_policy("p-" + name,
                                               NODE_KIND_SETS[name])]))
    teng = port_engine(jeng)
    n_rules = len(teng.cps.device_programs)
    assert n_rules >= len(NODE_KIND_SETS[name])  # every rule on the device
    calls = []
    real = kernels.class_fold

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(kernels, "class_fold", counted)
    for seed in (0, 1):
        pods = _fold_pods(seed) + [{}] * 8
        batch = jeng.encode(pods)[0]
        jtab, jcnt = jeng.cps.device_fn()(batch)
        run = teng.cps.device_fn()
        calls.clear()
        ttab, tcnt = run(lanes_to_device(batch, "cpu"))
        assert np.array_equal(ttab.numpy(), np.asarray(jtab))
        assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
        # one K11 call a rule, nothing forced off the tape
        assert len(calls) == n_rules and run.stats["fold_forced"] == 0
    assert len(set(np.asarray(jtab).ravel().tolist())) > 1


def test_pss_program_one_fold_a_rule():
    """The dense PSS program (66 rules) on the CPU: one K11 call a rule,
    no forced value, and a second run reuses every compiled tape."""
    pols = [jexpand(p) for p in jload_pss()]
    jeng = TpuEngine(cps=jcompile(pols))
    teng = port_engine(jeng)
    batch = jeng.encode(_fold_pods(3, n=24))[0]
    run = teng.cps.device_fn()
    lanes = lanes_to_device(batch, "cpu")
    calls = []
    real = kernels.class_fold_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    kernels.class_fold_plain = counted
    try:
        ttab, _ = run(lanes)
        n_tapes = len(run.fold_cache)
        again, _ = run(lanes)
    finally:
        kernels.class_fold_plain = real
    jtab, _ = jeng.cps.device_fn()(batch)
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert torch.equal(again, ttab)
    n_rules = len(teng.cps.device_programs)
    assert n_rules == 66 and len(calls) == 2 * n_rules
    # rules with the same instructions (autogen copies among them) share
    # one compiled tape; the second run compiles nothing
    assert 0 < n_tapes <= n_rules and len(run.fold_cache) == n_tapes
    assert run.stats["fold_forced"] == 0
