"""TorchEngine (kyverno_tpu_torch) against the JAX package's device
program, end to end on the CPU.

``TorchEngine(device="cpu").scan_device`` must return the verdict table
and the per-rule verdict-class counts that ``cps.device_fn()`` of the
JAX package computes on the same resources (bucket-pad columns
subtracted from the counts, as TpuEngine._dispatch does), and
``TorchEngine.scan`` the scalar-completed ScanResult that
``TpuEngine.scan`` returns: on the autogen-expanded PSS library over
the seeded PSS generator, and on the corpora of the JAX parity modules.
Every comparison is exact: int32 outputs."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu.engine import TpuEngine
from kyverno_tpu_torch import kernels
from kyverno_tpu_torch.tpu.engine import TorchEngine

from test_tpu_pss_parity import _resource
from torch_parity_util import (CORPUS_PARAMS, Recorded,
                               assert_full_scan_equal, assert_same_program,
                               assert_scan_equal, port_engine,
                               port_policies, record_corpus)
from torch_parity_util import fresh_port_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pss():
    """The PSS set compiled once per module by each package (the JAX
    program's CPU jit is the expensive part)."""
    jeng = TpuEngine([expand_policy(p) for p in load_pss_policies()])
    teng = port_engine(jeng)
    return jeng, teng


def _pss_batch(seed, n):
    rng = random.Random(seed)
    resources = [_resource(rng, i) for i in range(n)]
    operations = [rng.choice(["", "CREATE", "UPDATE", "DELETE"])
                  for _ in resources]
    return resources, operations


def test_pss_compiles_to_the_reference_program(pss):
    jeng, teng = pss
    assert_same_program(jeng, teng)
    assert teng.coverage() == jeng.coverage()
    assert len(teng.cps.device_programs) == 66
    assert teng.rules == [(e.policy_name, e.rule_name) for e in jeng.cps.rules
                          if e.device_row is not None]


@pytest.mark.parametrize("seed", [7, 21, 1234])
def test_pss_scan_equals_reference(pss, seed):
    """N = 37 pads to a bucket of 64: 27 pad columns leave the counts."""
    jeng, teng = pss
    resources, operations = _pss_batch(seed, 37)
    assert teng.bucket_size(37) == 64
    assert_scan_equal(jeng, teng, Recorded(jeng, resources, None, operations,
                                           None))


def test_pss_counts_cover_live_columns_only(pss):
    _, teng = pss
    resources, operations = _pss_batch(99, 37)
    table, counts = teng.scan_device(resources, operations=operations)
    assert table.shape == (66, 37)
    assert counts.shape == (66, 7)
    assert (counts.sum(axis=1) == 37).all()
    want = np.stack([(table == c).sum(axis=1) for c in range(7)], 1)
    assert np.array_equal(counts, want)


@pytest.mark.parametrize("module,name", CORPUS_PARAMS)
def test_corpus_scan_equals_reference(monkeypatch, module, name):
    ports = {}
    for rec in record_corpus(monkeypatch, module, name):
        key = id(rec.engine)
        if key not in ports:
            ports[key] = port_engine(rec.engine)
            assert_same_program(rec.engine, ports[key])
        assert_scan_equal(rec.engine, ports[key], rec)
        assert_full_scan_equal(ports[key], rec)


def test_port_loads_no_jax_and_nothing_of_the_reference():
    """Importing the port and running a CPU scan, a pipelined scan and a
    mutate triage loads no jax* and no kyverno_tpu.* module (a fresh
    interpreter)."""
    code = (
        "import sys\n"
        "from kyverno_tpu_torch.policies import load_pss_policies\n"
        "from kyverno_tpu_torch.policy.autogen import expand_policy\n"
        "from kyverno_tpu_torch.tpu.engine import TorchEngine\n"
        "from kyverno_tpu_torch.tpu import convert\n"
        "import kyverno_tpu_torch.kernels\n"
        "eng = TorchEngine([expand_policy(p) for p in load_pss_policies()],"
        " device='cpu')\n"
        "pod = {'apiVersion': 'v1', 'kind': 'Pod', 'metadata': {'name': 'p',"
        " 'namespace': 'd'}, 'spec': {'containers': [{'name': 'c',"
        " 'image': 'nginx', 'securityContext': {'privileged': True}}]}}\n"
        "res = eng.scan([pod])\n"
        "assert res.verdicts.shape == (66, 1)\n"
        "import kyverno_tpu_torch.parallel.sharding\n"
        "import kyverno_tpu_torch.native\n"
        "import kyverno_tpu_torch.encode.tasks\n"
        "import kyverno_tpu_torch.engine.engine\n"
        "import kyverno_tpu_torch.cluster.snapshot\n"
        "from kyverno_tpu_torch.parallel import ShardedScanner\n"
        "sc = ShardedScanner(eng.cps.policies, device='cpu')\n"
        "out, stats = sc.scan_stream([pod] * 3, tile=16)\n"
        "assert out.verdicts.shape == (66, 3) and stats['tiles'] == 1\n"
        "from kyverno_tpu_torch.mutation.coordinator import apply_mutations\n"
        "tri = eng.triage_mutate([pod])\n"
        "assert tri.verdicts.shape == (0, 1)\n"
        "assert not apply_mutations(eng, pod, tri.rows_for(0)).changed\n"
        "import kyverno_tpu_torch.encode.pool, kyverno_tpu_torch.encode.worker\n"
        "import kyverno_tpu_torch.cluster.columnar, kyverno_tpu_torch.tpu.cache\n"
        "import kyverno_tpu_torch.resilience.storage\n"
        "import kyverno_tpu_torch.observability.analytics\n"
        "from kyverno_tpu_torch.tpu.pipeline import PipelinedScanner\n"
        "st = PipelinedScanner(sc).scan_chunks([[pod] * 3, [pod]])\n"
        "assert st['chunks'] == 2 and st['encode_fallback_chunks'] == 0\n"
        "import kyverno_tpu_torch.serving, kyverno_tpu_torch.webhooks\n"
        "import kyverno_tpu_torch.lifecycle\n"
        "import kyverno_tpu_torch.cluster.policycache\n"
        "import kyverno_tpu_torch.observability.events\n"
        "import kyverno_tpu_torch.observability.verification\n"
        "import kyverno_tpu_torch.cluster, kyverno_tpu_torch.reports\n"
        "import kyverno_tpu_torch.analysis, kyverno_tpu_torch.policy.validation\n"
        "import kyverno_tpu_torch.cluster.scanner, kyverno_tpu_torch.cluster.webhookconfig\n"
        "from kyverno_tpu_torch.parallel import make_mesh, make_mesh_2d\n"
        "m = ShardedScanner(eng.cps.policies, mesh=make_mesh_2d(1, 2, ['cpu'] * 2))\n"
        "assert (m.scan([pod] * 3).verdicts == sc.scan([pod] * 3).verdicts).all()\n"
        "import kyverno_tpu_torch.fleet, kyverno_tpu_torch.parallel\n"
        "import kyverno_tpu_torch.dryrun, kyverno_tpu_torch.cli.flight\n"
        "import kyverno_tpu_torch.cluster.leaderelection\n"
        "import kyverno_tpu_torch.images, kyverno_tpu_torch.engine.manifests\n"
        "import kyverno_tpu_torch.utils.jsonpatch, kyverno_tpu_torch.engine.userinfo\n"
        "import kyverno_tpu_torch.config, kyverno_tpu_torch.globalcontext\n"
        "import kyverno_tpu_torch.vap, kyverno_tpu_torch.cluster.lifecycle\n"
        "import kyverno_tpu_torch.pss, kyverno_tpu_torch.webhooks.server\n"
        "import kyverno_tpu_torch.cli.apply, kyverno_tpu_torch.cli.serve\n"
        "import kyverno_tpu_torch.cli.__main__, kyverno_tpu_torch.__main__\n"
        "from kyverno_tpu_torch.api.policy import ClusterPolicy\n"
        "from kyverno_tpu_torch.cluster import PolicyCache, ClusterSnapshot\n"
        "from kyverno_tpu_torch.webhooks import AdmissionServer, build_handlers\n"
        "pc = PolicyCache()\n"
        "pc.set(ClusterPolicy.from_dict({'apiVersion': 'kyverno.io/v1',"
        " 'kind': 'ClusterPolicy', 'metadata': {'name': 'iv'}, 'spec': {'rules':"
        " [{'name': 'r', 'match': {'any': [{'resources': {'kinds': ['Pod']}}]},"
        " 'verifyImages': [{'imageReferences': ['*'], 'verifyDigest': True,"
        " 'mutateDigest': False, 'required': False}]}]}}))\n"
        "for p in eng.cps.policies[:3]: pc.set(p)\n"
        "h = build_handlers(pc, ClusterSnapshot(), batching=True,"
        " mutate_batching=True, device='cpu')\n"
        "rv = {'request': {'uid': 'u', 'operation': 'CREATE', 'namespace': 'd',"
        " 'object': pod}}\n"
        "assert h.validate(rv)['response']['uid'] == 'u'\n"
        "assert h.mutate(rv)['response']['uid'] == 'u'\n"
        "assert h.debug_state()['perf_caches']['xla_cache_dir'] is None\n"
        "h.pipeline.stop(); h.mutate_pipeline.stop(); h.batcher.stop()\n"
        "from kyverno_tpu_torch.cli.__main__ import build_parser\n"
        "build_parser()\n"
        "import pkgutil, importlib, kyverno_tpu_torch\n"
        "for mi in pkgutil.walk_packages(kyverno_tpu_torch.__path__,"
        " 'kyverno_tpu_torch.'):\n"
        "    importlib.import_module(mi.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'kyverno_tpu.')) or m == 'kyverno_tpu')\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_port_imports_resolve_inside_the_port():
    """Every import statement of the port, the ones inside functions
    included: a relative import names a module of the port that exists
    and the names it takes from it, and no import names ``jax`` or
    ``kyverno_tpu``. Reading the source finds the lazy imports that no
    run reaches."""
    import ast
    import importlib

    root = os.path.join(REPO, "kyverno_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            pkg = rel[:-len(".__init__")] if f == "__init__.py" \
                else rel.rpartition(".")[0]
            for node in ast.walk(ast.parse(open(path).read())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    names = [node.module or ""]
                elif isinstance(node, ast.ImportFrom):
                    parts = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                    target = ".".join(parts + ([node.module]
                                               if node.module else []))
                    try:
                        mod = importlib.import_module(target)
                    except ImportError as e:
                        bad.append((path, node.lineno, target, str(e)))
                        continue
                    for a in node.names:
                        if a.name != "*" and not hasattr(mod, a.name):
                            try:
                                importlib.import_module(f"{target}.{a.name}")
                            except ImportError:
                                bad.append((path, node.lineno, target, a.name))
                    continue
                else:
                    continue
                for n in names:
                    if n.split(".")[0] in ("jax", "jaxlib", "kyverno_tpu"):
                        bad.append((path, node.lineno, n, "forbidden"))
    assert bad == []


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policies = port_policies([expand_policy(p) for p in
                              load_pss_policies("disallow-privileged")])
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(policies)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(policies, device="cuda")
    assert TorchEngine(policies, device="cpu").device.type == "cpu"


def test_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises:
    here the kernel cannot be built, so every wrapper raises and counts
    no launch."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "_fns", {})
    monkeypatch.setattr(kernels, "_libs", {})
    kernels.reset_launches()
    meta = torch.device("meta")
    table = torch.empty((3, 5), dtype=torch.int32, device=meta)
    pred = torch.empty((2, 8), dtype=torch.bool, device=meta)
    scope = torch.empty((2, 8), dtype=torch.int32, device=meta)
    byt = torch.empty((4, 8), dtype=torch.uint8, device=meta)
    lens = torch.empty((4,), dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.verdict_counts(table)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.instance_count(pred, scope, pred, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.instance_count2(pred, scope, scope, pred, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.nonascii(byt, lens)
    with pytest.raises(TypeError):
        kernels.verdict_counts(table.to(torch.int64))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
