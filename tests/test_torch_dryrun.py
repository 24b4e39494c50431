"""The port's dry run (kyverno_tpu_torch/dryrun.py), the counterpart of
the reference's ``__graft_entry__.py``, on meshes of CPU entries: the
2-axis mesh's table and counts equal the one-device run's exactly, the
privileged Pods fail, the streamed scan covers every resource and
exactly one of the hosts' electors leads. ``entry()`` gives the
reference's table and counts on the same 16 Pods. Tolerance: exact."""

import numpy as np
import pytest

from kyverno_tpu.policies import load_pss_policies
from kyverno_tpu.policy.autogen import expand_policy
from kyverno_tpu.tpu.compiler import compile_policy_set
from kyverno_tpu.tpu.evaluator import batch_to_device, build_program
from kyverno_tpu.tpu.flatten import encode_resources
from kyverno_tpu.tpu.metadata import encode_metadata
from kyverno_tpu_torch.dryrun import _tiny_resources, dryrun_multichip, entry

from torch_parity_util import fresh_port_state  # noqa: F401


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu_entries(n):
    out = dryrun_multichip(n, ["cpu"] * n)
    assert out["devices"] == ["cpu"] * n and out["distinct"] == ["cpu"]
    assert out["mesh"] == {"hosts": 2, "data": n // 2}
    assert out["resources"] == 2 * n and out["tiles"] == 1
    assert out["rules"] == 66 and out["leader"] == "host-0"


def test_dryrun_multichip_needs_n_devices():
    with pytest.raises(RuntimeError, match="need 4 devices, have 3"):
        dryrun_multichip(4, ["cpu"] * 3)


def test_entry_matches_the_reference_entry():
    """The port's ``entry(device="cpu")`` against the reference's program
    on the same 16 Pods (its ``entry()``'s inputs)."""
    cps = compile_policy_set([expand_policy(p) for p in load_pss_policies()])
    fn = build_program(cps.device_programs, cps.encode_cfg.max_instances,
                       dfa=cps.dfa, with_counts=True)
    resources = _tiny_resources(16)
    rows = encode_resources(resources, cps.encode_cfg, cps.byte_paths,
                            cps.key_byte_paths)
    want_table, want_counts = fn(batch_to_device(rows,
                                                 encode_metadata(resources)))
    pfn, args = entry(device="cpu")
    table, counts = pfn(*args)
    assert np.array_equal(table.numpy(), np.asarray(want_table))
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    assert (table.numpy() == 2).any()  # the privileged Pods fail
