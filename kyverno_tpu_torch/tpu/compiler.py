"""Policy set -> compiled device artifact (the port of
kyverno_tpu/tpu/compiler.py, validate bank only).

compile_policy_set lowers every validate rule of every policy through
the IR compiler (ir.py). Rules using constructs outside the device
subset are recorded as host rules (``RuleEntry.fallback_reason``).
Every glob and regex a device rule evaluates is registered with one DFA
bank (dfa.py), finalized for the strided scan.

Not ported yet: the mutate-rule bank and its triage program, the
verdict-cache identity (``cache_key``) and the observability spans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api.policy import ClusterPolicy
from ..engine.operator import Operator
from ..utils.wildcard import contains_wildcard
from .dfa import DfaBank, DfaUnsupported, state_budget
from .evaluator import build_program
from .flatten import EncodeConfig, plan_byte_pool
from .ir import (
    ArrayMapsNode,
    ArrayScalarNode,
    DynKey,
    DynSlot,
    DynValueRef,
    ExistenceNode,
    LeafNode,
    MapNode,
    RuleProgram,
    StrLeaf,
    Unsupported,
    compile_rule,
)
from .metadata import MetaConfig


def _iter_cond_irs(prog: RuleProgram):
    """Every CondIR in a program's precondition/deny/foreach trees."""
    trees = [prog.preconditions, prog.deny] + [f.tree for f in prog.foreach]
    for tree in trees:
        if tree is None:
            continue
        for any_block, all_block in tree.blocks:
            yield from any_block
            yield from all_block


@dataclass
class RuleEntry:
    policy_idx: int
    policy_name: str
    rule_name: str
    device_row: Optional[int]      # row in the device verdict table
    fallback_reason: Optional[str]  # set for host rules

    @property
    def pattern_host(self) -> bool:
        """Host rule whose fallback is pattern-caused (non-lowerable
        regex etc.) — the coverage accounting distinguishes these
        cells from other host cells."""
        return bool(self.fallback_reason
                    and self.fallback_reason.startswith("pattern:"))


# ---------------------------------------------------------------------------
# DFA bank collection: every glob/regex operand a compiled program
# evaluates, registered per byte-lane family (tpu/dfa.py)


def _leaf_glob_operands(leaf) -> List[str]:
    if not isinstance(leaf, StrLeaf):
        return []
    return [c.operand
            for units in leaf.alternatives for unit in units for c in unit
            if c.is_glob and c.operand != "*"
            and c.op in (Operator.EQUAL, Operator.NOT_EQUAL)]


def _walk_pattern_globs(specs: List[Tuple[str, str, str]], node) -> None:
    if node is None:
        return
    if isinstance(node, (LeafNode, ArrayScalarNode)):
        for g in _leaf_glob_operands(node.leaf):
            specs.append(("glob", g, "pool"))
        return
    if isinstance(node, MapNode):
        for a in node.anchors:
            _walk_pattern_globs(specs, a.child)
            _note_wildcard_key(specs, a.wildcard)
        for c in node.phase2:
            _walk_pattern_globs(specs, c.child)
            _note_wildcard_key(specs, c.wildcard)
        return
    if isinstance(node, ArrayMapsNode):
        _walk_pattern_globs(specs, node.element)
        return
    if isinstance(node, ExistenceNode):
        for el in node.elements:
            _walk_pattern_globs(specs, el)


def _note_wildcard_key(specs: List[Tuple[str, str, str]], wc) -> None:
    if wc is None:
        return
    specs.append(("glob", wc.glob, "pool"))  # key bytes share the pool
    for g in _leaf_glob_operands(wc.leaf):
        specs.append(("glob", g, "pool"))


def _program_pattern_specs(prog: RuleProgram) -> List[Tuple[str, str, str]]:
    """Every (kind, pattern, lane-family) a compiled program matches
    through the DFA bank."""
    specs: List[Tuple[str, str, str]] = []
    for root in prog.patterns:
        _walk_pattern_globs(specs, root)
    for block in (prog.match, prog.exclude):
        if block is None:
            continue
        for f in block.filters:
            for nm in ([f.name] if f.name else []) + list(f.names):
                if contains_wildcard(nm):
                    specs.append(("glob", nm, "name"))
            for ns in f.namespaces:
                if contains_wildcard(ns):
                    specs.append(("glob", ns, "ns"))
                    # Namespace-kind resources compare their NAME
                    specs.append(("glob", ns, "name"))
            if f.selector is not None:
                for k_pat, v_pat in getattr(f.selector, "wild_labels", ()):
                    specs.append(("glob", k_pat, "labels_kb"))
                    specs.append(("glob", v_pat, "labels_vb"))
    for rx in prog.regex_patterns:
        specs.append(("re2", rx, "pool"))
    return specs


def _register_program_patterns(bank: DfaBank, prog: RuleProgram,
                               owner: Optional[str] = None) -> bool:
    """Register a program's patterns; returns whether it has any
    (pattern-cell accounting rides prog.uses_patterns). ``owner``
    attributes the patterns to a policy/rule for /debug/rules."""
    specs = _program_pattern_specs(prog)
    for kind, pattern, family in specs:
        if kind == "re2":
            bank.add_re2(pattern, family, owner=owner)
        else:
            bank.add_glob(pattern, family, owner=owner)
    return bool(specs)


@dataclass
class CompiledPolicySet:
    policies: List[ClusterPolicy]
    rules: List[RuleEntry]
    device_programs: List[RuleProgram]
    byte_paths: Set[int]
    key_byte_paths: Set[int]
    encode_cfg: EncodeConfig
    meta_cfg: MetaConfig
    # compile-time context specialization: configmaps folded into the
    # programs, "namespace/name" -> content hash at compile
    context_deps: Dict[str, Optional[str]] = field(default_factory=dict)
    # global host-resolved operand slots (per-request context values
    # feeding the device program as canonical lanes)
    dyn_slots: List[DynSlot] = field(default_factory=list)
    # the policy set's compiled pattern tables (tpu/dfa.py)
    dfa: Optional[DfaBank] = None
    _fns: Dict[bool, Callable] = field(default_factory=dict, repr=False)

    @property
    def host_rule_policies(self) -> List[int]:
        """Policy indices owning at least one host-fallback rule."""
        return sorted({e.policy_idx for e in self.rules if e.device_row is None})

    def device_fn(self, plain: bool = False) -> Callable:
        """The batch program, built once per compiled set (and per
        ``plain``), returning (verdict table, per-rule verdict-class
        counts) — evaluator.build_program."""
        if plain not in self._fns:
            self._fns[plain] = build_program(
                self.device_programs, self.encode_cfg.max_instances,
                dfa=self.dfa, plain=plain)
        return self._fns[plain]

    def coverage(self) -> Tuple[int, int]:
        dev = sum(1 for e in self.rules if e.device_row is not None)
        return dev, len(self.rules)


def compile_policy_set(
    policies: Sequence[ClusterPolicy],
    encode_cfg: Optional[EncodeConfig] = None,
    meta_cfg: Optional[MetaConfig] = None,
    data_sources=None,
) -> CompiledPolicySet:
    """Lower the validate rules of ``policies`` (mutate rules are not
    part of the port yet and are ignored)."""
    encode_cfg = encode_cfg or EncodeConfig()
    meta_cfg = meta_cfg or MetaConfig()
    entries: List[RuleEntry] = []
    programs: List[RuleProgram] = []
    byte_paths: Set[int] = set()
    key_byte_paths: Set[int] = set()
    deps: Dict[str, Optional[str]] = {}
    dyn_slots: List[DynSlot] = []
    bank = DfaBank(state_budget())
    for pi, policy in enumerate(policies):
        for rule in policy.get_rules():
            if not rule.has_validate():
                continue
            try:
                prog = compile_rule(policy, rule, data_sources, deps)
                # register the rule's patterns with the bank BEFORE
                # committing the program: a full bank demotes the rule
                # to host instead of compiling an unevaluable program
                try:
                    prog.uses_patterns = _register_program_patterns(
                        bank, prog, owner=f"{policy.name}/{rule.name}")
                except DfaUnsupported as e:
                    raise Unsupported(f"pattern: {e}")
                row = len(programs)
                if prog.dyn_slots:
                    # rebase rule-local operand slots onto the global
                    # slot table the runtime fills per batch
                    base = len(dyn_slots)
                    dyn_slots.extend(prog.dyn_slots)
                    for ir_cond in _iter_cond_irs(prog):
                        if isinstance(ir_cond.key, DynKey):
                            ir_cond.key.slot += base
                        if isinstance(ir_cond.value, DynValueRef):
                            ir_cond.value.slot += base
                programs.append(prog)
                byte_paths |= prog.byte_paths
                key_byte_paths |= prog.key_byte_paths
                entries.append(RuleEntry(pi, policy.name, rule.name, row, None))
            except Unsupported as e:
                entries.append(RuleEntry(pi, policy.name, rule.name, None, str(e)))
    # dense encodes only pay for label byte lanes when some compiled
    # selector actually globs. The flag lives on a COPY: the caller's
    # MetaConfig may be shared across compiles.
    import copy as _copy

    meta_cfg = _copy.copy(meta_cfg)
    meta_cfg.label_bytes_enabled = any(
        getattr(sel, "wild_labels", None)
        for prog in programs
        for block in (prog.match, prog.exclude) if block is not None
        for f in block.filters
        for sel in (f.selector, f.ns_selector) if sel is not None)
    bank.finalize()
    # byte-lane capacity planning: pattern-referenced paths need pool
    # slots (the cfg copy keeps the caller's EncodeConfig untouched)
    encode_cfg = plan_byte_pool(encode_cfg, byte_paths, key_byte_paths)
    return CompiledPolicySet(
        policies=list(policies),
        rules=entries,
        device_programs=programs,
        byte_paths=byte_paths,
        key_byte_paths=key_byte_paths,
        encode_cfg=encode_cfg,
        meta_cfg=meta_cfg,
        context_deps=deps,
        dyn_slots=dyn_slots,
        dfa=bank,
    )
