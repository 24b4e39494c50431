"""Policy set -> compiled device artifact (the port of
kyverno_tpu/tpu/compiler.py).

compile_policy_set lowers every validate rule of every policy through
the IR compiler (ir.py). Rules using constructs outside the device
subset are recorded as host rules (``RuleEntry.fallback_reason``).
The mutate rules' needs-mutation predicates (mutation/triage.py) are
lowered the same way into a second program, the mutate bank, after
the validate rules. Every glob and regex a device rule of either bank
evaluates is registered with one DFA bank (dfa.py), finalized for the
strided scan.

The compiled set carries the verdict-cache identity (``cache_key``),
the analytics identities (``policy_spec_hashes``) and the bank-size
gauges (``publish_dfa_gauges``). ``quarantine=`` takes the policies the
lifecycle manager (lifecycle/manager.py) quarantined out of lowering.
Not ported: the observability spans.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api.policy import ClusterPolicy, Rule
from ..engine.operator import Operator
from ..utils.wildcard import contains_wildcard
from .dfa import DfaBank, DfaUnsupported, state_budget
from .evaluator import bank_columns, build_program
from .flatten import EncodeConfig, plan_byte_pool
from .graphs import graphed
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
# the mutation package only pulls api/engine-level modules — no cycle
from ..mutation.lowering import (PatchTemplate, lower_mutate_rule,
                                 paths_conflict, rule_read_paths,
                                 rule_write_paths)
from ..mutation.triage import triage_rule


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
                               owner: Optional[str] = None
                               ) -> List[Tuple[str, str]]:
    """Register a program's patterns and set ``prog.uses_patterns``
    (pattern-cell accounting rides it). Returns the (lane family, glob)
    pairs the bank refused: they take the NFA route (kernel K9).
    ``owner`` attributes the patterns to a policy/rule for
    /debug/rules."""
    specs = _program_pattern_specs(prog)
    refused: List[Tuple[str, str]] = []
    for kind, pattern, family in specs:
        if kind == "re2":
            bank.add_re2(pattern, family, owner=owner)
        elif bank.add_glob(pattern, family, owner=owner) is None:
            refused.append((family, pattern))
    prog.uses_patterns = bool(specs)
    return refused


def nonascii_families(bank: Optional[DfaBank],
                      programs: Sequence[RuleProgram],
                      nfa_globs: Dict[str, List[str]]) -> frozenset:
    """The lane families whose K1 launch writes the non-ASCII flag for
    ``programs``: those the programs scan through the bank that need
    the flag, for a bank pattern with ``confirm_nonascii`` or a '?'
    glob of the family on the NFA route. Another family's flag (a '?'
    glob of a family no bank pattern of these programs scans) takes the
    standalone B4 entry; no family scanned without need asks for it."""
    cols = bank_columns(bank)
    if not cols:
        return frozenset()
    scanned: Set[str] = set()
    need: Set[str] = {f for f, globs in nfa_globs.items()
                      if any("?" in g for g in globs)}
    for prog in programs:
        for kind, pattern, family in _program_pattern_specs(prog):
            pid = (bank.glob_ids if kind == "glob"
                   else bank.re2_ids).get(pattern)
            if pid is None or pid not in cols.get(family, {}):
                continue
            scanned.add(family)
            if bank.patterns[pid].confirm_nonascii:
                need.add(family)
    return frozenset(scanned & need)


def _note_nfa_globs(nfa_globs: Dict[str, List[str]],
                    refused: List[Tuple[str, str]]) -> None:
    """Add a committed program's NFA-route globs to each family's list
    (in order of first use, once each)."""
    for family, pattern in refused:
        globs = nfa_globs.setdefault(family, [])
        if pattern not in globs:
            globs.append(pattern)


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
    # lifecycle quarantine: policy indices excluded from lowering
    # (their rules are host-fallback RuleEntries tagged "quarantined:"),
    # with the compile error that put them there
    quarantined: Dict[int, str] = field(default_factory=dict)
    # the policy set's compiled pattern tables (tpu/dfa.py)
    dfa: Optional[DfaBank] = None
    # mutate-rule bank (mutation/): one RuleEntry per mutate rule in
    # policy order, device_row indexing mutate_programs (the compiled
    # needs-mutation triage predicates), with a parallel list of
    # lowered patch templates (None = scalar patcher when positive)
    mutate_entries: List[RuleEntry] = field(default_factory=list)
    mutate_programs: List[RuleProgram] = field(default_factory=list)
    mutate_templates: List[Optional[PatchTemplate]] = field(default_factory=list)
    # each lane family's globs the bank refused, of the validate and of
    # the mutate programs: build_program packs them for kernel K9
    nfa_globs: Dict[str, List[str]] = field(default_factory=dict)
    mutate_nfa_globs: Dict[str, List[str]] = field(default_factory=dict)
    _fns: Dict[bool, Callable] = field(default_factory=dict, repr=False)
    _mutate_fns: Dict[bool, Callable] = field(default_factory=dict,
                                              repr=False)
    _cache_key: Optional[str] = field(default=None, repr=False)
    _policy_spec_hashes: Optional[List[str]] = field(default=None, repr=False)

    @property
    def host_rule_policies(self) -> List[int]:
        """Policy indices owning at least one host-fallback rule."""
        return sorted({e.policy_idx for e in self.rules if e.device_row is None})

    def device_fn(self, plain: bool = False, device=None) -> Callable:
        """The batch program, built once per compiled set (and per
        ``plain``), returning (verdict table, per-rule verdict-class
        counts) — evaluator.build_program. With a CUDA ``device`` (and
        not ``plain``) the program replays as one CUDA graph per shape
        bucket (``tpu/graphs.py``); the eager program is its ``run``."""
        if plain not in self._fns:
            self._fns[plain] = build_program(
                self.device_programs, self.encode_cfg.max_instances,
                dfa=self.dfa, plain=plain, nfa_globs=self.nfa_globs,
                na_families=nonascii_families(
                    self.dfa, self.device_programs, self.nfa_globs))
        return graphed(self._fns[plain], device, plain)

    @property
    def mutate_rules(self) -> List[Tuple[str, str]]:
        """Bank-ordered (policy_name, rule_name) idents — the row
        identity shared by triage verdicts, templates, and the
        coordinator."""
        return [(e.policy_name, e.rule_name) for e in self.mutate_entries]

    def mutate_device_fn(self, plain: bool = False, device=None) -> Callable:
        """The triage batch program over the mutate bank, built once
        per compiled set (and per ``plain``): the same shape contract
        as device_fn minus the analytics counts, so it returns the
        int32 verdict table alone. Graphed on a CUDA ``device`` as
        ``device_fn`` is."""
        if plain not in self._mutate_fns:
            self._mutate_fns[plain] = build_program(
                self.mutate_programs, self.encode_cfg.max_instances,
                with_counts=False, dfa=self.dfa, plain=plain,
                nfa_globs=self.mutate_nfa_globs,
                na_families=nonascii_families(
                    self.dfa, self.mutate_programs, self.mutate_nfa_globs))
        return graphed(self._mutate_fns[plain], device, plain)

    def coverage(self) -> Tuple[int, int]:
        dev = sum(1 for e in self.rules if e.device_row is not None)
        return dev, len(self.rules)

    def mutate_coverage(self) -> Tuple[int, int]:
        dev = sum(1 for e in self.mutate_entries
                  if e.device_row is not None)
        return dev, len(self.mutate_entries)

    # the three below are copied from kyverno_tpu/tpu/compiler.py

    def policy_spec_hashes(self) -> List[str]:
        """Per-policy analytics identity (spec-content hash), memoized
        — RuleStatsAccumulator keys rule rows with these so stats
        survive snapshot swaps and renames."""
        if self._policy_spec_hashes is None:
            from ..observability.analytics import policy_spec_hash

            self._policy_spec_hashes = [policy_spec_hash(p)
                                        for p in self.policies]
        return self._policy_spec_hashes

    def publish_dfa_gauges(self) -> None:
        """Point the bank-size gauges at THIS set. Called when a set
        becomes the serving artifact (engine construction) — NOT on
        every compile."""
        if self.dfa is None:
            return
        try:
            from ..observability.metrics import global_registry as _reg

            stats = self.dfa.stats()
            _reg.dfa_tables.set(stats["tables"])
            _reg.dfa_states.set(stats["states"])
            _reg.dfa_bytes.set(stats["bytes"])
            for k, n in stats["stride_hist"].items():
                _reg.dfa_stride_tables.set(n, {"stride": k})
            _reg.dfa_stride_bytes.set(stats["stride_bytes"])
            _reg.dfa_approx_states_merged.set(stats["states_merged"])
            _reg.dfa_approx_error_max.set(stats["max_approx_error"])
        except Exception:  # noqa: BLE001
            pass  # metrics must never block the serving path

    def cache_key(self) -> str:
        """Content identity of this compiled artifact — the policy-set
        half of every verdict-cache key (tpu/cache.py). Covers
        everything that can change a verdict column for a fixed
        (resource, request): policy content, quarantine set, encode and
        metadata caps, the content hashes of every compile-folded context
        dependency and the DFA bank's digest — the reference's key, item
        for item, so both packages key a set alike."""
        if self._cache_key is None:
            from ..lifecycle.snapshot import policy_content_hash
            from .cache import digest

            self._cache_key = digest(
                [policy_content_hash(p) for p in self.policies],
                sorted(self.quarantined.items()),
                sorted(self.context_deps.items()),
                (self.encode_cfg.max_rows, self.encode_cfg.max_instances,
                 self.encode_cfg.byte_pool_slots,
                 self.encode_cfg.byte_pool_width),
                sorted(vars(self.meta_cfg).items()),
                sorted(self.byte_paths), sorted(self.key_byte_paths),
                self.dfa.digest() if self.dfa is not None else "")
        return self._cache_key


def compile_policy_set(
    policies: Sequence[ClusterPolicy],
    encode_cfg: Optional[EncodeConfig] = None,
    meta_cfg: Optional[MetaConfig] = None,
    data_sources=None,
    quarantine: Optional[Dict[int, str]] = None,
) -> CompiledPolicySet:
    """Lower the validate rules of ``policies``, then the triage
    predicates of their mutate rules into the mutate bank.

    ``quarantine`` maps policy indices the lifecycle manager has
    quarantined (their last compile CRASHED, not merely Unsupported) to
    the error string; their rules skip lowering entirely and become
    host-fallback entries, so the rest of the set still runs on the
    device while the quarantined policy degrades to the scalar oracle
    (per-rule ERROR when even the oracle cannot evaluate it)."""
    encode_cfg = encode_cfg or EncodeConfig()
    meta_cfg = meta_cfg or MetaConfig()
    quarantine = dict(quarantine or {})
    entries: List[RuleEntry] = []
    programs: List[RuleProgram] = []
    byte_paths: Set[int] = set()
    key_byte_paths: Set[int] = set()
    deps: Dict[str, Optional[str]] = {}
    dyn_slots: List[DynSlot] = []
    nfa_globs: Dict[str, List[str]] = {}
    bank = DfaBank(state_budget())
    for pi, policy in enumerate(policies):
        q_err = quarantine.get(pi)
        for rule in policy.get_rules():
            if not rule.has_validate():
                continue
            if q_err is not None:
                entries.append(RuleEntry(pi, policy.name, rule.name, None,
                                         f"quarantined: {q_err}"))
                continue
            try:
                prog = compile_rule(policy, rule, data_sources, deps)
                # register the rule's patterns with the bank BEFORE
                # committing the program: a full bank demotes the rule
                # to host instead of compiling an unevaluable program
                try:
                    refused = _register_program_patterns(
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
                _note_nfa_globs(nfa_globs, refused)
                byte_paths |= prog.byte_paths
                key_byte_paths |= prog.key_byte_paths
                entries.append(RuleEntry(pi, policy.name, rule.name, row, None))
            except Unsupported as e:
                entries.append(RuleEntry(pi, policy.name, rule.name, None, str(e)))
    # mutate-rule bank: the same lowering ladder for needs-mutation
    # triage predicates. Pass 1 walks policy order demoting
    # chain-dependent predicates to host (an earlier mutate rule may
    # write a path this rule's predicate reads; the scalar chain
    # evaluates against patched-so-far, device triage against the
    # ORIGINAL — triaging such a rule on device would be unsound).
    # Pass 2 compiles the survivors through the same IR path as
    # validate, sharing the DFA bank and byte-path planning.
    mutate_entries: List[RuleEntry] = []
    mutate_programs: List[RuleProgram] = []
    mutate_templates: List[Optional[PatchTemplate]] = []
    mutate_nfa_globs: Dict[str, List[str]] = {}
    collected: List[Tuple[int, ClusterPolicy, Rule, bool]] = []
    writes_so_far: List = []
    for pi, policy in enumerate(policies):
        for rule in policy.get_rules():
            if not rule.has_mutate():
                continue
            reads = rule_read_paths(rule)
            conflict = any(paths_conflict(w, reads) for w in writes_so_far)
            collected.append((pi, policy, rule, conflict))
            # demoted rules still WRITE — later predicates must see them
            writes_so_far.append(rule_write_paths(rule))
    for pi, policy, rule, conflict in collected:
        tmpl = lower_mutate_rule(rule)
        if tmpl is not None:
            tmpl.policy_name = policy.name
        mutate_templates.append(tmpl)
        q_err = quarantine.get(pi)
        if q_err is not None:
            mutate_entries.append(RuleEntry(pi, policy.name, rule.name, None,
                                            f"quarantined: {q_err}"))
            continue
        if conflict:
            mutate_entries.append(RuleEntry(
                pi, policy.name, rule.name, None,
                "chain-dependent: an earlier mutate rule may write a "
                "path this rule's predicate reads"))
            continue
        try:
            prog = compile_rule(policy, triage_rule(rule),
                                data_sources, deps)
            if prog.dyn_slots:
                # triage must not push operand slots into the shared
                # slot table — that would flip the validate bank's
                # cache eligibility. Host-route instead.
                raise Unsupported("context: dynamic operand slots")
            try:
                refused = _register_program_patterns(
                    bank, prog, owner=f"{policy.name}/{rule.name}")
            except DfaUnsupported as e:
                raise Unsupported(f"pattern: {e}")
            row = len(mutate_programs)
            mutate_programs.append(prog)
            _note_nfa_globs(mutate_nfa_globs, refused)
            byte_paths |= prog.byte_paths
            key_byte_paths |= prog.key_byte_paths
            mutate_entries.append(RuleEntry(pi, policy.name, rule.name,
                                            row, None))
        except Unsupported as e:
            mutate_entries.append(RuleEntry(pi, policy.name, rule.name,
                                            None, str(e)))
        except Exception as e:  # noqa: BLE001 — a triage compile crash
            # must never fail a policy set that compiled before this
            # bank existed; the rule degrades to host triage
            mutate_entries.append(RuleEntry(pi, policy.name, rule.name,
                                            None,
                                            f"triage compile error: {e}"))
    # dense encodes only pay for label byte lanes when some compiled
    # selector actually globs. The flag lives on a COPY: the caller's
    # MetaConfig may be shared across compiles.
    import copy as _copy

    meta_cfg = _copy.copy(meta_cfg)
    meta_cfg.label_bytes_enabled = any(
        getattr(sel, "wild_labels", None)
        for prog in programs + mutate_programs
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
        quarantined=quarantine,
        dfa=bank,
        mutate_entries=mutate_entries,
        mutate_programs=mutate_programs,
        mutate_templates=mutate_templates,
        nfa_globs=nfa_globs,
        mutate_nfa_globs=mutate_nfa_globs,
    )
