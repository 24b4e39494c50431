# Copied verbatim from kyverno_tpu/serving/scheduler.py.
"""Request classes for admission scheduling — tenants, tiers, shedding.

Production admission traffic is not uniform: kubelet-storm rescans and
CI bursts share the queue with latency-critical user applies. This
module defines the *class model* the serving pipeline schedules by:

- **RequestClass** — the flow identity ``(tenant, operation,
  priority)``. Each distinct class is its own weighted-fair flow in the
  queue; the priority *tier* (``critical`` / ``default`` / ``bulk``)
  decides its weight, its shed thresholds, and its flush eligibility.
- **classify_request** — class extraction from admission-request
  metadata (username globs, dry-run flag, groups, a resource
  annotation), driven by a **ClassifyConfig** the ``serve`` flags tune.
- **burn-driven shed ladder helpers** — the bulk tier sheds first when
  the SLO burn signal (observability/analytics.py SloTracker) crosses
  its threshold; the default tier sheds at a higher threshold;
  the critical tier is never burn-shed (only the global high-water
  mark can refuse it).

Everything here is stdlib-only and jax-free, like the rest of
``serving/`` — the scheduler must be importable by the CLI and the
metrics layer without pulling in the device runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

# priority tiers, most-protected first. Rank drives shutdown-drain
# order and the shed ladder; WEIGHTS drives steady-state fairness.
PRIORITY_CRITICAL = "critical"
PRIORITY_DEFAULT = "default"
PRIORITY_BULK = "bulk"
PRIORITIES = (PRIORITY_CRITICAL, PRIORITY_DEFAULT, PRIORITY_BULK)
PRIORITY_RANK = {PRIORITY_CRITICAL: 0, PRIORITY_DEFAULT: 1, PRIORITY_BULK: 2}

DEFAULT_CLASS_WEIGHTS = {PRIORITY_CRITICAL: 8.0, PRIORITY_DEFAULT: 4.0,
                         PRIORITY_BULK: 1.0}

# resource annotation that routes a single request's class. The
# annotation lives on the ADMITTED RESOURCE — requester-controlled —
# so by default it may only DEMOTE (bulk/default): honoring a
# self-stamped "critical" would let exactly the flood traffic this
# scheduler exists to contain promote itself past the shed ladder.
# Promotion via the annotation requires the operator to opt in
# (ClassifyConfig.trust_annotation_critical / identity-based
# --critical-users globs stay the trusted promotion path).
PRIORITY_ANNOTATION = "policies.kyverno.io/priority"


class RequestClass(NamedTuple):
    """One weighted-fair flow: tenant x operation x priority tier."""

    tenant: str
    operation: str
    priority: str


def priority_of(cls: Any) -> str:
    """Priority tier of a class descriptor; ``None`` (legacy callers
    that never classify) and bare strings degrade gracefully."""
    if cls is None:
        return PRIORITY_DEFAULT
    pri = getattr(cls, "priority", cls)
    return pri if pri in PRIORITY_RANK else PRIORITY_DEFAULT


def priority_rank(cls: Any) -> int:
    return PRIORITY_RANK[priority_of(cls)]


@dataclass
class ClassifyConfig:
    """Class-extraction rules (``serve --bulk-users/--critical-users``).

    Username patterns are shell globs matched case-sensitively against
    ``request.userInfo.username``. Defaults mark the classic storm
    sources — kubelets and kube-system controllers — as bulk; dry-run
    admissions (rescan storms replay with dryRun) are bulk too."""

    bulk_users: Tuple[str, ...] = ("system:node:*",
                                   "system:serviceaccount:kube-system:*")
    critical_users: Tuple[str, ...] = ()
    bulk_groups: Tuple[str, ...] = ("system:nodes",)
    dry_run_bulk: bool = True
    annotation: str = PRIORITY_ANNOTATION
    # opt-in: honor a requester-stamped "critical" annotation. OFF by
    # default — the annotation is on the admitted resource, so trusting
    # it lets any flood self-promote past the overload ladder
    trust_annotation_critical: bool = False


def _match_any(patterns: Sequence[str], value: str) -> bool:
    return any(fnmatchcase(value, p) for p in patterns if p)


def classify_request(config: Optional[ClassifyConfig] = None, *,
                     operation: str = "", username: str = "",
                     namespace: str = "", groups: Sequence[str] = (),
                     dry_run: bool = False,
                     resource: Optional[Dict[str, Any]] = None
                     ) -> RequestClass:
    """Extract the scheduling class from admission-request metadata.

    Precedence: trusted identity first — critical user globs, then
    dry-run / bulk user / bulk group demotion. The resource annotation
    may only DEMOTE from there, and never below what the operator's
    identity globs granted: a ``--critical-users`` identity stays
    critical regardless of the annotation, because the annotation lives
    on the admitted OBJECT — authored by whoever last wrote it, not by
    the requester — so honoring it against a trusted identity would let
    anyone who can annotate an object demote someone else's critical
    traffic into the shed ladder. It PROMOTES to critical only when the
    operator opted in via ``trust_annotation_critical``. The tenant is
    the namespace (cluster-scoped resources fall back to the username,
    then ``_cluster``) so per-tenant fairness holds inside a tier."""
    cfg = config or ClassifyConfig()
    tenant = namespace or username or "_cluster"
    if _match_any(cfg.critical_users, username):
        pri = PRIORITY_CRITICAL
    elif (dry_run and cfg.dry_run_bulk) \
            or _match_any(cfg.bulk_users, username) \
            or any(g in cfg.bulk_groups for g in groups or ()):
        pri = PRIORITY_BULK
    else:
        pri = PRIORITY_DEFAULT
    annotated = ""
    if resource is not None:
        meta = resource.get("metadata") or {}
        annotated = str((meta.get("annotations") or {}
                         ).get(cfg.annotation, "")).lower()
    if annotated in PRIORITY_RANK and annotated != pri:
        if PRIORITY_RANK[annotated] > PRIORITY_RANK[pri]:
            if pri != PRIORITY_CRITICAL:
                pri = annotated  # demotion, but never of trusted identity
        elif cfg.trust_annotation_critical:
            pri = annotated  # promotion: operator opt-in only
    return RequestClass(tenant=tenant, operation=operation, priority=pri)


def class_weight(weights: Optional[Dict[str, float]], cls: Any) -> float:
    w = float((weights or DEFAULT_CLASS_WEIGHTS).get(
        priority_of(cls), DEFAULT_CLASS_WEIGHTS[PRIORITY_DEFAULT]))
    if not (0.0 < w < float("inf")):
        # NaN/inf/non-positive from a library-built dict would poison
        # every finish tag (parse_class_weights rejects them at the CLI)
        w = DEFAULT_CLASS_WEIGHTS[PRIORITY_DEFAULT]
    return max(w, 1e-9)


def parse_class_weights(text: str) -> Dict[str, float]:
    """``critical=8,default=4,bulk=1`` -> weight dict (serve flag)."""
    out = dict(DEFAULT_CLASS_WEIGHTS)
    for pair in (text or "").split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"bad class weight {pair!r} (want tier=weight)")
        tier, _, raw = pair.partition("=")
        tier = tier.strip()
        if tier not in PRIORITY_RANK:
            raise ValueError(
                f"unknown priority tier {tier!r} (known: {PRIORITIES})")
        w = float(raw)
        # `not (w > 0)` also rejects NaN, which passes a `w <= 0`
        # check and would silently poison every WFQ finish tag
        if not (w > 0) or w == float("inf"):
            raise ValueError(
                f"class weight must be positive and finite: {pair!r}")
        out[tier] = w
    return out


def burn_shed_threshold(config: Any, cls: Any) -> float:
    """The burn-rate level above which this class sheds; 0 disables.
    The ladder: bulk first (lowest threshold), then default; critical
    never burn-sheds — only the hard high-water mark refuses it."""
    pri = priority_of(cls)
    if pri == PRIORITY_BULK:
        return float(getattr(config, "shed_burn_bulk", 0.0) or 0.0)
    if pri == PRIORITY_DEFAULT:
        return float(getattr(config, "shed_burn_default", 0.0) or 0.0)
    return 0.0
