# Copied verbatim from kyverno_tpu/devtools/check_faults.py.
"""fault-site: fire()/arm()/corrupt() literals exist, and sites live.

``FaultRegistry.fire("tpu.dispach")`` is a silent no-op: the typo'd
site is simply never armed, so the degradation path it was supposed to
exercise silently stops being chaos-tested. Today the only guard is
``arm()`` rejecting unknown sites at runtime — which never sees the
misspelled ``fire()`` side. This check closes both directions:

- every string literal (or ``SITE_*`` constant reference) passed to a
  ``fire`` / ``arm`` / ``corrupt`` call must be a ``KNOWN_SITES``
  member of the real package's ``resilience/faults.py``;
- every ``KNOWN_SITES`` member must be referenced somewhere in the
  package outside ``faults.py`` (by constant name or literal) — a dead
  site is an invariant nobody enforces anymore.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from .lintcore import Finding, LintContext

_CALL_ATTRS = ("fire", "arm", "corrupt")


def check(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    used: Set[str] = set()
    const_to_site: Dict[str, str] = ctx.site_constants
    for sf in ctx.files:
        is_faults = sf.rel.endswith("resilience/faults.py") or \
            sf.rel == "resilience/faults.py"
        for node in ast.walk(sf.tree):
            # usage accounting: SITE_* name references and site-shaped
            # literals anywhere in the package (outside faults.py)
            if not is_faults:
                if isinstance(node, ast.Name) and node.id in const_to_site:
                    used.add(const_to_site[node.id])
                elif (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value in ctx.known_sites):
                    used.add(node.value)
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CALL_ATTRS and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                site = arg.value
                # only police site-shaped strings: '.arm(' collides
                # with e.g. datetime interfaces in principle, and a
                # first arg that is not dotted-lowercase is not a site
                if "." in site and site not in ctx.known_sites:
                    findings.append(Finding(
                        check="fault-site", file=sf.rel, line=node.lineno,
                        message=(f"{node.func.attr}() called with unknown "
                                 f"fault site {site!r} — not in "
                                 f"resilience/faults.py KNOWN_SITES")))
            elif isinstance(arg, ast.Name) and arg.id.startswith("SITE_") \
                    and arg.id not in const_to_site:
                findings.append(Finding(
                    check="fault-site", file=sf.rel, line=node.lineno,
                    message=(f"{node.func.attr}() references undefined "
                             f"fault-site constant {arg.id}")))
    # dead sites only make sense when linting the real package (the
    # fixture tree has no faults.py of its own)
    if any(f.rel == "resilience/faults.py" for f in ctx.files):
        for site in sorted(ctx.known_sites - used):
            findings.append(Finding(
                check="fault-site", file="resilience/faults.py", line=1,
                message=(f"fault site {site!r} is registered in "
                         f"KNOWN_SITES but never fired/armed anywhere "
                         f"in the package (dead site)")))
    return findings
