# Copied verbatim from kyverno_tpu/pss/__init__.py.
"""Pod Security Standards evaluation for ``validate.podSecurity`` rules.

Native implementation of the PSS controls the reference gets from
k8s.io/pod-security-admission (wrapped in pkg/pss/evaluate.go):
``level: baseline|restricted`` (+ ``version``), with Kyverno
``exclude`` entries suppressing individual control failures.

Each violation records WHERE it came from — the canonical
restrictedField path for its container section and the offending
values — because exclusions are field-scoped: an entry with
``restrictedField``/``values`` only exempts violations at that exact
field whose offending values are all covered by the listed values
(pkg/pss/evaluate.go ExemptProfile); ``images`` globs further scope
container-level exclusions to matching images.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..engine.response import RULE_TYPE_VALIDATION, RuleResponse
from ..utils import wildcard

# (control, detail, violating image ("" = pod-level),
#  restrictedField path, offending values)
Violation = Tuple[str, str, str, str, List[Any]]


def _pod_spec(resource: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    kind = resource.get("kind")
    if kind == "Pod":
        return resource.get("spec") or {}
    # controller kinds carry a pod template
    spec = resource.get("spec") or {}
    template = spec.get("template") or {}
    if kind == "CronJob":
        template = ((spec.get("jobTemplate") or {}).get("spec") or {}).get("template") or {}
    return template.get("spec") if template else None


def _sectioned(spec: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """(section, container) pairs — the section names the
    restrictedField root (spec.containers[*] vs spec.initContainers[*]
    vs spec.ephemeralContainers[*])."""
    out = []
    for key in ("initContainers", "containers", "ephemeralContainers"):
        out.extend((key, c) for c in spec.get(key) or [])
    return out


# --------------------------------------------------------------------------
# baseline controls

# pod-security-admission capabilities_baseline.go capabilities_allowed:
# baseline is an ALLOWLIST — adding anything beyond it (including
# unknown capability names) is a violation
_BASELINE_ALLOWED_CAPS = {
    "AUDIT_WRITE", "CHOWN", "DAC_OVERRIDE", "FOWNER", "FSETID", "KILL",
    "MKNOD", "NET_BIND_SERVICE", "SETFCAP", "SETGID", "SETPCAP",
    "SETUID", "SYS_CHROOT",
}

_ALLOWED_VOLUME_TYPES_RESTRICTED = {
    "configMap", "csi", "downwardAPI", "emptyDir", "ephemeral",
    "persistentVolumeClaim", "projected", "secret",
}


def _check_host_namespaces(spec, sections) -> List[Violation]:
    out = []
    for fieldname in ("hostNetwork", "hostPID", "hostIPC"):
        if spec.get(fieldname):
            out.append(("Host Namespaces", f"{fieldname} is not allowed", "",
                        f"spec.{fieldname}", [True]))
    return out


def _check_privileged(spec, sections) -> List[Violation]:
    return [
        ("Privileged Containers", f"container {c.get('name')!r} is privileged",
         c.get("image", ""),
         f"spec.{sec}[*].securityContext.privileged", [True])
        for sec, c in sections
        if (c.get("securityContext") or {}).get("privileged")
    ]


def _check_capabilities_baseline(spec, sections) -> List[Violation]:
    out = []
    for sec, c in sections:
        caps = ((c.get("securityContext") or {}).get("capabilities") or {}).get("add") or []
        bad = [cap for cap in caps if cap not in _BASELINE_ALLOWED_CAPS]
        if bad:
            out.append(("Capabilities", f"container {c.get('name')!r} adds {sorted(bad)}",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.capabilities.add", bad))
    return out


def _check_host_path(spec, sections) -> List[Violation]:
    # map-valued restricted fields expose the map KEYS as bad values
    # (conformance: exclusion restrictedField spec.volumes[*].hostPath
    # with values ["path"] exempts a {path: ...} hostPath volume)
    return [
        ("HostPath Volumes", f"volume {v.get('name')!r} uses hostPath", "",
         "spec.volumes[*].hostPath", sorted((v.get("hostPath") or {}).keys()) or [""])
        for v in spec.get("volumes") or []
        if "hostPath" in v
    ]


def _check_host_ports(spec, sections) -> List[Violation]:
    out = []
    for sec, c in sections:
        for p in c.get("ports") or []:
            if p.get("hostPort"):
                out.append(("Host Ports",
                            f"container {c.get('name')!r} uses hostPort {p['hostPort']}",
                            c.get("image", ""),
                            f"spec.{sec}[*].ports[*].hostPort", [p["hostPort"]]))
    return out


def _check_selinux(spec, sections) -> List[Violation]:
    allowed = {"", "container_t", "container_init_t", "container_kvm_t", "container_engine_t"}
    out = []
    for sec, scope in [("", spec)] + list(sections):
        img = scope.get("image", "") if scope is not spec else ""
        root = (f"spec.{sec}[*].securityContext" if scope is not spec
                else "spec.securityContext")
        opts = (scope.get("securityContext") or {}).get("seLinuxOptions") or {}
        if opts.get("type") and opts["type"] not in allowed:
            out.append(("SELinux", f"seLinuxOptions.type {opts['type']!r} is not allowed",
                        img, f"{root}.seLinuxOptions.type", [opts["type"]]))
        for f in ("user", "role"):
            if opts.get(f):
                out.append(("SELinux", f"seLinuxOptions {f} may not be set",
                            img, f"{root}.seLinuxOptions.{f}", [opts[f]]))
    return out


def _check_proc_mount(spec, sections) -> List[Violation]:
    # "default" is accepted case-insensitively (conformance: psa/
    # test-exclusion-procmount admits procMount: default)
    return [
        ("/proc Mount Type", f"container {c.get('name')!r} uses procMount={sc['procMount']}",
         c.get("image", ""),
         f"spec.{sec}[*].securityContext.procMount", [sc["procMount"]])
        for sec, c in sections
        for sc in [c.get("securityContext") or {}]
        if sc.get("procMount") is not None
        and str(sc["procMount"]).lower() != "default"
    ]


def _check_seccomp_baseline(spec, sections) -> List[Violation]:
    # baseline (v1.19+ seccompProfile_baseline): IF set, the type must
    # be RuntimeDefault or Localhost — unknown types are forbidden too
    out = []
    prof = ((spec.get("securityContext") or {}).get("seccompProfile") or {}).get("type")
    if prof is not None and prof not in ("RuntimeDefault", "Localhost"):
        out.append(("Seccomp", f"pod: seccompProfile.type {prof!r} is not allowed",
                    "", "spec.securityContext.seccompProfile.type", [prof]))
    for sec, c in sections:
        prof = ((c.get("securityContext") or {}).get("seccompProfile") or {}).get("type")
        if prof is not None and prof not in ("RuntimeDefault", "Localhost"):
            out.append(("Seccomp",
                        f"{c.get('name')}: seccompProfile.type {prof!r} is not allowed",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.seccompProfile.type",
                        [prof]))
    return out


def _check_sysctls(spec, sections) -> List[Violation]:
    safe = {
        "kernel.shm_rmid_forced", "net.ipv4.ip_local_port_range",
        "net.ipv4.ip_unprivileged_port_start", "net.ipv4.tcp_syncookies",
        "net.ipv4.ping_group_range", "net.ipv4.tcp_keepalive_time",
        "net.ipv4.tcp_fin_timeout", "net.ipv4.tcp_keepalive_intvl",
        "net.ipv4.tcp_keepalive_probes",
    }
    out = []
    for s in (spec.get("securityContext") or {}).get("sysctls") or []:
        if s.get("name") not in safe:
            out.append(("Sysctls", f"sysctl {s.get('name')!r} is not allowed", "",
                        "spec.securityContext.sysctls[*].name", [s.get("name")]))
    return out


def _check_windows_host_process(spec, sections) -> List[Violation]:
    out = []
    opts = ((spec.get("securityContext") or {}).get("windowsOptions") or {})
    if opts.get("hostProcess"):
        out.append(("HostProcess", "pod: hostProcess is not allowed", "",
                    "spec.securityContext.windowsOptions.hostProcess", [True]))
    for sec, c in sections:
        opts = ((c.get("securityContext") or {}).get("windowsOptions") or {})
        if opts.get("hostProcess"):
            out.append(("HostProcess", f"{c.get('name')}: hostProcess is not allowed",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.windowsOptions.hostProcess",
                        [True]))
    return out


# --------------------------------------------------------------------------
# restricted controls


def _check_volume_types(spec, sections) -> List[Violation]:
    out = []
    for v in spec.get("volumes") or []:
        kinds = set(v.keys()) - {"name"}
        bad = kinds - _ALLOWED_VOLUME_TYPES_RESTRICTED
        for t in sorted(bad):
            # one violation per restricted type, keyed by its field
            # with the type's map keys as bad values (see hostPath)
            keys = sorted(v[t].keys()) if isinstance(v[t], dict) else [v[t]]
            out.append(("Volume Types", f"volume {v.get('name')!r} uses {t}",
                        "", f"spec.volumes[*].{t}", keys or [""]))
    return out


def _check_privilege_escalation(spec, sections) -> List[Violation]:
    return [
        ("Privilege Escalation",
         f"container {c.get('name')!r} must set allowPrivilegeEscalation=false",
         c.get("image", ""),
         f"spec.{sec}[*].securityContext.allowPrivilegeEscalation",
         [(c.get("securityContext") or {}).get("allowPrivilegeEscalation")])
        for sec, c in sections
        if (c.get("securityContext") or {}).get("allowPrivilegeEscalation") is not False
    ]


def _check_run_as_non_root(spec, sections) -> List[Violation]:
    pod_level = (spec.get("securityContext") or {}).get("runAsNonRoot")
    out = []
    for sec, c in sections:
        c_level = (c.get("securityContext") or {}).get("runAsNonRoot")
        effective = c_level if c_level is not None else pod_level
        if effective is not True:
            # the violating field is the one actually set (container
            # overrides pod; neither set -> the container field)
            if c_level is None and pod_level is not None:
                field = "spec.securityContext.runAsNonRoot"
            else:
                field = f"spec.{sec}[*].securityContext.runAsNonRoot"
            out.append(("Running as Non-root",
                        f"container {c.get('name')!r} must set runAsNonRoot=true",
                        c.get("image", ""), field, [effective]))
    return out


def _check_run_as_user(spec, sections) -> List[Violation]:
    out = []
    if (spec.get("securityContext") or {}).get("runAsUser") == 0:
        out.append(("Running as Non-root user", "pod runAsUser=0 is not allowed",
                    "", "spec.securityContext.runAsUser", [0]))
    for sec, c in sections:
        if (c.get("securityContext") or {}).get("runAsUser") == 0:
            out.append(("Running as Non-root user",
                        f"container {c.get('name')!r} runAsUser=0",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.runAsUser", [0]))
    return out


def _check_seccomp_restricted(spec, sections) -> List[Violation]:
    pod_prof = ((spec.get("securityContext") or {}).get("seccompProfile") or {}).get("type")
    out = []
    for sec, c in sections:
        prof = ((c.get("securityContext") or {}).get("seccompProfile") or {}).get("type")
        effective = prof if prof is not None else pod_prof
        if effective not in ("RuntimeDefault", "Localhost"):
            if prof is None and pod_prof is not None:
                field = "spec.securityContext.seccompProfile.type"
            else:
                field = f"spec.{sec}[*].securityContext.seccompProfile.type"
            out.append(("Seccomp", f"container {c.get('name')!r} must set seccompProfile",
                        c.get("image", ""), field, [effective]))
    return out


def _check_capabilities_restricted(spec, sections) -> List[Violation]:
    out = []
    for sec, c in sections:
        caps = (c.get("securityContext") or {}).get("capabilities") or {}
        drops = caps.get("drop") or []
        if "ALL" not in drops:
            out.append(("Capabilities", f"container {c.get('name')!r} must drop ALL",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.capabilities.drop", drops))
        adds = sorted(set(caps.get("add") or []) - {"NET_BIND_SERVICE"})
        if adds:
            out.append(("Capabilities", f"container {c.get('name')!r} adds {adds}",
                        c.get("image", ""),
                        f"spec.{sec}[*].securityContext.capabilities.add", adds))
    return out


# (control title, check fn, upstream CheckResult.ID, upstream
# ForbiddenReason) — ids/reasons per pod-security-admission policy/
# checks and the reference's PSS_controls_to_check_id
# (pkg/pss/utils/mapping.go:45)
_BASELINE_CHECKS: List[Tuple[str, Callable, str, str]] = [
    ("Host Namespaces", _check_host_namespaces,
     "hostNamespaces", "host namespaces"),
    ("Privileged Containers", _check_privileged,
     "privileged", "privileged"),
    ("Capabilities", _check_capabilities_baseline,
     "capabilities_baseline", "non-default capabilities"),
    ("HostPath Volumes", _check_host_path,
     "hostPathVolumes", "hostPath volumes"),
    ("Host Ports", _check_host_ports, "hostPorts", "hostPort"),
    ("SELinux", _check_selinux, "seLinuxOptions", "seLinuxOptions"),
    ("/proc Mount Type", _check_proc_mount, "procMount", "procMount"),
    ("Seccomp", _check_seccomp_baseline,
     "seccompProfile_baseline", "seccompProfile"),
    ("Sysctls", _check_sysctls, "sysctls", "forbidden sysctls"),
    ("HostProcess", _check_windows_host_process,
     "windowsHostProcess", "hostProcess"),
]

_RESTRICTED_CHECKS: List[Tuple[str, Callable, str, str]] = _BASELINE_CHECKS + [
    ("Volume Types", _check_volume_types,
     "restrictedVolumes", "restricted volume types"),
    ("Privilege Escalation", _check_privilege_escalation,
     "allowPrivilegeEscalation", "allowPrivilegeEscalation != false"),
    ("Running as Non-root", _check_run_as_non_root,
     "runAsNonRoot", "runAsNonRoot != true"),
    ("Running as Non-root user", _check_run_as_user,
     "runAsUser", "runAsUser=0"),
    ("Seccomp", _check_seccomp_restricted,
     "seccompProfile_restricted", "seccompProfile"),
    ("Capabilities", _check_capabilities_restricted,
     "capabilities_restricted", "unrestricted capabilities"),
]


def evaluate_pss(level: str, resource: Dict[str, Any]) -> List[Violation]:
    """Run the control set for ``level`` over a pod-bearing resource."""
    return [v for v, _, _ in evaluate_pss_detailed(level, resource)]


def evaluate_pss_detailed(
        level: str, resource: Dict[str, Any]
) -> List[Tuple[Violation, str, str]]:
    """(violation, check id, upstream forbidden reason) triples — the
    id/reason pair feeds report properties and the reference-format
    failure message (evaluate.go:331 FormatChecksPrint)."""
    spec = _pod_spec(resource)
    if spec is None:
        return []
    sections = _sectioned(spec)
    checks = _RESTRICTED_CHECKS if level == "restricted" else _BASELINE_CHECKS
    out: List[Tuple[Violation, str, str]] = []
    for _, check, check_id, reason in checks:
        out.extend((v, check_id, reason) for v in check(spec, sections))
    return out


def _stringify(v: Any) -> str:
    if v is True:
        return "true"
    if v is False:
        return "false"
    if v is None:
        return "null"
    return str(v)


def _excluded(violation: Violation, resource: Dict[str, Any],
              excludes: List[Dict[str, Any]]) -> bool:
    """pkg/pss ExemptProfile semantics: controlName must match; images
    globs scope container-level exclusions to matching images (a
    glob-bearing exclusion never exempts pod-level violations); a
    restrictedField-bearing exclusion only exempts violations at that
    exact field whose offending values are ALL covered by the listed
    values (wildcards allowed)."""
    control, _, image, field, values = violation
    for ex in excludes:
        if ex.get("controlName") != control:
            continue
        globs = ex.get("images") or []
        if globs and not (image and any(wildcard.match(g, image) for g in globs)):
            continue
        rf = ex.get("restrictedField")
        if rf and rf != field:
            continue
        if ex.get("values") is not None:
            # values apply even without a restrictedField: every
            # offending value must be covered (evaluate.go:104-113)
            exvals = [str(x) for x in ex["values"]]
            if not all(any(wildcard.match(p, _stringify(v)) for p in exvals)
                       for v in values):
                continue
        return True
    return False


def _indexed_field(resource: Dict[str, Any], field_path: str,
                   detail: str) -> str:
    """Replace the '[*]' section wildcard in a violation's
    restrictedField with the offending container's index (upstream
    field errors are index-addressed: spec.containers[0]....)."""
    if "[*]" not in field_path:
        return field_path
    m = re.search(r"'([^']+)'", detail)
    spec = _pod_spec(resource) or {}
    section = field_path.split(".")[1].split("[")[0]
    containers = spec.get(section)
    idx = 0
    if m and isinstance(containers, list):
        for i, c in enumerate(containers):
            if isinstance(c, dict) and c.get("name") == m.group(1):
                idx = i
                break
    return field_path.replace("[*]", f"[{idx}]", 1)


def validate_pod_security(rule_name: str, validation, resource: Dict[str, Any],
                          extra_exclusions=None) -> RuleResponse:
    """Entry point used by the engine for validate.podSecurity rules.
    ``extra_exclusions``: podSecurity controls contributed by matching
    PolicyExceptions (validate_pss.go HasPodSecurity branch)."""
    ps = validation.pod_security or {}
    level = ps.get("level", "baseline")
    version = ps.get("version", "latest")
    excludes = (ps.get("exclude") or []) + list(extra_exclusions or [])
    detailed = [(v, cid, reason)
                for v, cid, reason in evaluate_pss_detailed(level, resource)
                if not _excluded(v, resource, excludes)]
    if not detailed:
        return RuleResponse.rule_pass(rule_name, RULE_TYPE_VALIDATION, "")
    # reference failure format (validate_pss.go:107 + evaluate.go:331
    # FormatChecksPrint): one block per failed upstream check, field
    # errors index-addressed; properties carry the failed check ids
    # (report rows assert on both)
    groups: Dict[str, List[str]] = {}
    reasons: Dict[str, str] = {}
    for v, cid, reason in detailed:
        _, det, _, fpath, _ = v
        fpath = _indexed_field(resource, fpath, det)
        err = "Required value" if fpath.endswith(".capabilities.drop") \
            else "Forbidden"
        groups.setdefault(cid, []).append(f"{fpath}: {err}")
        reasons[cid] = reason
    msg = (f"Validation rule '{rule_name}' failed. It violates PodSecurity "
           f'"{level}:{version}": ')
    for cid, errs in groups.items():
        msg += (f"\n(Forbidden reason: {reasons[cid]}, "
                f"field error list: [{', '.join(errs)}])")
    return RuleResponse.rule_fail(
        rule_name, RULE_TYPE_VALIDATION, msg,
        properties={"controls": ",".join(sorted(groups)),
                    "standard": level, "version": version},
    )
