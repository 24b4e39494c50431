# Copied verbatim from kyverno_tpu/engine/jmespath/functions.py.
"""JMESPath function library: the standard builtins plus Kyverno's
custom functions (pkg/engine/jmespath/functions.go:45-81, time.go,
arithmetic.go). Functions receive already-evaluated arguments.
"""

from __future__ import annotations

import base64
import binascii
import datetime as _dt
import hashlib
import ipaddress
import json
import math
import posixpath
import re
from fractions import Fraction
from typing import Any, Callable, Dict, List

from ...utils import wildcard as wildcardpkg
from ...utils.duration import parse_duration
from ...utils.quantity import format_quantity, parse_quantity, quantity_format
from . import gotime, semver
from .errors import ArityError, FunctionError, JMESPathTypeError

# ---------------------------------------------------------------------------
# type helpers


def _type_name(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, (int, float)):
        return "number"
    if isinstance(value, str):
        return "string"
    if isinstance(value, list):
        return "array"
    if isinstance(value, dict):
        return "object"
    return "expref"  # _ExpRef


def _require(fn: str, value, *types: str):
    actual = _type_name(value)
    if actual not in types:
        raise JMESPathTypeError(fn, value, actual, list(types))
    return value


def _require_number(fn, value):
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise JMESPathTypeError(fn, value, _type_name(value), ["number"])
    return value


def _to_go_string(fn: str, value) -> str:
    """Reference custom functions accept string-or-number for several
    args (functions.go ifaceToString)."""
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        raise JMESPathTypeError(fn, value, "boolean", ["string", "number"])
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return str(int(value)) if value == int(value) else repr(value)
    raise JMESPathTypeError(fn, value, _type_name(value), ["string", "number"])


def _go_regex(pattern: str) -> "re.Pattern":
    try:
        return re.compile(pattern)
    except re.error as e:
        raise FunctionError(f"invalid regex {pattern!r}: {e}")


def _go_repl(repl: str):
    """Go regexp.Expand template semantics as a replacement callable:
    ``$$`` is a literal $, ``$name``/``${name}`` reference groups by
    number or name with the longest \\w+ run, and undefined groups
    expand to the empty string (never an error)."""

    def group_or_empty(m, name: str) -> str:
        try:
            g = m.group(int(name)) if name.isdigit() else m.group(name)
        except (IndexError, re.error):
            return ""
        return g or ""

    def expand(m) -> str:
        out = []
        i, n = 0, len(repl)
        while i < n:
            c = repl[i]
            if c != "$":
                out.append(c)
                i += 1
                continue
            if i + 1 >= n:
                out.append("$")
                break
            nxt = repl[i + 1]
            if nxt == "$":
                out.append("$")
                i += 2
                continue
            if nxt == "{":
                j = repl.find("}", i + 2)
                name = repl[i + 2 : j] if j != -1 else ""
                if j == -1 or not re.fullmatch(r"\w+", name):
                    out.append("$")
                    i += 1
                    continue
                out.append(group_or_empty(m, name))
                i = j + 1
                continue
            mm = re.match(r"\w+", repl[i + 1 :])
            if not mm:
                out.append("$")
                i += 1
                continue
            out.append(group_or_empty(m, mm.group(0)))
            i += 1 + len(mm.group(0))
        return "".join(out)

    return expand


# ---------------------------------------------------------------------------
# standard JMESPath builtins


def _fn_abs(fn, args):
    return abs(_require_number(fn, args[0]))


def _fn_avg(fn, args):
    arr = _require(fn, args[0], "array")
    if not arr:
        return None
    for item in arr:
        _require_number(fn, item)
    return sum(arr) / len(arr)


def _fn_ceil(fn, args):
    return math.ceil(_require_number(fn, args[0]))


def _fn_floor(fn, args):
    return math.floor(_require_number(fn, args[0]))


def _fn_contains(fn, args):
    subject, search = args
    if isinstance(subject, str):
        if not isinstance(search, str):
            return False
        return search in subject
    if isinstance(subject, list):
        return any(_deep_eq(item, search) for item in subject)
    raise JMESPathTypeError(fn, subject, _type_name(subject), ["array", "string"])


def _deep_eq(x, y):
    if isinstance(x, bool) != isinstance(y, bool):
        return False
    return x == y


def _fn_ends_with(fn, args):
    return _require(fn, args[0], "string").endswith(_require(fn, args[1], "string"))


def _fn_starts_with(fn, args):
    return _require(fn, args[0], "string").startswith(_require(fn, args[1], "string"))


def _fn_join(fn, args):
    glue = _require(fn, args[0], "string")
    arr = _require(fn, args[1], "array")
    for item in arr:
        _require(fn, item, "string")
    return glue.join(arr)


def _fn_keys(fn, args):
    return list(_require(fn, args[0], "object").keys())


def _fn_values(fn, args):
    return list(_require(fn, args[0], "object").values())


def _fn_length(fn, args):
    v = _require(fn, args[0], "string", "array", "object")
    return len(v)


def _fn_map(fn, args):
    expref, arr = args[0], _require(fn, args[1], "array")
    return [expref.visit(item) for item in arr]


def _fn_max(fn, args):
    return _minmax(fn, args[0], max)


def _fn_min(fn, args):
    return _minmax(fn, args[0], min)


def _minmax(fn, arr, agg):
    _require(fn, arr, "array")
    if not arr:
        return None
    kinds = {_type_name(i) for i in arr}
    if not (kinds <= {"number"} or kinds <= {"string"}):
        raise JMESPathTypeError(fn, arr, "array", ["number array", "string array"])
    return agg(arr)


def _by_key(fn, expref, item):
    key = expref.visit(item)
    if _type_name(key) not in ("number", "string"):
        raise JMESPathTypeError(fn, key, _type_name(key), ["number", "string"])
    return key


def _fn_max_by(fn, args):
    arr, expref = _require(fn, args[0], "array"), args[1]
    if not arr:
        return None
    return max(arr, key=lambda item: _by_key(fn, expref, item))


def _fn_min_by(fn, args):
    arr, expref = _require(fn, args[0], "array"), args[1]
    if not arr:
        return None
    return min(arr, key=lambda item: _by_key(fn, expref, item))


def _fn_sort_by(fn, args):
    arr, expref = _require(fn, args[0], "array"), args[1]
    return sorted(arr, key=lambda item: _by_key(fn, expref, item))


def _fn_sort(fn, args):
    arr = _require(fn, args[0], "array")
    if not arr:
        return []
    kinds = {_type_name(i) for i in arr}
    if not (kinds <= {"number"} or kinds <= {"string"}):
        raise JMESPathTypeError(fn, arr, "array", ["number array", "string array"])
    return sorted(arr)


def _fn_merge(fn, args):
    merged: Dict[str, Any] = {}
    for arg in args:
        merged.update(_require(fn, arg, "object"))
    return merged


def _fn_not_null(fn, args):
    for arg in args:
        if arg is not None:
            return arg
    return None


def _fn_reverse(fn, args):
    v = _require(fn, args[0], "string", "array")
    return v[::-1]


def _fn_to_array(fn, args):
    return args[0] if isinstance(args[0], list) else [args[0]]


def _fn_to_string(fn, args):
    v = args[0]
    if isinstance(v, str):
        return v
    return json.dumps(v, separators=(",", ":"))


def _fn_to_number(fn, args):
    v = args[0]
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        try:
            f = float(v)
            return int(f) if f.is_integer() and "." not in v and "e" not in v.lower() else f
        except ValueError:
            return None
    return None


def _fn_type(fn, args):
    return _type_name(args[0])


# ---------------------------------------------------------------------------
# Kyverno custom functions (functions.go)


def _fn_compare(fn, args):
    a = _require(fn, args[0], "string")
    b = _require(fn, args[1], "string")
    return -1 if a < b else (1 if a > b else 0)


def _fn_equal_fold(fn, args):
    a = _require(fn, args[0], "string")
    b = _require(fn, args[1], "string")
    return a.casefold() == b.casefold()


def _fn_replace(fn, args):
    s = _require(fn, args[0], "string")
    old = _require(fn, args[1], "string")
    new = _require(fn, args[2], "string")
    n = int(_require_number(fn, args[3]))
    if n < 0:
        return s.replace(old, new)
    return s.replace(old, new, n)


def _fn_replace_all(fn, args):
    return _require(fn, args[0], "string").replace(
        _require(fn, args[1], "string"), _require(fn, args[2], "string")
    )


def _fn_to_upper(fn, args):
    return _require(fn, args[0], "string").upper()


def _fn_to_lower(fn, args):
    return _require(fn, args[0], "string").lower()


def _fn_trim(fn, args):
    return _require(fn, args[0], "string").strip(_require(fn, args[1], "string"))


def _fn_trim_prefix(fn, args):
    s = _require(fn, args[0], "string")
    prefix = _require(fn, args[1], "string")
    return s[len(prefix):] if s.startswith(prefix) else s


def _fn_split(fn, args):
    s = _require(fn, args[0], "string")
    sep = _require(fn, args[1], "string")
    if sep == "":
        return list(s)  # Go strings.Split(s, "") splits into characters
    return s.split(sep)


def _fn_regex_replace_all(fn, args):
    pattern = _go_regex(_require(fn, args[0], "string"))
    src = _to_go_string(fn, args[1])
    repl = _go_repl(_to_go_string(fn, args[2]))
    return pattern.sub(repl, src)


def _fn_regex_replace_all_literal(fn, args):
    pattern = _go_regex(_require(fn, args[0], "string"))
    src = _to_go_string(fn, args[1])
    repl = _to_go_string(fn, args[2])
    return pattern.sub(repl.replace("\\", "\\\\"), src)


def _fn_regex_match(fn, args):
    pattern = _go_regex(_require(fn, args[0], "string"))
    return pattern.search(_to_go_string(fn, args[1])) is not None


def _fn_pattern_match(fn, args):
    pattern = _to_go_string(fn, args[0])
    value = _to_go_string(fn, args[1])
    return wildcardpkg.match(pattern, value)


def _fn_label_match(fn, args):
    # functions.go jpLabelMatch: every selector k/v must be present
    # verbatim in the target map (no wildcards here)
    selector = _require(fn, args[0], "object")
    target = _require(fn, args[1], "object")
    for k, v in selector.items():
        if k not in target or target[k] != v:
            return False
    return True


def _fn_to_boolean(fn, args):
    s = _require(fn, args[0], "string")
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    raise FunctionError(f"to_boolean: lowercase argument must be 'true' or 'false', got {s!r}")


# arithmetic with typed operands (arithmetic.go): scalar | quantity | duration


class _Op:
    SCALAR, QUANTITY, DURATION = 0, 1, 2

    def __init__(self, kind, value, fmt="DecimalSI"):
        self.kind = kind
        self.value = value
        self.fmt = fmt


def _parse_operand(fn, value) -> _Op:
    if isinstance(value, bool):
        raise FunctionError(f"{fn}: invalid operand")
    if isinstance(value, (int, float)):
        return _Op(_Op.SCALAR, float(value))
    if isinstance(value, str):
        q = parse_quantity(value)
        if q is not None:
            return _Op(_Op.QUANTITY, q, quantity_format(value))
        d = parse_duration(value)
        if d is not None:
            return _Op(_Op.DURATION, d)
    raise FunctionError(f"{fn}: invalid operand")


def _render_quantity(value: Fraction, fmt: str) -> str:
    return format_quantity(value, fmt)


def _arith(fn, a: _Op, b: _Op, op: str):
    K = (a.kind, b.kind)
    if op in ("add", "sub"):
        if K == (_Op.SCALAR, _Op.SCALAR):
            return a.value + b.value if op == "add" else a.value - b.value
        if K == (_Op.QUANTITY, _Op.QUANTITY):
            v = a.value + b.value if op == "add" else a.value - b.value
            return _render_quantity(v, a.fmt)
        if K == (_Op.DURATION, _Op.DURATION):
            v = a.value + b.value if op == "add" else a.value - b.value
            return gotime.format_go_duration(v)
        raise FunctionError(f"{fn}: {op} types mismatch")
    if op == "mul":
        if K == (_Op.SCALAR, _Op.SCALAR):
            return a.value * b.value
        if K == (_Op.QUANTITY, _Op.SCALAR):
            return _render_quantity(a.value * Fraction(b.value).limit_denominator(10**9), a.fmt)
        if K == (_Op.SCALAR, _Op.QUANTITY):
            return _render_quantity(b.value * Fraction(a.value).limit_denominator(10**9), b.fmt)
        if K == (_Op.DURATION, _Op.SCALAR):
            return gotime.format_go_duration(int(a.value * b.value))
        if K == (_Op.SCALAR, _Op.DURATION):
            return gotime.format_go_duration(int(b.value * a.value))
        raise FunctionError(f"{fn}: multiply types mismatch")
    if op == "div":
        if K == (_Op.SCALAR, _Op.SCALAR):
            if b.value == 0:
                raise FunctionError(f"{fn}: division by zero")
            return a.value / b.value
        if K == (_Op.QUANTITY, _Op.QUANTITY):
            if b.value == 0:
                raise FunctionError(f"{fn}: division by zero")
            return float(a.value / b.value)
        if K == (_Op.QUANTITY, _Op.SCALAR):
            if b.value == 0:
                raise FunctionError(f"{fn}: division by zero")
            return _render_quantity(a.value / Fraction(b.value).limit_denominator(10**9), a.fmt)
        if K == (_Op.DURATION, _Op.DURATION):
            if b.value == 0:
                raise FunctionError(f"{fn}: division by zero")
            return a.value / b.value
        if K == (_Op.DURATION, _Op.SCALAR):
            if b.value == 0:
                raise FunctionError(f"{fn}: division by zero")
            return gotime.format_go_duration(int(a.value / b.value))
        raise FunctionError(f"{fn}: divide types mismatch")
    # modulo
    if K == (_Op.SCALAR, _Op.SCALAR):
        if a.value != int(a.value) or b.value != int(b.value):
            raise FunctionError(f"{fn}: modulo requires integer operands")
        if b.value == 0:
            raise FunctionError(f"{fn}: division by zero")
        return float(math.fmod(int(a.value), int(b.value)))
    if K == (_Op.QUANTITY, _Op.QUANTITY):
        if a.value.denominator != 1 or b.value.denominator != 1:
            raise FunctionError(f"{fn}: modulo requires integer operands")
        if b.value == 0:
            raise FunctionError(f"{fn}: division by zero")
        v = math.fmod(a.value.numerator, b.value.numerator)
        return _render_quantity(Fraction(int(v)), a.fmt)
    if K == (_Op.DURATION, _Op.DURATION):
        if b.value == 0:
            raise FunctionError(f"{fn}: division by zero")
        return gotime.format_go_duration(int(math.fmod(a.value, b.value)))
    raise FunctionError(f"{fn}: modulo types mismatch")


def _fn_add(fn, args):
    return _arith(fn, _parse_operand(fn, args[0]), _parse_operand(fn, args[1]), "add")


def _fn_sum(fn, args):
    arr = _require(fn, args[0], "array")
    if not arr:
        raise FunctionError("sum: at least one element in the array is required")
    result = arr[0]
    for item in arr[1:]:
        result = _arith(fn, _parse_operand(fn, result), _parse_operand(fn, item), "add")
    return result


def _fn_subtract(fn, args):
    return _arith(fn, _parse_operand(fn, args[0]), _parse_operand(fn, args[1]), "sub")


def _fn_multiply(fn, args):
    return _arith(fn, _parse_operand(fn, args[0]), _parse_operand(fn, args[1]), "mul")


def _fn_divide(fn, args):
    return _arith(fn, _parse_operand(fn, args[0]), _parse_operand(fn, args[1]), "div")


def _fn_modulo(fn, args):
    return _arith(fn, _parse_operand(fn, args[0]), _parse_operand(fn, args[1]), "mod")


def _fn_round(fn, args):
    op = _require_number(fn, args[0])
    length = _require_number(fn, args[1])
    if length != int(length):
        raise FunctionError("round: length must be an integer")
    if length < 0:
        raise FunctionError("round: length must be non-negative")
    shift = 10 ** int(length)
    # Go math.Round: half away from zero (functions.go jpRound)
    scaled = op * shift
    rounded = math.floor(scaled + 0.5) if scaled >= 0 else math.ceil(scaled - 0.5)
    return rounded / shift


def _fn_base64_decode(fn, args):
    try:
        return base64.b64decode(_require(fn, args[0], "string")).decode("utf-8")
    except (binascii.Error, UnicodeDecodeError, ValueError) as e:
        raise FunctionError(f"base64_decode: {e}")


def _fn_base64_encode(fn, args):
    return base64.b64encode(_require(fn, args[0], "string").encode("utf-8")).decode("ascii")


def _fn_path_canonicalize(fn, args):
    # filepath.Join on linux: clean the path
    p = posixpath.normpath(_require(fn, args[0], "string"))
    return p


def _fn_truncate(fn, args):
    s = _require(fn, args[0], "string")
    length = _require_number(fn, args[1])
    if length != int(length):
        raise FunctionError("truncate: length must be an integer")
    if length < 0:
        raise FunctionError("truncate: length must be non-negative")
    return s[: int(length)]


def _fn_semver_compare(fn, args):
    version = _require(fn, args[0], "string")
    range_expr = _require(fn, args[1], "string")
    try:
        return semver.match_range(version, range_expr)
    except semver.SemverError as e:
        raise FunctionError(str(e))


def _fn_parse_json(fn, args):
    try:
        return json.loads(_require(fn, args[0], "string"))
    except ValueError as e:
        raise FunctionError(f"parse_json: {e}")


def _fn_parse_yaml(fn, args):
    import yaml

    try:
        return yaml.safe_load(_require(fn, args[0], "string"))
    except yaml.YAMLError as e:
        raise FunctionError(f"parse_yaml: {e}")


def _fn_lookup(fn, args):
    collection, key = args
    if isinstance(collection, dict):
        _require(fn, key, "string")
        return collection.get(key)
    if isinstance(collection, list):
        _require_number(fn, key)
        if key != int(key):
            raise FunctionError("lookup: array index must be integer")
        i = int(key)
        if i < 0 or i >= len(collection):
            return None
        return collection[i]
    raise JMESPathTypeError(fn, collection, _type_name(collection), ["object", "array"])


def _fn_items(fn, args):
    collection = _require(fn, args[0], "object", "array")
    key_name = _require(fn, args[1], "string")
    val_name = _require(fn, args[2], "string")
    out = []
    if isinstance(collection, dict):
        # functions.go:1076-1085 sorts object keys
        for k in sorted(collection.keys()):
            out.append({key_name: k, val_name: collection[k]})
    else:
        for i, v in enumerate(collection):
            out.append({key_name: float(i), val_name: v})
    return out


def _fn_object_from_lists(fn, args):
    keys = _require(fn, args[0], "array")
    values = _require(fn, args[1], "array")
    out = {}
    for i, k in enumerate(keys):
        _require(fn, k, "string")
        out[k] = values[i] if i < len(values) else None
    return out


_RANDOM_CLASS_RE = re.compile(r"\[([^\]]+)\]\{(\d+)\}")


def _fn_random(fn, args):
    """Subset of goregen: sequences of [charclass]{n} groups and
    literal characters."""
    import secrets

    pattern = _require(fn, args[0], "string")

    def expand_class(cls: str) -> str:
        chars = []
        i = 0
        while i < len(cls):
            if i + 2 < len(cls) and cls[i + 1] == "-":
                lo, hi = cls[i], cls[i + 2]
                chars.extend(chr(c) for c in range(ord(lo), ord(hi) + 1))
                i += 3
            else:
                chars.append(cls[i])
                i += 1
        return "".join(chars)

    out = []
    pos = 0
    for m in _RANDOM_CLASS_RE.finditer(pattern):
        out.append(pattern[pos:m.start()])
        alphabet = expand_class(m.group(1))
        if not alphabet:
            raise FunctionError("random: empty character class")
        out.append("".join(secrets.choice(alphabet) for _ in range(int(m.group(2)))))
        pos = m.end()
    out.append(pattern[pos:])
    return "".join(out)


def _fn_x509_decode(fn, args):
    """x509_decode (functions.go:1177 jpX509Decode): PEM CERTIFICATE or
    CERTIFICATE REQUEST -> Go x509.Certificate-shaped object. RSA only,
    with PublicKey rendered {N: decimal string, E: int} like the
    reference's PublicKey override (functions.go:1212-1215)."""
    pem_text = _require(fn, args[0], "string")
    try:
        from cryptography import x509 as cx509
        from cryptography.hazmat.primitives.asymmetric import rsa
    except ImportError as e:  # pragma: no cover - baked into the image
        raise FunctionError(f"x509_decode: crypto backend unavailable: {e}")
    data = pem_text.encode()
    if b"-----BEGIN" not in data:
        raise FunctionError("x509_decode: failed to decode PEM block")
    is_csr = b"CERTIFICATE REQUEST" in data
    try:
        import warnings

        with warnings.catch_warnings():
            # Go's parser accepts non-positive serial numbers; match it
            warnings.simplefilter("ignore")
            if is_csr:
                cert = cx509.load_pem_x509_csr(data)
            else:
                cert = cx509.load_pem_x509_certificate(data)
    except ValueError as e:
        raise FunctionError(f"x509_decode: {e}")
    pub = cert.public_key()
    if not isinstance(pub, rsa.RSAPublicKey):
        raise FunctionError("x509_decode: certificate should use rsa algorithm")
    numbers = pub.public_numbers()

    def _name(n):
        # pkix.Name JSON shape (the fields Go marshals)
        oid = {k: [a.value for a in n.get_attributes_for_oid(v)]
               for k, v in (
                   ("Country", cx509.NameOID.COUNTRY_NAME),
                   ("Organization", cx509.NameOID.ORGANIZATION_NAME),
                   ("OrganizationalUnit", cx509.NameOID.ORGANIZATIONAL_UNIT_NAME),
                   ("Locality", cx509.NameOID.LOCALITY_NAME),
                   ("Province", cx509.NameOID.STATE_OR_PROVINCE_NAME),
                   ("StreetAddress", cx509.NameOID.STREET_ADDRESS),
                   ("PostalCode", cx509.NameOID.POSTAL_CODE),
               )}
        cn = n.get_attributes_for_oid(cx509.NameOID.COMMON_NAME)
        sn = n.get_attributes_for_oid(cx509.NameOID.SERIAL_NUMBER)
        return {
            **oid,
            "SerialNumber": sn[0].value if sn else "",
            "CommonName": cn[0].value if cn else "",
            # pkix.AttributeTypeAndValue.Type is asn1.ObjectIdentifier,
            # which Go JSON-marshals as an int array
            "Names": [{"Type": [int(x) for x in a.oid.dotted_string.split(".")],
                       "Value": a.value} for a in n],
            "ExtraNames": None,
        }

    # x509.SignatureAlgorithm enum values (crypto/x509 constants)
    sig_algs = {
        "1.2.840.113549.1.1.2": 1, "1.2.840.113549.1.1.4": 2,
        "1.2.840.113549.1.1.5": 3, "1.2.840.113549.1.1.11": 4,
        "1.2.840.113549.1.1.12": 5, "1.2.840.113549.1.1.13": 6,
        "1.2.840.10040.4.3": 7, "2.16.840.1.101.3.4.3.2": 8,
        "1.2.840.10045.4.1": 9, "1.2.840.10045.4.3.2": 10,
        "1.2.840.10045.4.3.3": 11, "1.2.840.10045.4.3.4": 12,
        "1.2.840.113549.1.1.10": 13, "1.3.101.112": 16,
    }
    sig_alg = sig_algs.get(cert.signature_algorithm_oid.dotted_string, 0)
    if sig_alg == 13:
        # the RSA-PSS OID (1.2.840.113549.1.1.10) is hash-agnostic; Go
        # distinguishes SHA256/384/512-RSAPSS (13/14/15) by the PSS
        # hash parameters (x509.go signatureAlgorithmDetails)
        try:
            hname = (cert.signature_hash_algorithm.name or "").lower()
        except Exception:
            hname = ""
        sig_alg = {"sha256": 13, "sha384": 14, "sha512": 15}.get(hname, 13)
    out = {
        "PublicKey": {"N": str(numbers.n), "E": numbers.e},
        "PublicKeyAlgorithm": 1,  # x509.RSA
        "SignatureAlgorithm": sig_alg,
        "Subject": _name(cert.subject),
    }
    if is_csr:
        out["Version"] = 0
        return out
    try:
        san = cert.extensions.get_extension_for_class(
            cx509.SubjectAlternativeName).value
        dns_names = san.get_values_for_type(cx509.DNSName)
        ip_addrs = [str(i) for i in san.get_values_for_type(cx509.IPAddress)]
        emails = san.get_values_for_type(cx509.RFC822Name)
        uris = san.get_values_for_type(cx509.UniformResourceIdentifier)
    except cx509.ExtensionNotFound:
        dns_names, ip_addrs, emails, uris = [], [], [], []
    try:
        bc = cert.extensions.get_extension_for_class(cx509.BasicConstraints)
        is_ca, bc_valid = bool(bc.value.ca), True
        max_path = bc.value.path_length if bc.value.path_length is not None else -1
    except cx509.ExtensionNotFound:
        is_ca, bc_valid, max_path = False, False, 0
    # Go x509.KeyUsage bitmask (DigitalSignature=1 ... DecipherOnly=256)
    key_usage = 0
    try:
        ku = cert.extensions.get_extension_for_class(cx509.KeyUsage).value
        for bit, flag in enumerate((
                ku.digital_signature, ku.content_commitment,
                ku.key_encipherment, ku.data_encipherment, ku.key_agreement,
                ku.key_cert_sign, ku.crl_sign)):
            if flag:
                key_usage |= 1 << bit
        if ku.key_agreement:
            if ku.encipher_only:
                key_usage |= 1 << 7
            if ku.decipher_only:
                key_usage |= 1 << 8
    except cx509.ExtensionNotFound:
        pass
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serial = cert.serial_number
    out.update({
        "Version": cert.version.value + 1,
        "SerialNumber": serial,
        "KeyUsage": key_usage,
        "Issuer": _name(cert.issuer),
        "NotBefore": cert.not_valid_before_utc.strftime("%Y-%m-%dT%H:%M:%SZ"),
        "NotAfter": cert.not_valid_after_utc.strftime("%Y-%m-%dT%H:%M:%SZ"),
        "IsCA": is_ca,
        "BasicConstraintsValid": bc_valid,
        "MaxPathLen": max_path,
        "MaxPathLenZero": max_path == 0,
        "DNSNames": dns_names,
        "EmailAddresses": emails,
        "IPAddresses": ip_addrs,
        "URIs": uris,
    })
    return out


def _fn_image_normalize(fn, args):
    """Normalize an image reference with docker.io defaulting rules
    (pkg/utils/image ImageInfo + default registry)."""
    ref = _require(fn, args[0], "string")
    if not ref:
        raise FunctionError("image_normalize: empty image reference")
    name = ref
    digest = ""
    if "@" in name:
        name, digest = name.split("@", 1)
    tag = ""
    # tag is after the last ':' only if that segment has no '/'
    idx = name.rfind(":")
    if idx != -1 and "/" not in name[idx:]:
        tag = name[idx + 1:]
        name = name[:idx]
    first = name.split("/", 1)[0]
    if "/" not in name:
        registry, path = "docker.io", "library/" + name
    elif "." in first or ":" in first or first == "localhost":
        registry, path = first, name.split("/", 1)[1]
    else:
        registry, path = "docker.io", name
    if registry == "docker.io" and "/" not in path:
        path = "library/" + path
    out = f"{registry}/{path}"
    if not tag and not digest:
        tag = "latest"
    if tag:
        out += f":{tag}"
    if digest:
        out += f"@{digest}"
    return out


def _fn_is_external_url(fn, args):
    from urllib.parse import urlparse

    s = _require(fn, args[0], "string")
    parsed = urlparse(s)
    host = parsed.hostname
    if host is None:
        raise FunctionError(f"is_external_url: no hostname in {s!r}")
    try:
        ip = ipaddress.ip_address(host)
        return not (ip.is_loopback or ip.is_private)
    except ValueError:
        pass
    if host == "localhost":
        return False
    import socket

    try:
        infos = socket.getaddrinfo(host, None)
    except OSError as e:
        raise FunctionError(f"is_external_url: lookup failed for {host!r}: {e}")
    for info in infos:
        ip = ipaddress.ip_address(info[4][0])
        if ip.is_loopback or ip.is_private:
            return False
    return True


def _fn_sha256(fn, args):
    return hashlib.sha256(_require(fn, args[0], "string").encode("utf-8")).hexdigest()


# time functions (time.go)


def _parse_rfc3339(fn, value) -> _dt.datetime:
    try:
        return gotime.parse_time(gotime.RFC3339, _require(fn, value, "string"))
    except ValueError as e:
        raise FunctionError(f"{fn}: {e}")


def _fn_time_since(fn, args):
    layout = _require(fn, args[0], "string")
    t1_str = _require(fn, args[1], "string")
    t2_str = _require(fn, args[2], "string")
    try:
        t1 = gotime.parse_time(layout or gotime.RFC3339, t1_str)
        t2 = (
            _dt.datetime.now(_dt.timezone.utc)
            if t2_str == ""
            else gotime.parse_time(layout or gotime.RFC3339, t2_str)
        )
    except ValueError as e:
        raise FunctionError(f"time_since: {e}")
    if t1.tzinfo is None:
        t1 = t1.replace(tzinfo=_dt.timezone.utc)
    if t2.tzinfo is None:
        t2 = t2.replace(tzinfo=_dt.timezone.utc)
    delta = t2 - t1
    return gotime.format_go_duration(int(delta.total_seconds() * 1e9))


def _fn_time_now(fn, args):
    return gotime.format_rfc3339(_dt.datetime.now().astimezone())


def _fn_time_now_utc(fn, args):
    return gotime.format_rfc3339(_dt.datetime.now(_dt.timezone.utc))


def _fn_time_add(fn, args):
    t = _parse_rfc3339(fn, args[0])
    d = parse_duration(_require(fn, args[1], "string"))
    if d is None:
        raise FunctionError(f"time_add: invalid duration {args[1]!r}")
    return gotime.format_rfc3339(t + _dt.timedelta(microseconds=d / 1000))


def _fn_time_parse(fn, args):
    layout = _require(fn, args[0], "string")
    value = _require(fn, args[1], "string")
    try:
        t = gotime.parse_time(layout, value)
    except ValueError as e:
        raise FunctionError(f"time_parse: {e}")
    return gotime.format_rfc3339(t)


def _fn_time_to_cron(fn, args):
    t = _parse_rfc3339(fn, args[0])
    return gotime.time_to_cron(t)


def _fn_time_utc(fn, args):
    t = _parse_rfc3339(fn, args[0])
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return gotime.format_rfc3339(t.astimezone(_dt.timezone.utc))


def _fn_time_diff(fn, args):
    t1 = _parse_rfc3339(fn, args[0])
    t2 = _parse_rfc3339(fn, args[1])
    delta = t2 - t1
    return gotime.format_go_duration(int(delta.total_seconds() * 1e9))


def _fn_time_before(fn, args):
    return _parse_rfc3339(fn, args[0]) < _parse_rfc3339(fn, args[1])


def _fn_time_after(fn, args):
    return _parse_rfc3339(fn, args[0]) > _parse_rfc3339(fn, args[1])


def _fn_time_between(fn, args):
    t = _parse_rfc3339(fn, args[0])
    start = _parse_rfc3339(fn, args[1])
    end = _parse_rfc3339(fn, args[2])
    return start < t < end


def _fn_time_truncate(fn, args):
    t = _parse_rfc3339(fn, args[0])
    d = parse_duration(_require(fn, args[1], "string"))
    if d is None or d <= 0:
        raise FunctionError(f"time_truncate: invalid duration {args[1]!r}")
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    ns = int(t.timestamp() * 1e9)
    truncated = ns - (ns % d)
    out = _dt.datetime.fromtimestamp(truncated / 1e9, tz=t.tzinfo)
    return gotime.format_rfc3339(out)


# ---------------------------------------------------------------------------
# dispatch table: name -> (min_arity, max_arity or None for variadic, impl)

FUNCTION_TABLE: Dict[str, tuple] = {
    # standard
    "abs": (1, 1, _fn_abs),
    "avg": (1, 1, _fn_avg),
    "ceil": (1, 1, _fn_ceil),
    "contains": (2, 2, _fn_contains),
    "ends_with": (2, 2, _fn_ends_with),
    "floor": (1, 1, _fn_floor),
    "join": (2, 2, _fn_join),
    "keys": (1, 1, _fn_keys),
    "length": (1, 1, _fn_length),
    "map": (2, 2, _fn_map),
    "max": (1, 1, _fn_max),
    "max_by": (2, 2, _fn_max_by),
    "merge": (1, None, _fn_merge),
    "min": (1, 1, _fn_min),
    "min_by": (2, 2, _fn_min_by),
    "not_null": (1, None, _fn_not_null),
    "reverse": (1, 1, _fn_reverse),
    "sort": (1, 1, _fn_sort),
    "sort_by": (2, 2, _fn_sort_by),
    "starts_with": (2, 2, _fn_starts_with),
    "to_array": (1, 1, _fn_to_array),
    "to_string": (1, 1, _fn_to_string),
    "to_number": (1, 1, _fn_to_number),
    "type": (1, 1, _fn_type),
    "values": (1, 1, _fn_values),
    # kyverno custom
    "compare": (2, 2, _fn_compare),
    "equal_fold": (2, 2, _fn_equal_fold),
    "replace": (4, 4, _fn_replace),
    "replace_all": (3, 3, _fn_replace_all),
    "to_upper": (1, 1, _fn_to_upper),
    "to_lower": (1, 1, _fn_to_lower),
    "trim": (2, 2, _fn_trim),
    "trim_prefix": (2, 2, _fn_trim_prefix),
    "split": (2, 2, _fn_split),
    "regex_replace_all": (3, 3, _fn_regex_replace_all),
    "regex_replace_all_literal": (3, 3, _fn_regex_replace_all_literal),
    "regex_match": (2, 2, _fn_regex_match),
    "pattern_match": (2, 2, _fn_pattern_match),
    "label_match": (2, 2, _fn_label_match),
    "to_boolean": (1, 1, _fn_to_boolean),
    "add": (2, 2, _fn_add),
    "sum": (1, 1, _fn_sum),
    "subtract": (2, 2, _fn_subtract),
    "multiply": (2, 2, _fn_multiply),
    "divide": (2, 2, _fn_divide),
    "modulo": (2, 2, _fn_modulo),
    "round": (2, 2, _fn_round),
    "base64_decode": (1, 1, _fn_base64_decode),
    "base64_encode": (1, 1, _fn_base64_encode),
    "path_canonicalize": (1, 1, _fn_path_canonicalize),
    "truncate": (2, 2, _fn_truncate),
    "semver_compare": (2, 2, _fn_semver_compare),
    "parse_json": (1, 1, _fn_parse_json),
    "parse_yaml": (1, 1, _fn_parse_yaml),
    "lookup": (2, 2, _fn_lookup),
    "items": (3, 3, _fn_items),
    "object_from_lists": (2, 2, _fn_object_from_lists),
    "random": (1, 1, _fn_random),
    "x509_decode": (1, 1, _fn_x509_decode),
    "image_normalize": (1, 1, _fn_image_normalize),
    "is_external_url": (1, 1, _fn_is_external_url),
    "sha256": (1, 1, _fn_sha256),
    # time
    "time_since": (3, 3, _fn_time_since),
    "time_now": (0, 0, _fn_time_now),
    "time_now_utc": (0, 0, _fn_time_now_utc),
    "time_add": (2, 2, _fn_time_add),
    "time_parse": (2, 2, _fn_time_parse),
    "time_to_cron": (1, 1, _fn_time_to_cron),
    "time_utc": (1, 1, _fn_time_utc),
    "time_diff": (2, 2, _fn_time_diff),
    "time_before": (2, 2, _fn_time_before),
    "time_after": (2, 2, _fn_time_after),
    "time_between": (3, 3, _fn_time_between),
    "time_truncate": (2, 2, _fn_time_truncate),
}


def call_function(name: str, args: List[Any]):
    min_arity, max_arity, impl = FUNCTION_TABLE[name]
    if len(args) < min_arity or (max_arity is not None and len(args) > max_arity):
        expected = str(min_arity) if max_arity == min_arity else f"{min_arity}+"
        raise ArityError(name, expected, len(args))
    return impl(name, args)
