# Copied verbatim from kyverno_tpu/cel/lexer.py.
"""CEL lexer (cel-spec syntax.md grammar, the subset Kubernetes
ValidatingAdmissionPolicy / kyverno validate.cel expressions use).

Tokens: identifiers, int/uint/double literals (decimal + hex), string
and bytes literals (quote styles, raw strings, escapes), operators and
punctuation, reserved keywords. The reference evaluates CEL through
cel-go (pkg/engine/handlers/validation/validate_cel.go:34); this is an
independent host-side implementation."""

from __future__ import annotations

from typing import Any, List, NamedTuple

from .errors import CelSyntaxError

RESERVED = {
    "as", "break", "const", "continue", "else", "for", "function", "if",
    "import", "let", "loop", "package", "namespace", "return", "var",
    "void", "while",
}

KEYWORDS = {"true", "false", "null", "in"}

_PUNCT = [
    "&&", "||", "<=", ">=", "==", "!=", "(", ")", "[", "]", "{", "}",
    ",", ".", "?", ":", "<", ">", "+", "-", "*", "/", "%", "!", "=",
]

_ESCAPES = {
    "a": "\a", "b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t",
    "v": "\v", "\\": "\\", "'": "'", '"': '"', "`": "`", "?": "?",
}


class Token(NamedTuple):
    kind: str   # IDENT INT UINT DOUBLE STRING BYTES PUNCT BOOL NULL IN EOF
    value: Any
    pos: int


def _is_ident_start(c: str) -> bool:
    return c.isalpha() or c == "_"


def _is_ident(c: str) -> bool:
    return c.isalnum() or c == "_"


def tokenize(src: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in " \t\r\n":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            while i < n and src[i] != "\n":
                i += 1
            continue
        start = i
        # string / bytes literals (with r/b prefixes in any order)
        j = i
        raw = False
        is_bytes = False
        while j < n and src[j] in "rRbB":
            if src[j] in "rR":
                raw = True
            else:
                is_bytes = True
            j += 1
        if j < n and src[j] in "'\"" and j - i <= 2 and (j == i or raw or is_bytes):
            s, i = _string(src, j, raw)
            if is_bytes:
                out.append(Token("BYTES", s.encode("utf-8") if isinstance(s, str) else s, start))
            else:
                out.append(Token("STRING", s, start))
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            tok, i = _number(src, i)
            out.append(tok)
            continue
        if _is_ident_start(c):
            j = i
            while j < n and _is_ident(src[j]):
                j += 1
            word = src[i:j]
            i = j
            if word == "true":
                out.append(Token("BOOL", True, start))
            elif word == "false":
                out.append(Token("BOOL", False, start))
            elif word == "null":
                out.append(Token("NULL", None, start))
            elif word == "in":
                out.append(Token("IN", "in", start))
            else:
                # reserved words lex as IDENT: they are legal as field
                # names (request.namespace) and map keys; the parser
                # rejects them as bare identifiers (cel-go behavior)
                out.append(Token("IDENT", word, start))
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                out.append(Token("PUNCT", p, start))
                i += len(p)
                break
        else:
            raise CelSyntaxError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", None, n))
    return out


def _number(src: str, i: int):
    n = len(src)
    start = i
    if src.startswith("0x", i) or src.startswith("0X", i):
        j = i + 2
        while j < n and src[j] in "0123456789abcdefABCDEF":
            j += 1
        if j == i + 2:
            raise CelSyntaxError(f"malformed hex literal at {i}")
        if j < n and src[j] in "uU":
            return Token("UINT", int(src[i + 2:j], 16), start), j + 1
        return Token("INT", int(src[i + 2:j], 16), start), j
    j = i
    is_double = False
    while j < n and src[j].isdigit():
        j += 1
    if j < n and src[j] == "." and j + 1 < n and src[j + 1].isdigit():
        is_double = True
        j += 1
        while j < n and src[j].isdigit():
            j += 1
    if j < n and src[j] in "eE":
        k = j + 1
        if k < n and src[k] in "+-":
            k += 1
        if k < n and src[k].isdigit():
            is_double = True
            j = k
            while j < n and src[j].isdigit():
                j += 1
    text = src[i:j]
    if is_double:
        return Token("DOUBLE", float(text), start), j
    if j < n and src[j] in "uU":
        return Token("UINT", int(text), start), j + 1
    return Token("INT", int(text), start), j


def _esc_chr(src: str, i: int, width: int, base: int) -> str:
    text = src[i:i + width]
    try:
        code = int(text, base)
        return chr(code)
    except (ValueError, OverflowError):
        raise CelSyntaxError(f"bad escape sequence {text!r}")


def _string(src: str, i: int, raw: bool):
    n = len(src)
    q = src[i]
    triple = src.startswith(q * 3, i)
    term = q * 3 if triple else q
    i += len(term)
    buf = []
    while i < n:
        if src.startswith(term, i):
            return "".join(buf), i + len(term)
        c = src[i]
        if not triple and c == "\n":
            raise CelSyntaxError("newline in string literal")
        if c == "\\" and not raw:
            i += 1
            if i >= n:
                break
            e = src[i]
            if e in _ESCAPES:
                buf.append(_ESCAPES[e])
                i += 1
            elif e == "x":
                buf.append(_esc_chr(src, i + 1, 2, 16))
                i += 3
            elif e == "u":
                buf.append(_esc_chr(src, i + 1, 4, 16))
                i += 5
            elif e == "U":
                buf.append(_esc_chr(src, i + 1, 8, 16))
                i += 9
            elif e.isdigit():
                buf.append(_esc_chr(src, i, 3, 8))
                i += 3
            else:
                raise CelSyntaxError(f"bad escape \\{e}")
        else:
            buf.append(c)
            i += 1
    raise CelSyntaxError("unterminated string literal")
