# Copied verbatim from kyverno_tpu/cel/re2.py.
"""Linear-time RE2-subset regex engine for CEL ``matches()``.

cel-go's matches() is RE2 (pkg/cel in the reference links cel-go, which
compiles to RE2): no backreferences, no lookaround, ASCII Perl classes,
``$`` is end-of-text, and matching is guaranteed linear in the subject.
Python's ``re`` is a backtracking engine with different syntax corners
(backrefs accepted, ``\\d`` is Unicode, ``$`` matches before a trailing
newline) — and a catastrophic pattern can hold the GIL past the webhook
timeout, wedging every admission request in the process.

So matches() runs on this engine instead: a classic Thompson NFA
simulation (parse -> epsilon-NFA -> set-of-states walk). Worst case
O(len(subject) * states). Unsupported RE2 constructs raise Re2Error,
surfacing as per-expression CEL errors, never as a hang.

Supported: literals, ``.``, ``[...]`` classes (ranges, negation,
escapes, POSIX ``[[:alpha:]]``), ASCII ``\\d \\D \\w \\W \\s \\S``,
escapes (``\\n \\t \\x41 \\x{1F600}`` etc.), anchors ``^ $ \\b \\B
\\A \\z``, groups (capturing/non-capturing/named — equivalent for the
boolean verdict), alternation, quantifiers ``* + ? {m} {m,} {m,n}``
(greedy or lazy — same boolean result), inline flags ``(?i) (?s) (?m)``
and flagged groups ``(?i:...)``.

Rejected (RE2 rejects them too): backreferences, lookaround,
conditionals, possessive quantifiers, ``\\p{...}`` unicode classes
(RE2 supports these last; this engine raises rather than mis-match).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

MAX_REPEAT = 1000       # RE2's repetition bound
MAX_STATES = 20000      # program-size guard (RE2: max program size)


class Re2Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# character predicates: sorted disjoint (lo, hi) codepoint ranges

_D = ((48, 57),)
_W = ((48, 57), (65, 90), (95, 95), (97, 122))
_S = ((9, 13), (32, 32))
_POSIX = {
    "alnum": ((48, 57), (65, 90), (97, 122)),
    "alpha": ((65, 90), (97, 122)),
    "ascii": ((0, 127),),
    "blank": ((9, 9), (32, 32)),
    "cntrl": ((0, 31), (127, 127)),
    "digit": _D,
    "graph": ((33, 126),),
    "lower": ((97, 122),),
    "print": ((32, 126),),
    "punct": ((33, 47), (58, 64), (91, 96), (123, 126)),
    "space": _S,
    "upper": ((65, 90),),
    "word": _W,
    "xdigit": ((48, 57), (65, 70), (97, 102)),
}

_ESC_LITERAL = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v", "a": "\a"}


class CharSet:
    __slots__ = ("ranges", "negated", "ci")

    def __init__(self, ranges, negated=False, ci=False):
        self.ranges = tuple(ranges)
        self.negated = negated
        self.ci = ci

    def matches(self, ch: str) -> bool:
        if self.ci:
            # RE2 uses simple case-folding ORBITS, which can take two
            # steps to land in a class range: 'ſ' (U+017F) folds via
            # 'S' to 's', so (?i)[a-z] must match it. Close over
            # lower/upper twice; multi-char folds ('ß'.upper() == 'SS')
            # cannot equal a single class codepoint and are skipped.
            cands = {ch}
            frontier = {ch}
            for _ in range(2):
                nxt = set()
                for c in frontier:
                    for f in (c.lower(), c.upper()):
                        if len(f) == 1 and f not in cands:
                            cands.add(f)
                            nxt.add(f)
                frontier = nxt
            hit = any(self._in(c) for c in cands)
        else:
            hit = self._in(ch)
        return hit != self.negated

    def _in(self, ch: str) -> bool:
        c = ord(ch)
        for lo, hi in self.ranges:
            if lo <= c <= hi:
                return True
        return False


ANY_NO_NL = CharSet(((0, 9), (11, 0x10FFFF)))       # . default
ANY = CharSet(((0, 0x10FFFF),))                      # . under (?s)
WORD = CharSet(_W)

# ---------------------------------------------------------------------------
# AST

LIT, CAT, ALT, STAR, PLUS, OPT, REP, GRP, ASSERT = range(9)
# assertions
A_BOL, A_EOL, A_BOT, A_EOT, A_WB, A_NWB = range(6)


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.n = len(src)
        # flags: i (case-insensitive), s (dotall), m (multiline)
        self.flags = {"i": False, "s": False, "m": False}

    def error(self, msg: str):
        raise Re2Error(f"{msg} (at {self.i} in {self.src!r})")

    def peek(self) -> str:
        return self.src[self.i] if self.i < self.n else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    # -- grammar: alt -> cat ('|' cat)* ; cat -> rep* ; rep -> atom quant?

    def parse(self):
        node = self.alt()
        if self.i < self.n:
            self.error(f"unexpected {self.peek()!r}")
        return node

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else (ALT, branches)

    def cat(self):
        items = []
        while self.i < self.n and self.peek() not in "|)":
            items.append(self.rep())
        if not items:
            return (CAT, [])
        return items[0] if len(items) == 1 else (CAT, items)

    def rep(self):
        atom = self.atom()
        c = self.peek()
        if c == "*":
            self.take()
            atom = (STAR, atom)
        elif c == "+":
            self.take()
            atom = (PLUS, atom)
        elif c == "?":
            self.take()
            atom = (OPT, atom)
        elif c == "{":
            save = self.i
            rng = self._try_counted()
            if rng is None:
                self.i = save
                return atom  # literal '{' parses as the next atom
            atom = (REP, atom, rng[0], rng[1])
        else:
            return atom
        # lazy suffix is irrelevant for the boolean verdict
        if self.peek() == "?":
            self.take()
        # RE2 rejects stacked repetition operators (a**, a*+, a{2}{3})
        if self.peek() and self.peek() in "*+?":
            self.error("bad repetition operator")
        if self.peek() == "{":
            save = self.i
            if self._try_counted() is not None:
                self.error("bad repetition operator")
            self.i = save
        return atom

    def _try_counted(self) -> Optional[Tuple[int, int]]:
        assert self.take() == "{"
        lo_s = self._digits()
        if lo_s == "":
            return None  # RE2: '{,n}' and bare '{' are literals
        hi: Optional[int]
        if self.peek() == ",":
            self.take()
            hi_s = self._digits()
            hi = int(hi_s) if hi_s else -1
        else:
            hi = int(lo_s) if lo_s else 0
        if self.peek() != "}":
            return None
        self.take()
        lo = int(lo_s) if lo_s else 0
        if lo > MAX_REPEAT or (hi is not None and hi > MAX_REPEAT):
            self.error(f"repetition bound over {MAX_REPEAT}")
        if hi != -1 and hi < lo:
            self.error("invalid repetition range")
        return (lo, hi if hi is not None else -1)

    def _digits(self) -> str:
        out = ""
        while self.peek().isdigit():
            out += self.take()
        return out

    def atom(self):
        c = self.peek()
        if c == "(":
            return self.group()
        if c == "[":
            return (LIT, self.char_class())
        if c == ".":
            self.take()
            return (LIT, ANY if self.flags["s"] else ANY_NO_NL)
        if c == "^":
            self.take()
            return (ASSERT, A_BOL if self.flags["m"] else A_BOT)
        if c == "$":
            self.take()
            return (ASSERT, A_EOL if self.flags["m"] else A_EOT)
        if c == "\\":
            return self.escape()
        if c in "*+?":
            self.error(f"nothing to repeat: {c!r}")
        self.take()
        return (LIT, self._literal(c))

    def _literal(self, ch: str) -> CharSet:
        o = ord(ch)
        return CharSet(((o, o),), ci=self.flags["i"])

    def group(self):
        assert self.take() == "("
        saved = dict(self.flags)
        if self.peek() == "?":
            self.take()
            c = self.peek()
            if c == ":":
                self.take()
            elif c == "P":
                self.take()
                if self.peek() == "<":  # (?P<name>...)
                    while self.peek() not in (">", ""):
                        self.take()
                    if self.take() != ">":
                        self.error("unterminated group name")
                else:
                    self.error("(?P=...) backreferences are not RE2")
            elif c == "<":
                self.take()
                if self.peek() and self.peek() in "=!":
                    self.error("lookbehind is not RE2")
                while self.peek() not in (">", ""):  # (?<name>...)
                    self.take()
                if self.take() != ">":
                    self.error("unterminated group name")
            elif c in "=!":
                self.error("lookaround is not RE2")
            elif c == "(":
                self.error("conditionals are not RE2")
            else:
                # inline flags: (?ims) or (?ims:...)
                neg = False
                while self.peek() and self.peek() in "ims-U":
                    f = self.take()
                    if f == "-":
                        neg = True
                    elif f == "U":
                        pass  # ungreedy: irrelevant for boolean match
                    else:
                        self.flags[f] = not neg
                if self.peek() == ":":
                    self.take()
                elif self.peek() == ")":
                    self.take()
                    # flags apply to the remainder of the enclosing group
                    return (CAT, [])
                else:
                    self.error("bad inline flags")
        node = self.alt()
        if self.take() != ")":
            self.error("unbalanced parenthesis")
        inner_flags = dict(self.flags)
        self.flags = saved
        # (?i:...) scopes flags to the group: node already parsed under
        # inner_flags, nothing else to do
        del inner_flags
        return (GRP, node)

    def escape(self):
        assert self.take() == "\\"
        c = self.take()
        if c == "":
            self.error("trailing backslash")
        if c.isdigit():
            if c == "0":  # octal escape \0oo
                val = 0
                for _ in range(2):
                    if self.peek() and self.peek() in "01234567":
                        val = val * 8 + int(self.take())
                return (LIT, CharSet(((val, val),), ci=self.flags["i"]))
            self.error("backreferences are not RE2")
        if c in _ESC_LITERAL:
            o = ord(_ESC_LITERAL[c])
            return (LIT, CharSet(((o, o),)))
        if c == "x":
            if self.peek() == "{":
                self.take()
                hexs = ""
                while self.peek() not in ("}", ""):
                    hexs += self.take()
                if self.take() != "}" or not hexs:
                    self.error("bad \\x{...}")
            else:
                hexs = self.take() + self.take()
            try:
                val = int(hexs, 16)
            except ValueError:
                self.error("bad hex escape")
            return (LIT, CharSet(((val, val),), ci=self.flags["i"]))
        if c == "d":
            return (LIT, CharSet(_D))
        if c == "D":
            return (LIT, CharSet(_D, negated=True))
        if c == "w":
            return (LIT, CharSet(_W))
        if c == "W":
            return (LIT, CharSet(_W, negated=True))
        if c == "s":
            return (LIT, CharSet(_S))
        if c == "S":
            return (LIT, CharSet(_S, negated=True))
        if c == "b":
            return (ASSERT, A_WB)
        if c == "B":
            return (ASSERT, A_NWB)
        if c == "A":
            return (ASSERT, A_BOT)
        if c == "z":
            return (ASSERT, A_EOT)
        if c in ("p", "P"):
            self.error("\\p unicode classes are not supported here")
        if c.isalpha():
            self.error(f"unknown escape \\{c}")
        o = ord(c)
        return (LIT, CharSet(((o, o),), ci=self.flags["i"]))

    def char_class(self) -> CharSet:
        assert self.take() == "["
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = self.peek()
            if c == "":
                self.error("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "[" and self.src.startswith("[:", self.i):
                end = self.src.find(":]", self.i + 2)
                if end < 0:
                    self.error("unterminated POSIX class")
                name = self.src[self.i + 2:end]
                neg = name.startswith("^")
                if neg:
                    name = name[1:]
                base = _POSIX.get(name)
                if base is None:
                    self.error(f"unknown POSIX class [:{name}:]")
                if neg:
                    ranges.extend(_negate(base))
                else:
                    ranges.extend(base)
                self.i = end + 2
                continue
            # perl classes inside [...] contribute their ranges directly
            if c == "\\" and self.i + 1 < self.n and self.src[self.i + 1] in "dDwWsS":
                self.take()
                e = self.take()
                base = {"d": _D, "w": _W, "s": _S}[e.lower()]
                ranges.extend(_negate(base) if e.isupper() else base)
                continue
            lo = self._class_atom()
            if (self.peek() == "-" and self.i + 1 < self.n
                    and self.src[self.i + 1] != "]"):
                self.take()
                if (self.peek() == "\\" and self.i + 1 < self.n
                        and self.src[self.i + 1] in "dDwWsS"):
                    self.error("invalid class range")
                hi = self._class_atom()
                if hi < lo:
                    self.error("invalid class range")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        if not ranges:
            self.error("empty character class")
        return CharSet(tuple(ranges), negated=negated, ci=self.flags["i"])

    def _class_atom(self) -> int:
        """One class member codepoint (perl classes are handled by the
        caller before this runs)."""
        c = self.take()
        if c != "\\":
            return ord(c)
        e = self.take()
        if e == "":
            self.error("trailing backslash in class")
        if e in _ESC_LITERAL:
            return ord(_ESC_LITERAL[e])
        if e == "x":
            if self.peek() == "{":
                self.take()
                hexs = ""
                while self.peek() not in ("}", ""):
                    hexs += self.take()
                if self.take() != "}" or not hexs:
                    self.error("bad \\x{...}")
            else:
                hexs = self.take() + self.take()
            try:
                return int(hexs, 16)
            except ValueError:
                self.error("bad hex escape")
        if e in ("p", "P"):
            self.error("\\p unicode classes are not supported here")
        if e.isalpha():
            self.error(f"unknown escape \\{e} in class")
        return ord(e)


def _negate(ranges) -> List[Tuple[int, int]]:
    out = []
    prev = 0
    for lo, hi in sorted(ranges):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = hi + 1
    if prev <= 0x10FFFF:
        out.append((prev, 0x10FFFF))
    return out


# ---------------------------------------------------------------------------
# NFA compile: states are dicts {char: CharSet|None, assert: kind|None,
# eps: [targets]} — Thompson construction over the AST


class _NFA:
    def __init__(self):
        self.chars: List[Optional[CharSet]] = []
        self.asserts: List[Optional[int]] = []
        self.eps: List[List[int]] = []

    def state(self, char=None, assertion=None) -> int:
        if len(self.chars) >= MAX_STATES:
            raise Re2Error("regex program too large")
        self.chars.append(char)
        self.asserts.append(assertion)
        self.eps.append([])
        return len(self.chars) - 1


def _compile(nfa: _NFA, node, accept: int) -> int:
    """Compile ``node`` so that reaching ``accept`` means it matched;
    returns the fragment's start state."""
    kind = node[0]
    if kind == LIT:
        s = nfa.state(char=node[1])
        nfa.eps[s] = [accept]  # char transition targets via eps list
        return s
    if kind == ASSERT:
        s = nfa.state(assertion=node[1])
        nfa.eps[s] = [accept]
        return s
    if kind == GRP:
        return _compile(nfa, node[1], accept)
    if kind == CAT:
        items = node[1]
        nxt = accept
        for item in reversed(items):
            nxt = _compile(nfa, item, nxt)
        return nxt
    if kind == ALT:
        s = nfa.state()
        nfa.eps[s] = [_compile(nfa, b, accept) for b in node[1]]
        return s
    if kind == OPT:
        s = nfa.state()
        frag = _compile(nfa, node[1], accept)
        nfa.eps[s] = [frag, accept]
        return s
    if kind == STAR:
        s = nfa.state()
        frag = _compile(nfa, node[1], s)
        nfa.eps[s] = [frag, accept]
        return s
    if kind == PLUS:
        s = nfa.state()
        frag = _compile(nfa, node[1], s)
        nfa.eps[s] = [frag, accept]
        return frag
    if kind == REP:
        _, sub, lo, hi = node
        if hi == -1:  # {lo,}
            tail = _compile(nfa, (STAR, sub), accept)
        else:
            tail = accept
            for _ in range(hi - lo):
                tail = _compile(nfa, (OPT, sub), tail)
        for _ in range(lo):
            tail = _compile(nfa, sub, tail)
        return tail
    raise Re2Error("internal: unknown node")  # pragma: no cover


class Re2:
    """Compiled pattern; ``search`` is the RE2 boolean 'partial match'."""

    def __init__(self, pattern: str):
        parser = _Parser(pattern)
        ast = parser.parse()
        self.nfa = _NFA()
        self.accept = self.nfa.state()
        self.start = _compile(self.nfa, ast, self.accept)

    # -- simulation

    def _closure(self, states, text: str, pos: int, out: set) -> bool:
        """Epsilon/assertion closure; returns True if accept reached."""
        nfa = self.nfa
        stack = list(states)
        hit = False
        seen = set()
        while stack:
            s = stack.pop()
            if s in seen:
                continue
            seen.add(s)
            if s == self.accept:
                hit = True
                continue
            if nfa.chars[s] is not None:
                out.add(s)
                continue
            a = nfa.asserts[s]
            if a is not None and not _assert_ok(a, text, pos):
                continue
            stack.extend(nfa.eps[s])
        return hit

    def search(self, text: str) -> bool:
        nfa = self.nfa
        current: set = set()
        if self._closure([self.start], text, 0, current):
            return True
        for pos, ch in enumerate(text):
            nxt: List[int] = []
            for s in current:
                cs = nfa.chars[s]
                if cs is not None and cs.matches(ch):
                    nxt.extend(nfa.eps[s])
            new: set = set()
            # unanchored search: re-seed the start state at pos+1
            if self._closure(nxt + [self.start], text, pos + 1, new):
                return True
            current = new
        return False


def _assert_ok(kind: int, text: str, pos: int) -> bool:
    n = len(text)
    if kind == A_BOT:
        return pos == 0
    if kind == A_EOT:
        return pos == n
    if kind == A_BOL:
        return pos == 0 or text[pos - 1] == "\n"
    if kind == A_EOL:
        return pos == n or text[pos] == "\n"
    before = pos > 0 and WORD.matches(text[pos - 1])
    after = pos < n and WORD.matches(text[pos])
    if kind == A_WB:
        return before != after
    return before == after  # A_NWB


_CACHE: dict = {}
_CACHE_CAP = 512


def search(pattern: str, text: str) -> bool:
    """RE2 partial-match semantics, linear time, compiled-pattern LRU."""
    prog = _CACHE.get(pattern)
    if prog is None:
        prog = Re2(pattern)
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        _CACHE[pattern] = prog
    return prog.search(text)
