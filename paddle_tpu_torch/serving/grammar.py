"""Constrained decoding: JSON-schema / EBNF grammars compiled to
token-level DFAs + the budgeted device cache that serves them.

Structured output — tool calls, JSON APIs — is a workload class, not a
sampling trick: a production engine must GUARANTEE that a constrained
stream parses, at serving throughput, in the same fixed-shape compiled
batch that free streams ride. The enabling invariant is the same one
LoRA and the quantized page tier ride: per-row state
as jit *data*. Host-side, a schema compiles once into a small DFA over
the serving vocabulary; device-side, the DFA's per-state packed
allow-bitmask lives in a **grammar bank** indexed by a per-row
``(slot, state)`` id vector, and the decode program masks logits with
that row before its argmax. Admission/eviction of grammars never
recompiles anything — the serving_grammar gate counts exactly this.

Three pieces:

- the **compiler**: ``compile_schema`` (a practical JSON-schema
  subset: object/string/integer/boolean/null/enum/array) and
  ``compile_grammar`` (a regular EBNF-ish subset: literals, classes,
  ``| ( ) * + ? {m,n}``, non-recursive rule references) both lower to
  one regex AST -> Thompson NFA -> subset-construction char DFA ->
  token-level lift over a ``TokenVocab`` (a token is allowed in a
  state iff its whole surface walks the char DFA; multi-char surfaces
  advance multiple char states in one token step);
- ``GrammarStore`` — the host-resident registry of named schema
  sources, the ``AdapterStore`` shape;
- ``GrammarCache`` — the budgeted device residency manager, the
  FOURTH instance of the pool/adapter/host-arena census discipline:
  ``resident + evictable + free == n_slots - 1`` at all times, slot 0
  reserved for the all-allow identity (free rows decode through flat
  id 0 and their math is exactly the base model's), LRU retention at
  zero pins, pin-while-in-flight, atomic ``MemoryError`` refusal.
  A miss pays one priced ``grammar_compile`` on the engine clock;
  N requests sharing a schema compile it once.

State numbering inside one compiled automaton: state 0 is the
reserved all-allow self-loop (every slot's block row 0 — the identity
rows free requests index), the DFA proper starts at state 1. A row's
flat bank id is ``slot * max_states + state``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import ledger as obs_ledger

# the character set a bounded {"type": "string"} draws from: JSON-safe
# without escapes, so the emitted text needs no backslash states
STRING_CHARS = ("abcdefghijklmnopqrstuvwxyz"
                "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 _-")


# ---------------------------------------------------------------------------
# token vocabulary
# ---------------------------------------------------------------------------
class TokenVocab:
    """Token id -> surface string, the lift from char DFA to token
    DFA. Token 0 is the reserved pad (empty surface, never allowed by
    any grammar); ids without a surface are non-textual (never
    allowed). ``ascii_default`` is the serving convention both the
    sim and the llama test models use: ids 1..95 are the printable
    ASCII chars ``chr(0x20 + id - 1)``, the rest of the vocabulary is
    non-textual filler."""

    def __init__(self, surfaces: Dict[int, str], vocab_size: int):
        if vocab_size < 2:
            raise ValueError("vocab_size must be >= 2")
        self.vocab_size = int(vocab_size)
        self._sur: Dict[int, str] = {}
        for tid, s in surfaces.items():
            t = int(tid)
            if not 0 < t < vocab_size:
                raise ValueError(f"token id {t} outside 1..{vocab_size - 1}"
                                 " (0 is the reserved pad)")
            if not s:
                raise ValueError(f"token {t}: empty surface")
            self._sur[t] = str(s)

    @classmethod
    def ascii_default(cls, vocab_size: int) -> "TokenVocab":
        if vocab_size < 97:
            raise ValueError(
                f"ascii_default needs vocab_size >= 97 (95 printable "
                f"chars + pad), got {vocab_size}")
        return cls({i: chr(0x20 + i - 1) for i in range(1, 96)},
                   vocab_size)

    def surface(self, token: int) -> Optional[str]:
        return self._sur.get(int(token))

    def encode(self, text: str) -> List[int]:
        """Greedy single-char encode (exact for ascii_default)."""
        rev = {s: t for t, s in self._sur.items() if len(s) == 1}
        try:
            return [rev[ch] for ch in text]
        except KeyError as e:
            raise ValueError(f"no token for char {e.args[0]!r}") from e

    def decode(self, tokens) -> str:
        """Host-side detokenization for the parse gates; non-textual
        ids render as nothing (they never appear in a constrained
        stream — the masks forbid them)."""
        return "".join(self._sur.get(int(t), "") for t in tokens)

    def items(self):
        return self._sur.items()


# ---------------------------------------------------------------------------
# regex AST -> NFA -> DFA
# ---------------------------------------------------------------------------
# AST nodes are plain tuples: ("lit", ch) / ("class", frozenset) /
# ("seq", [..]) / ("alt", [..]) / ("star", n) / ("opt", n) /
# ("plus", n) / ("rep", n, lo, hi)
def _lit_seq(text: str):
    return ("seq", [("lit", ch) for ch in text])


class _NFA:
    def __init__(self):
        self.trans: List[Dict[str, set]] = []
        self.eps: List[set] = []

    def new(self) -> int:
        self.trans.append({})
        self.eps.append(set())
        return len(self.trans) - 1

    def add(self, a: int, ch: str, b: int):
        self.trans[a].setdefault(ch, set()).add(b)

    def build(self, node) -> Tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            a, b = self.new(), self.new()
            self.add(a, node[1], b)
            return a, b
        if kind == "class":
            a, b = self.new(), self.new()
            for ch in node[1]:
                self.add(a, ch, b)
            return a, b
        if kind == "seq":
            a = b = self.new()
            for sub in node[1]:
                s, e = self.build(sub)
                self.eps[b].add(s)
                b = e
            return a, b
        if kind == "alt":
            a, b = self.new(), self.new()
            for sub in node[1]:
                s, e = self.build(sub)
                self.eps[a].add(s)
                self.eps[e].add(b)
            return a, b
        if kind == "star":
            a, b = self.new(), self.new()
            s, e = self.build(node[1])
            self.eps[a].update((s, b))
            self.eps[e].update((s, b))
            return a, b
        if kind == "plus":
            return self.build(("seq", [node[1], ("star", node[1])]))
        if kind == "opt":
            a, b = self.new(), self.new()
            s, e = self.build(node[1])
            self.eps[a].update((s, b))
            self.eps[e].add(b)
            return a, b
        if kind == "rep":
            _, sub, lo, hi = node
            if not 0 <= lo <= hi:
                raise ValueError(f"bad repeat bounds {{{lo},{hi}}}")
            parts = [sub] * lo + [("opt", sub)] * (hi - lo)
            return self.build(("seq", parts))
        raise ValueError(f"unknown AST node {kind!r}")

    def closure(self, states: set) -> frozenset:
        out, todo = set(states), list(states)
        while todo:
            for nxt in self.eps[todo.pop()]:
                if nxt not in out:
                    out.add(nxt)
                    todo.append(nxt)
        return frozenset(out)


def _ast_to_char_dfa(ast):
    """-> (char transition list [state -> {ch: state}], accepting set,
    start=0). Dead states never materialize (subset construction only
    creates reachable non-empty sets)."""
    nfa = _NFA()
    s0, s1 = nfa.build(ast)
    start = nfa.closure({s0})
    ids = {start: 0}
    trans: List[Dict[str, int]] = [{}]
    todo = [start]
    while todo:
        cur = todo.pop()
        i = ids[cur]
        chars = sorted({ch for s in cur for ch in nfa.trans[s]})
        for ch in chars:
            nset = nfa.closure(
                {t for s in cur for t in nfa.trans[s].get(ch, ())})
            if nset not in ids:
                ids[nset] = len(trans)
                trans.append({})
                todo.append(nset)
            trans[i][ch] = ids[nset]
    accepting = {i for st, i in ids.items() if s1 in st}
    return trans, accepting


# ---------------------------------------------------------------------------
# the compiled artifact
# ---------------------------------------------------------------------------
def pack_masks(allow: np.ndarray) -> np.ndarray:
    """(S, V) bool -> (S, ceil(V/32)) uint32; token v lives at word
    v//32, bit v%32 — the exact unpack the decode program runs."""
    S, V = allow.shape
    words = (V + 31) // 32
    pad = np.zeros((S, words * 32), bool)
    pad[:, :V] = allow
    bits = pad.reshape(S, words, 32).astype(np.uint64)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits * weights[None, None, :]).sum(-1).astype(np.uint32)


def unpack_row(row: np.ndarray, vocab_size: int) -> np.ndarray:
    """One packed (words,) uint32 row -> (V,) bool allow vector (the
    sim's host-side twin of the in-jit unpack)."""
    idx = np.arange(vocab_size)
    return ((row[idx // 32] >> (idx % 32).astype(np.uint32)) & 1) \
        .astype(bool)


@dataclasses.dataclass
class CompiledGrammar:
    """One schema's token-level automaton. ``masks`` row 0 / ``trans``
    row 0 are the reserved all-allow self-loop; the DFA proper is
    states ``1..n_states-1`` with ``start`` = 1. ``trans[s, t] == -1``
    means token ``t`` is not allowed in state ``s`` (its mask bit is
    0 too — the two encodings can never disagree: both derive from
    one walk)."""

    source: object                     # the schema dict / EBNF text
    vocab_size: int
    n_states: int                      # INCLUDING reserved state 0
    start: int
    masks: np.ndarray                  # (n_states, words) uint32
    trans: np.ndarray                  # (n_states, vocab) int32
    accepting: np.ndarray              # (n_states,) bool
    allow_counts: np.ndarray           # (n_states,) int64
    min_tokens: int
    max_tokens: Optional[int]          # None: cyclic (unbounded)

    def step(self, state: int, token: int) -> int:
        nxt = int(self.trans[int(state), int(token)])
        if nxt < 0:
            raise ValueError(
                f"token {token} not allowed in state {state} — the "
                "emitted token escaped its own mask (engine bug)")
        return nxt

    def allows(self, state: int, token: int) -> bool:
        return int(self.trans[int(state), int(token)]) >= 0

    def accepts_at(self, state: int) -> bool:
        return bool(self.accepting[int(state)])

    def masked_frac(self, state: int) -> float:
        """Fraction of the vocabulary this state's mask FORBIDS — the
        per-emission sample behind ``tokens_masked_frac``."""
        return 1.0 - float(self.allow_counts[int(state)]) \
            / self.vocab_size

    def walk(self, tokens, state: Optional[int] = None) -> int:
        s = self.start if state is None else int(state)
        for t in tokens:
            s = self.step(s, t)
        return s


def _compile_ast(ast, vocab: TokenVocab, source) -> CompiledGrammar:
    ctrans, caccept = _ast_to_char_dfa(ast)
    n_char = len(ctrans)
    V = vocab.vocab_size
    n_states = n_char + 1              # +1: reserved all-allow state 0
    trans = np.full((n_states, V), -1, np.int32)
    trans[0] = np.arange(V)            # state 0: self-loop, all allowed
    allow = np.zeros((n_states, V), bool)
    allow[0] = True
    for tid, sur in vocab.items():
        for cs in range(n_char):
            s = cs
            ok = True
            for ch in sur:
                nxt = ctrans[s].get(ch)
                if nxt is None:
                    ok = False
                    break
                s = nxt
            if ok:
                trans[cs + 1, tid] = s + 1
                allow[cs + 1, tid] = True
    accepting = np.zeros(n_states, bool)
    for a in caccept:
        accepting[a + 1] = True
    start = 1
    if not allow[start].any() and not accepting[start]:
        raise ValueError(
            "grammar allows no token from its start state under this "
            "vocabulary — the schema's alphabet has no tokens")
    # min_tokens: BFS over token steps from start to an accept
    edges = [sorted({int(n) for n in trans[s] if n >= 0})
             for s in range(n_states)]
    INF = 10 ** 9
    dist = [INF] * n_states
    dist[start] = 0
    frontier = [start]
    while frontier:
        nxt_frontier = []
        for s in frontier:
            for n in edges[s]:
                if dist[n] > dist[s] + 1:
                    dist[n] = dist[s] + 1
                    nxt_frontier.append(n)
        frontier = nxt_frontier
    reach_acc = [dist[s] for s in range(n_states)
                 if accepting[s] and dist[s] < INF]
    if not reach_acc:
        raise ValueError("grammar accepts no string reachable from "
                         "its start state under this vocabulary")
    min_tokens = min(reach_acc)
    # max_tokens: longest start->accept path when the reachable
    # subgraph is a DAG; None (unbounded) when any cycle is reachable
    max_tokens: Optional[int] = None
    order, state_mark = [], {}
    acyclic = True

    def visit(s):
        nonlocal acyclic
        stack = [(s, iter(edges[s]))]
        state_mark[s] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for n in it:
                m = state_mark.get(n)
                if m == 1:
                    acyclic = False
                elif m is None:
                    state_mark[n] = 1
                    stack.append((n, iter(edges[n])))
                    advanced = True
                    break
            if not advanced:
                state_mark[node] = 2
                order.append(node)
                stack.pop()

    visit(start)
    if acyclic:
        # longest start->s path that could still END at an accept:
        # relax in topological order (reversed post-order)
        best = {start: 0}
        mt = 0 if accepting[start] else -1
        for s in reversed(order):    # topological
            if s not in best:
                continue
            for n in edges[s]:
                d = best[s] + 1
                if best.get(n, -1) < d:
                    best[n] = d
                    if accepting[n] and d > mt:
                        mt = d
        max_tokens = mt if mt >= 0 else None
    counts = allow.sum(1).astype(np.int64)
    return CompiledGrammar(
        source=source, vocab_size=V, n_states=n_states, start=start,
        masks=pack_masks(allow), trans=trans, accepting=accepting,
        allow_counts=counts, min_tokens=int(min_tokens),
        max_tokens=max_tokens)


# ---------------------------------------------------------------------------
# JSON-schema subset -> AST
# ---------------------------------------------------------------------------
def _json_literal(v) -> str:
    return json.dumps(v, separators=(",", ":"))


def _schema_ast(schema: dict):
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be a dict, got {type(schema)}")
    if "enum" in schema:
        vals = schema["enum"]
        if not vals:
            raise ValueError("enum must be non-empty")
        return ("alt", [_lit_seq(_json_literal(v)) for v in vals])
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        parts = [("lit", "{")]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts.append(("lit", ","))
            parts.append(_lit_seq(_json_literal(key) + ":"))
            parts.append(_schema_ast(sub))
        parts.append(("lit", "}"))
        return ("seq", parts)
    if t == "string":
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", 8))
        if not 0 <= lo <= hi:
            raise ValueError(f"string bounds {lo}..{hi} invalid")
        cls = ("class", frozenset(STRING_CHARS))
        return ("seq", [("lit", '"'), ("rep", cls, lo, hi),
                        ("lit", '"')])
    if t == "integer":
        digits = int(schema.get("maxDigits", 3))
        if digits < 1:
            raise ValueError("maxDigits must be >= 1")
        nonzero = ("class", frozenset("123456789"))
        digit = ("class", frozenset("0123456789"))
        body = ("alt", [("lit", "0"),
                        ("seq", [nonzero,
                                 ("rep", digit, 0, digits - 1)])])
        if schema.get("minimum", -1) >= 0:
            return body
        return ("seq", [("opt", ("lit", "-")), body])
    if t == "boolean":
        return ("alt", [_lit_seq("true"), _lit_seq("false")])
    if t == "null":
        return _lit_seq("null")
    if t == "array":
        items = schema.get("items", {"type": "integer"})
        lo = int(schema.get("minItems", 1))
        hi = int(schema.get("maxItems", 3))
        if not 0 <= lo <= hi:
            raise ValueError(f"array bounds {lo}..{hi} invalid")
        sub = _schema_ast(items)
        more = ("seq", [("lit", ","), sub])
        if hi == 0:
            body = ("seq", [])
        else:
            body = ("seq", [sub, ("rep", more, max(0, lo - 1),
                                  hi - 1)])
            if lo == 0:
                body = ("opt", body)
        return ("seq", [("lit", "["), body, ("lit", "]")])
    raise ValueError(f"unsupported schema: {schema!r} (the subset: "
                     "object/string/integer/boolean/null/enum/array)")


def compile_schema(schema: dict, vocab: TokenVocab) -> CompiledGrammar:
    """JSON schema (subset) -> token-level DFA: every accepted token
    stream detokenizes to text that ``json.loads`` parses AND
    ``schema_accepts`` validates — the serving_grammar gate's claim."""
    return _compile_ast(_schema_ast(schema), vocab, schema)


def schema_accepts(schema: dict, text: str) -> bool:
    """The gate-side validator: does ``text`` parse as JSON satisfying
    the (subset) schema? One implementation shared by the bench gate
    and the tests so the two can never disagree."""
    try:
        val = json.loads(text)
    except (ValueError, TypeError):
        return False
    return _value_ok(schema, val)


def _value_ok(schema: dict, val) -> bool:
    if "enum" in schema:
        return val in schema["enum"]
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        return (isinstance(val, dict)
                and set(val) == set(props)
                and all(_value_ok(sub, val[k])
                        for k, sub in props.items()))
    if t == "string":
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", 8))
        return (isinstance(val, str) and lo <= len(val) <= hi
                and all(ch in STRING_CHARS for ch in val))
    if t == "integer":
        digits = int(schema.get("maxDigits", 3))
        ok = isinstance(val, int) and not isinstance(val, bool) \
            and len(str(abs(val))) <= digits
        if schema.get("minimum", -1) >= 0:
            ok = ok and val >= 0
        return ok
    if t == "boolean":
        return isinstance(val, bool)
    if t == "null":
        return val is None
    if t == "array":
        items = schema.get("items", {"type": "integer"})
        lo = int(schema.get("minItems", 1))
        hi = int(schema.get("maxItems", 3))
        return (isinstance(val, list) and lo <= len(val) <= hi
                and all(_value_ok(items, v) for v in val))
    return False


# ---------------------------------------------------------------------------
# EBNF-ish subset -> AST
# ---------------------------------------------------------------------------
class _EBNF:
    """``name ::= expr`` lines; expr = alternation of concatenations
    of postfix-quantified primaries; primaries are ``'lit'``/``"lit"``
    literals, ``[a-z0-9]`` classes, ``(...)`` groups and rule
    references. References must be NON-recursive (the subset is
    regular by construction — a recursive rule raises)."""

    def __init__(self, text: str):
        self.rules: Dict[str, str] = {}
        self.order: List[str] = []
        for ln in text.splitlines():
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            if "::=" not in ln:
                raise ValueError(f"EBNF line without '::=': {ln!r}")
            name, rhs = ln.split("::=", 1)
            name = name.strip()
            if not name.isidentifier():
                raise ValueError(f"bad rule name {name!r}")
            if name in self.rules:
                raise ValueError(f"rule {name!r} defined twice")
            self.rules[name] = rhs.strip()
            self.order.append(name)
        if not self.rules:
            raise ValueError("empty grammar")
        self._resolving: set = set()
        self._done: Dict[str, object] = {}

    def start_ast(self):
        start = "root" if "root" in self.rules else self.order[0]
        return self.rule_ast(start)

    def rule_ast(self, name: str):
        if name in self._done:
            return self._done[name]
        if name in self._resolving:
            raise ValueError(
                f"rule {name!r} is recursive — the EBNF subset is "
                "regular (use * + ? {m,n} instead of recursion)")
        if name not in self.rules:
            raise ValueError(f"unknown rule {name!r}")
        self._resolving.add(name)
        ast, rest = self._alt(self.rules[name])
        if rest.strip():
            raise ValueError(f"rule {name!r}: trailing {rest!r}")
        self._resolving.discard(name)
        self._done[name] = ast
        return ast

    def _alt(self, s: str):
        parts, s = [], s.lstrip()
        node, s = self._seq(s)
        parts.append(node)
        while s.lstrip().startswith("|"):
            node, s = self._seq(s.lstrip()[1:])
            parts.append(node)
        return (parts[0] if len(parts) == 1 else ("alt", parts)), s

    def _seq(self, s: str):
        parts = []
        s = s.lstrip()
        while s and not s.startswith(("|", ")")):
            node, s = self._factor(s)
            parts.append(node)
            s = s.lstrip()
        if not parts:
            raise ValueError("empty alternative")
        return (parts[0] if len(parts) == 1 else ("seq", parts)), s

    def _factor(self, s: str):
        node, s = self._primary(s)
        s = s.lstrip()
        while s and s[0] in "*+?{":
            if s[0] == "*":
                node, s = ("star", node), s[1:]
            elif s[0] == "+":
                node, s = ("plus", node), s[1:]
            elif s[0] == "?":
                node, s = ("opt", node), s[1:]
            else:
                close = s.index("}")
                body = s[1:close]
                lo, _, hi = body.partition(",")
                lo = int(lo)
                hi = int(hi) if hi.strip() else lo
                node, s = ("rep", node, lo, hi), s[close + 1:]
            s = s.lstrip()
        return node, s

    def _primary(self, s: str):
        s = s.lstrip()
        if s[0] in "'\"":
            q = s[0]
            end = s.index(q, 1)
            lit = s[1:end]
            if not lit:
                raise ValueError("empty literal")
            return _lit_seq(lit), s[end + 1:]
        if s[0] == "[":
            end = s.index("]", 1)
            body, out = s[1:end], set()
            i = 0
            while i < len(body):
                if i + 2 < len(body) and body[i + 1] == "-":
                    for o in range(ord(body[i]), ord(body[i + 2]) + 1):
                        out.add(chr(o))
                    i += 3
                else:
                    out.add(body[i])
                    i += 1
            if not out:
                raise ValueError("empty character class")
            return ("class", frozenset(out)), s[end + 1:]
        if s[0] == "(":
            node, rest = self._alt(s[1:])
            rest = rest.lstrip()
            if not rest.startswith(")"):
                raise ValueError(f"unbalanced '(' near {s[:20]!r}")
            return node, rest[1:]
        i = 0
        while i < len(s) and (s[i].isalnum() or s[i] == "_"):
            i += 1
        if i == 0:
            raise ValueError(f"cannot parse near {s[:20]!r}")
        return self.rule_ast(s[:i]), s[i:]


def compile_grammar(text: str, vocab: TokenVocab) -> CompiledGrammar:
    """EBNF-ish (regular, non-recursive) grammar -> token DFA."""
    return _compile_ast(_EBNF(text).start_ast(), vocab, text)


def compile_source(source, vocab: TokenVocab) -> CompiledGrammar:
    """Dispatch on the store's value type: dict = JSON schema,
    str = EBNF text (the ``GrammarStore`` convention)."""
    if isinstance(source, dict):
        return compile_schema(source, vocab)
    if isinstance(source, str):
        return compile_grammar(source, vocab)
    raise ValueError(f"grammar source must be a schema dict or EBNF "
                     f"text, got {type(source)}")


# ---------------------------------------------------------------------------
# store + budgeted device cache
# ---------------------------------------------------------------------------
class GrammarStore:
    """Host-resident registry of named grammar sources (schema dicts
    or EBNF text) — the ``AdapterStore`` shape. Read-only at serve
    time; one store may back many engines/replicas."""

    def __init__(self, grammars: Optional[Dict[str, object]] = None):
        self._g: Dict[str, object] = {}
        for name, src in (grammars or {}).items():
            self.add(name, src)

    def add(self, name: str, source) -> None:
        if not isinstance(name, str) or not name:
            raise ValueError("grammar name must be a non-empty string")
        if name in self._g:
            raise ValueError(f"grammar {name!r} already registered")
        if not isinstance(source, (dict, str)):
            raise ValueError("grammar source must be a schema dict or "
                             "EBNF text")
        self._g[name] = source

    def get(self, name: str):
        if name not in self._g:
            raise KeyError(f"unknown grammar {name!r} (registered: "
                           f"{sorted(self._g)})")
        return self._g[name]

    def __contains__(self, name) -> bool:
        return name in self._g

    def __len__(self) -> int:
        return len(self._g)

    def names(self) -> List[str]:
        return sorted(self._g)


class GrammarCache:
    """Device residency manager for one engine's grammar bank — the
    fourth budgeted cache after the page pool, the adapter bank and
    the host arena, same census: every usable slot (slot 0 is the
    reserved all-allow identity) is exactly one of pinned-resident /
    evictable / free at all times.

    ``acquire(name, rid)`` -> ``(slot, compiled_now)``: a resident
    automaton (pinned by a sharer or parked evictable) is a HIT —
    revived, pinned, free; a miss compiles (memoized host-side — the
    DFA itself is built once per store entry ever) and uploads the
    packed masks into the bank slot through the factory hook, both
    inside ``timed`` so the engine prices one ``grammar_compile`` per
    miss on the virtual clock. ``MemoryError`` when every non-free
    slot is pinned — nothing but the refusal counter mutates.

    ``automaton(name)`` hands the engine the host-side
    ``CompiledGrammar`` (transitions, accepts, min/max tokens) for
    per-row state advance; ``flat_id(slot, state)`` is the bank row a
    decode row indexes (``slot * max_states + state``; free rows use
    0)."""

    def __init__(self, store: GrammarStore, n_slots: int,
                 max_states: int, vocab: TokenVocab,
                 init_bank: Callable[[], object],
                 upload: Callable[[object, int, object], object]):
        if n_slots < 2:
            raise ValueError("need n_slots >= 2 (slot 0 is the "
                             "reserved all-allow identity; at least "
                             "one usable slot)")
        if max_states < 2:
            raise ValueError("need max_states >= 2")
        self.store = store
        self.n_slots = int(n_slots)
        self.max_states = int(max_states)
        self.vocab = vocab
        self.bank = init_bank()
        self._upload = upload
        self._dfa: Dict[str, CompiledGrammar] = {}  # host memo
        self._slot: Dict[str, int] = {}
        self._pins: Dict[str, set] = {}
        self._evictable: Dict[str, bool] = {}  # insertion order = LRU
        self._free = list(range(self.n_slots - 1, 0, -1))
        self._stats = {"hits": 0, "misses": 0, "compiles": 0,
                       "evictions": 0, "refusals": 0}
        self._pending_compile: set = set()

    # --- probes (non-acquiring) -------------------------------------------
    def resident(self, name: str) -> bool:
        return name in self._slot

    def slot_of(self, name: str) -> Optional[int]:
        return self._slot.get(name)

    def automaton(self, name: str) -> CompiledGrammar:
        """The host-side automaton (compiling + memoizing on first
        use — NO device upload, no pin: the scheduler's min-token
        floor probes through this before admission ever runs)."""
        g = self._dfa.get(name)
        if g is None:
            g = compile_source(self.store.get(name), self.vocab)
            if g.n_states > self.max_states:
                raise ValueError(
                    f"grammar {name!r} compiles to {g.n_states} "
                    f"states > max_states {self.max_states} — raise "
                    "GrammarConfig.max_states or shrink the schema")
            self._dfa[name] = g
        return g

    def flat_id(self, slot: int, state: int) -> int:
        return int(slot) * self.max_states + int(state)

    # --- the acquire/release lifecycle ------------------------------------
    def acquire(self, name: str, rid: str, timed=None):
        """Pin ``name`` for in-flight request ``rid``; returns
        ``(slot, compiled)`` where ``compiled`` is True when the miss
        path ran (the admission paid one priced ``grammar_compile``).
        ``MemoryError`` when every non-free slot is pinned — nothing
        but the refusal counter mutates, so the caller requeues
        safely."""
        self.store.get(name)  # unknown grammars refuse loudly
        pins = self._pins.setdefault(name, set())
        if rid in pins:
            raise ValueError(f"grammar {name!r} already pinned for "
                             f"{rid!r}")
        if name in self._slot:
            self._evictable.pop(name, None)  # revival: LRU -> resident
            pins.add(rid)
            self._stats["hits"] += 1
            return self._slot[name], False
        if not self._free and not self._evictable:
            if not pins:
                self._pins.pop(name, None)  # undo the setdefault
            self._stats["refusals"] += 1
            raise MemoryError(
                f"grammar cache exhausted: {self.n_slots - 1} slots "
                f"all pinned by in-flight rows — requeue {rid!r} and "
                "retry when a row finishes")
        self._stats["misses"] += 1
        victim = None
        if self._free:
            slot = self._free.pop()
        else:
            victim = next(iter(self._evictable))
            del self._evictable[victim]
            slot = self._slot.pop(victim)
            self._pins.pop(victim, None)

        def _run():
            return self._upload(self.bank, slot, self.automaton(name))
        try:
            self.bank = timed(_run) if timed is not None else _run()
        except Exception:
            # exception-safe: a raising compile/upload (e.g. a DFA
            # larger than max_states) must not leak the slot out of
            # the census — restore the bookkeeping exactly (an
            # evicted victim's content was never overwritten)
            if victim is None:
                self._free.append(slot)
            else:
                self._slot[victim] = slot
                self._evictable[victim] = True
            self._stats["misses"] -= 1
            if not pins:
                self._pins.pop(name, None)
            raise
        if victim is not None:
            self._stats["evictions"] += 1
        self._stats["compiles"] += 1
        self._slot[name] = slot
        pins.add(rid)
        return slot, True

    def release(self, name: str, rid: str) -> None:
        """Unpin; the last unpin RETAINS the automaton (evictable
        LRU, content live) — the next sharer hits."""
        pins = self._pins.get(name)
        if pins is None or rid not in pins:
            raise ValueError(f"release: {name!r} holds no pin for "
                             f"{rid!r}")
        pins.discard(rid)
        if not pins:
            self._pins.pop(name, None)
            if name in self._slot:
                self._evictable[name] = True

    def note_rollback(self, name: str, rid: str,
                      compiled: bool) -> None:
        """``rid``'s admission failed AFTER ``acquire`` (page-pool
        refusal): unpin, and when that acquire paid the compile,
        remember the rid so ``took_compile`` attributes it to the
        admission that eventually succeeds."""
        self.release(name, rid)
        if compiled:
            self._pending_compile.add(rid)

    def forget_pending(self, rid: str) -> None:
        self._pending_compile.discard(rid)

    def took_compile(self, rid: str, compiled: bool) -> bool:
        if rid in self._pending_compile:
            self._pending_compile.discard(rid)
            return True
        return compiled

    # --- census ------------------------------------------------------------
    def resident_count(self) -> int:
        return len(self._slot)

    def populations(self) -> Tuple[int, int, int]:
        """The census populations (pinned, evictable, free) — shared
        between ``census_ok`` and the cost ledger's occupancy
        sampler."""
        pinned = sum(1 for n in self._slot if self._pins.get(n))
        return pinned, len(self._evictable), len(self._free)

    def pin_owners(self) -> Dict[str, List[str]]:
        """schema name -> sorted holder rids, pinned slots only — the
        attribution view the cost ledger splits slot-turns by."""
        return {n: sorted(self._pins[n]) for n in self._slot
                if self._pins.get(n)}

    def census_ok(self) -> bool:
        return obs_ledger.census_balanced(self.n_slots - 1,
                                          *self.populations())

    def cache_stats(self) -> dict:
        """The ``AdapterCache.cache_stats`` shape, grammar-named."""
        pinned = sum(1 for n in self._slot if self._pins.get(n))
        hits, misses = self._stats["hits"], self._stats["misses"]
        lookups = hits + misses
        return {
            "n_slots": self.n_slots - 1,
            "resident_slots": pinned,
            "evictable_slots": len(self._evictable),
            "free_slots": len(self._free),
            "resident_grammars": len(self._slot),
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / lookups, 4) if lookups else 0.0,
            "compiles": self._stats["compiles"],
            "evictions": self._stats["evictions"],
            "refusals": self._stats["refusals"],
        }
