"""Grammar-constrained decoding: regex, choices or a JSON schema -> a
token-level DFA.

Counterpart of np_modeling_tpu/serving/constrain.py, which imports only
numpy and dataclasses; the port keeps its own copy, and gives the same
``trans`` tables. A constraint is compiled offline into a token-level DFA:
an int32 ``trans[n_states, vocab]`` table whose entry is the next state, or
-1 where emitting that token would leave the language. The serving engine
keeps one DFA state a slot on the device; a step's mask is one row gather
(``trans[state] >= 0``) and its transition one indexed read, so
constrained and unconstrained slots share one step.

- :func:`dfa_from_regex`: a character-level regex (literals, ``.``,
  ``[...]`` classes with ranges and negation, groups, ``|``, ``*``, ``+``,
  ``?``) compiled by Brzozowski derivatives and composed with the
  tokenizer's vocabulary by one trie walk a DFA state. Accepting states
  allow ``eos_id``.
- :func:`dfa_from_choices`: a trie over explicit token-id sequences; a
  finished choice allows only EOS.
- :func:`dfa_from_json_schema`: a JSON schema as a regex AST
  (:func:`json_schema_ast`), then the regex construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ---- regex AST + Brzozowski derivatives ------------------------------------
# Nodes are hashable tuples so derivative states canonicalize by equality:
# ("empty",)          — matches nothing (dead)
# ("eps",)            — matches the empty string
# ("cls", frozenset, neg) — one character from (or not from) the set
# ("cat", a, b) / ("alt", a, b) / ("star", a)

_EMPTY = ("empty",)
_EPS = ("eps",)


def _cls(chars, neg=False):
    return ("cls", frozenset(chars), neg)


def _cat(a, b):
    if a == _EMPTY or b == _EMPTY:
        return _EMPTY
    if a == _EPS:
        return b
    if b == _EPS:
        return a
    return ("cat", a, b)


def _alt(a, b):
    # Alternation is kept as a flattened FROZENSET of terms: derivatives
    # are only guaranteed finite modulo associativity/commutativity/
    # idempotence of |, and a set representation gives exactly that
    # (nested binary alts re-grow forever on patterns like "x+(.y+)?").
    terms = set()
    for x in (a, b):
        if x == _EMPTY:
            continue
        if x[0] == "alt":
            terms |= x[1]
        else:
            terms.add(x)
    if not terms:
        return _EMPTY
    if len(terms) == 1:
        return next(iter(terms))
    return ("alt", frozenset(terms))


def _star(a):
    if a in (_EMPTY, _EPS):
        return _EPS
    if a[0] == "star":
        return a
    return ("star", a)


def _nullable(r) -> bool:
    t = r[0]
    if t == "eps":
        return True
    if t in ("empty", "cls"):
        return False
    if t == "cat":
        return _nullable(r[1]) and _nullable(r[2])
    if t == "alt":
        return any(_nullable(x) for x in r[1])
    return True                                   # star


def _deriv(r, c):
    t = r[0]
    if t in ("empty", "eps"):
        return _EMPTY
    if t == "cls":
        inside = c in r[1]
        return _EPS if (inside != r[2]) else _EMPTY
    if t == "cat":
        d = _cat(_deriv(r[1], c), r[2])
        if _nullable(r[1]):
            d = _alt(d, _deriv(r[2], c))
        return d
    if t == "alt":
        out = _EMPTY
        for x in r[1]:
            out = _alt(out, _deriv(x, c))
        return out
    return _cat(_deriv(r[1], c), r)               # star


class _Parser:
    """Recursive-descent parser for the supported regex subset."""

    def __init__(self, pat: str):
        self.s, self.i = pat, 0

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else None

    def eat(self):
        c = self.s[self.i]
        self.i += 1
        return c

    def parse(self):
        r = self.alternation()
        if self.i != len(self.s):
            raise ValueError(f"unexpected {self.s[self.i]!r} at {self.i}")
        return r

    def alternation(self):
        r = self.concat()
        while self.peek() == "|":
            self.eat()
            r = _alt(r, self.concat())
        return r

    def concat(self):
        r = _EPS
        while self.peek() is not None and self.peek() not in "|)":
            r = _cat(r, self.repeat())
        return r

    def repeat(self):
        r = self.atom()
        while self.peek() in ("*", "+", "?"):
            op = self.eat()
            if op == "*":
                r = _star(r)
            elif op == "+":
                r = _cat(r, _star(r))
            else:
                r = _alt(r, _EPS)
        return r

    def atom(self):
        c = self.eat()
        if c == "(":
            r = self.alternation()
            if self.peek() != ")":
                raise ValueError("unbalanced (")
            self.eat()
            return r
        if c == "[":
            return self.char_class()
        if c == ".":
            return _cls(set(), neg=True)          # any char
        if c == "\\":
            return _cls({self._escape(self.eat())})
        if c in "*+?)|":
            raise ValueError(f"misplaced {c!r}")
        return _cls({c})

    def char_class(self):
        neg = self.peek() == "^"
        if neg:
            self.eat()
        chars = set()
        while self.peek() != "]":
            if self.peek() is None:
                raise ValueError("unbalanced [")
            c = self.eat()
            if c == "\\":
                c = self._escape(self.eat())
            if self.peek() == "-" and self.s[self.i + 1:self.i + 2] != "]":
                self.eat()
                hi = self.eat()
                if hi == "\\":
                    hi = self._escape(self.eat())
                chars.update(chr(x) for x in range(ord(c), ord(hi) + 1))
            else:
                chars.add(c)
        self.eat()
        return _cls(chars, neg)

    @staticmethod
    def _escape(c):
        return {"n": "\n", "t": "\t", "r": "\r"}.get(c, c)


# ---- token-level DFA --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenDFA:
    """Token-level constraint automaton.

    ``trans`` int32 [n_states, vocab]: next state or -1 (token forbidden).
    ``start``: initial state. The engine masks logits with
    ``trans[state] >= 0`` and steps ``state = trans[state, token]``.
    State 0 of a stacked engine table is reserved for "unconstrained"
    (all-zero trans: everything allowed, state never moves)."""

    trans: object           # np.ndarray int32 [n_states, vocab]
    start: int = 0

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def dfa_from_choices(sequences, vocab_size: int, eos_id: int) -> TokenDFA:
    """Constrain output to exactly one of ``sequences`` (lists of token
    ids) followed by EOS (which then self-loops so further steps stay
    legal while the caller notices the EOS and finishes)."""
    if not sequences or any(len(s) == 0 for s in sequences):
        raise ValueError("dfa_from_choices needs non-empty sequences "
                         "(an empty grammar would forbid every token)")
    trie = {}                                     # state -> {tok: state}
    n = 1
    accept = set()
    for seq in sequences:
        s = 0
        for t in seq:
            nxt = trie.setdefault(s, {}).get(int(t))
            if nxt is None:
                nxt = n
                trie.setdefault(s, {})[int(t)] = nxt
                n += 1
            s = nxt
        accept.add(s)
    trans = np.full((n + 1, vocab_size), -1, np.int32)
    done = n                                      # post-EOS absorbing state
    for s, edges in trie.items():
        for t, nxt in edges.items():
            trans[s, t] = nxt
    for s in accept:
        trans[s, eos_id] = done
    trans[done, eos_id] = done
    return TokenDFA(trans=trans, start=0)


def _vocab_trie(token_strings):
    """Prefix trie over the vocabulary: node = (children dict, token ids
    ending here). One walk per DFA state computes every token's landing
    state in O(trie nodes) instead of O(vocab * token length)."""
    root = ({}, [])
    for tid, s in enumerate(token_strings):
        if not s:                                 # empty/unused slot
            continue
        node = root
        for ch in s:
            node = node[0].setdefault(ch, ({}, []))
        node[1].append(tid)
    return root


def dfa_from_regex(pattern: str, token_strings, eos_id: int) -> TokenDFA:
    """Compile ``pattern`` against a tokenizer vocabulary.

    ``token_strings``: decoded text of every token id (index = id; empty
    string = never allowed, e.g. special tokens). Generated text must
    match the FULL pattern, then EOS (allowed exactly in accepting
    states; EOS self-loops afterwards). States are discovered on the fly:
    each new char-DFA state is product-walked over the vocabulary trie
    once."""
    return _dfa_from_root(_Parser(pattern).parse(), token_strings, eos_id,
                          what=repr(pattern))


def _dfa_from_root(root, token_strings, eos_id: int, what: str) -> TokenDFA:
    """Shared product construction: char-level regex AST x vocab trie."""
    ids = {root: 0}
    order = [root]
    trie = _vocab_trie(token_strings)
    vocab = len(token_strings)
    rows = []
    deriv_cache = {}

    def d(r, c):
        key = (r, c)
        if key not in deriv_cache:
            deriv_cache[key] = _deriv(r, c)
        return deriv_cache[key]

    i = 0
    while i < len(order):
        r = order[i]
        row = np.full((vocab,), -1, np.int32)

        def walk(node, cur):
            children, ends = node
            for tid in ends:
                nxt = ids.get(cur)
                if nxt is None:
                    nxt = ids[cur] = len(order)
                    order.append(cur)
                row[tid] = nxt
            for ch, child in children.items():
                step = d(cur, ch)
                if step != _EMPTY:
                    walk(child, step)

        if r != _EMPTY:
            walk(trie, r)
        rows.append(row)
        i += 1

    trans = np.stack(rows) if rows else np.full((1, vocab), -1, np.int32)
    # EOS: allowed exactly when the state accepts; then absorb.
    done = trans.shape[0]
    trans = np.concatenate([trans, np.full((1, vocab), -1, np.int32)])
    for s, r in enumerate(order):
        if _nullable(r):
            trans[s, eos_id] = done
    trans[done, eos_id] = done
    # DEAD-END elimination: forbid tokens leading to states from which
    # acceptance is unreachable WITH THIS VOCABULARY — e.g. spelling the
    # prefix of a word the vocab can't finish. Without this a greedy
    # decode can paint itself into a corner (all -inf). Backward
    # fixed point over the token edges, then one prune pass.
    n = trans.shape[0]
    co = np.zeros((n,), bool)
    co[done] = True
    while True:
        reach = ((trans >= 0) & co[np.clip(trans, 0, n - 1)]).any(axis=1)
        reach[done] = True
        if (reach == co).all():
            break
        co = reach
    trans[(trans >= 0) & ~co[np.clip(trans, 0, n - 1)]] = -1
    if not (trans[0] >= 0).any():
        raise ValueError(
            f"pattern {what} cannot be completed with this vocabulary")
    return TokenDFA(trans=trans, start=0)


# ---- JSON-schema -> regex AST -> token DFA ----------------------------------
# The industry-standard structured-output surface (OpenAI response_format
# json_schema / Outlines): compile the schema to a character-level regex AST
# using the SAME combinators as the pattern parser (no string-escaping
# round-trip), then reuse the product construction above. Emitted JSON is
# compact (one optional space after ':' and ','), which every JSON parser
# accepts.

_JSON_STRING_INNER = None


def _lit(text: str):
    """AST matching a literal string."""
    r = _EPS
    for ch in text:
        r = _cat(r, _cls({ch}))
    return r


def _json_string_inner():
    """Body of a JSON string: any char except '"'/'\\'/control, or an
    escape sequence."""
    global _JSON_STRING_INNER
    if _JSON_STRING_INNER is None:
        ctrl = {chr(c) for c in range(0x20)}
        plain = _cls(ctrl | {'"', "\\"}, neg=True)
        hexd = _cls(set("0123456789abcdefABCDEF"))
        esc = _cat(_cls({"\\"}),
                   _alt(_cls(set('"\\/bfnrt')),
                        _cat(_cls({"u"}),
                             _cat(hexd, _cat(hexd, _cat(hexd, hexd))))))
        _JSON_STRING_INNER = _star(_alt(plain, esc))
    return _JSON_STRING_INNER


def _json_string_ast():
    return _cat(_cls({'"'}), _cat(_json_string_inner(), _cls({'"'})))


def _json_number_ast(integer: bool = False):
    digit = _cls(set("0123456789"))
    nonzero = _cls(set("123456789"))
    int_part = _cat(_alt(_cls({"-"}), _EPS),
                    _alt(_cls({"0"}), _cat(nonzero, _star(digit))))
    if integer:
        return int_part
    frac = _alt(_cat(_cls({"."}), _cat(digit, _star(digit))), _EPS)
    expo = _alt(_cat(_cls({"e", "E"}),
                     _cat(_alt(_cls({"-", "+"}), _EPS),
                          _cat(digit, _star(digit)))), _EPS)
    return _cat(int_part, _cat(frac, expo))


_WS = None


def _ws():
    """One OPTIONAL space (emitted after ':' and ',')."""
    global _WS
    if _WS is None:
        _WS = _alt(_cls({" "}), _EPS)
    return _WS


def _json_render(value) -> str:
    import json as _json
    return _json.dumps(value, separators=(",", ": "))


def json_schema_ast(schema: dict, _depth: int = 0):
    """Regex AST for the values a JSON schema accepts.

    Supported: type object (properties + required; unknown keys closed
    out), array (items, minItems/maxItems), string (enum via the outer
    ``enum``, pattern, minLength/maxLength), number/integer
    (no range constraints — lexical JSON numbers), boolean, null,
    ``enum``/``const`` of JSON values, anyOf/oneOf, $ref into
    ``$defs``/``definitions`` (non-recursive). Raises ValueError on
    anything else rather than silently under-constraining."""
    if _depth > 64:
        raise ValueError("schema nesting too deep (recursive $ref?)")
    if not isinstance(schema, dict):
        raise ValueError(f"schema must be a dict, got {type(schema)}")
    if "$ref" in schema:
        ref = schema["$ref"]
        root = schema.get("$root", schema)
        for prefix in ("#/$defs/", "#/definitions/"):
            if ref.startswith(prefix):
                defs = root.get(prefix.split("/")[1], {})
                name = ref[len(prefix):]
                if name not in defs:
                    raise ValueError(f"unresolved $ref {ref!r}")
                target = dict(defs[name])
                target.setdefault("$root", root)
                return json_schema_ast(target, _depth + 1)
        raise ValueError(f"unsupported $ref form {ref!r}")

    def sub(s):
        s = dict(s)
        s.setdefault("$root", schema.get("$root", schema))
        return json_schema_ast(s, _depth + 1)

    if "const" in schema:
        return _lit(_json_render(schema["const"]))
    if "enum" in schema:
        out = _EMPTY
        for v in schema["enum"]:
            out = _alt(out, _lit(_json_render(v)))
        return out
    for key in ("anyOf", "oneOf"):
        if key in schema:
            out = _EMPTY
            for s in schema[key]:
                out = _alt(out, sub(s))
            return out

    t = schema.get("type")
    if isinstance(t, list):
        out = _EMPTY
        for ti in t:
            out = _alt(out, sub({**schema, "type": ti}))
        return out
    if t == "null":
        return _lit("null")
    if t == "boolean":
        return _alt(_lit("true"), _lit("false"))
    if t in ("number", "integer"):
        return _json_number_ast(integer=(t == "integer"))
    if t == "string":
        if "pattern" in schema:
            body = _Parser(schema["pattern"]).parse()
            return _cat(_cls({'"'}), _cat(body, _cls({'"'})))
        lo = schema.get("minLength")
        hi = schema.get("maxLength")
        if lo is not None or hi is not None:
            ctrl = {chr(c) for c in range(0x20)}
            ch = _cls(ctrl | {'"', "\\"}, neg=True)   # no escapes w/ bounds
            lo = int(lo or 0)
            body = _EPS
            for _ in range(lo):
                body = _cat(body, ch)
            if hi is None:
                body = _cat(body, _star(ch))
            else:
                for _ in range(int(hi) - lo):
                    body = _cat(body, _alt(ch, _EPS))
            return _cat(_cls({'"'}), _cat(body, _cls({'"'})))
        return _json_string_ast()
    if t == "array":
        item = sub(schema.get("items", {"type": ["null", "boolean",
                                                 "number", "string"]}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is not None and int(hi) == 0:
            return _lit("[]")
        more = _cat(_cls({","}), _cat(_ws(), item))
        if hi is None:
            tail = _star(more)
        else:
            tail = _EPS
            for _ in range(int(hi) - max(lo, 1)):
                tail = _alt(_cat(more, tail), _EPS)
        body = _cat(item, tail)
        for _ in range(max(lo, 1) - 1):
            body = _cat(_cat(item, _cat(_cls({","}), _ws())), body)
        if lo == 0:
            body = _alt(body, _EPS)
        return _cat(_cls({"["}), _cat(body, _cls({"]"})))
    if t == "object":
        props = list(schema.get("properties", {}).items())
        required = set(schema.get("required", [k for k, _ in props]))
        unknown = required - {k for k, _ in props}
        if unknown:
            raise ValueError(f"required names not in properties: {unknown}")
        items = [_cat(_lit(_json_render(k) + ":"), _cat(_ws(), sub(v)))
                 for k, v in props]
        req = [k in required for k, _ in props]

        # rest(i): properties i.. with something already emitted (each
        # present item needs a leading comma); first(i): nothing emitted
        # yet. Memoized so optional properties stay linear-size.
        from functools import lru_cache

        @lru_cache(maxsize=None)
        def rest(i):
            if i == len(items):
                return _EPS
            with_it = _cat(_cat(_cls({","}), _cat(_ws(), items[i])),
                           rest(i + 1))
            return with_it if req[i] else _alt(with_it, rest(i + 1))

        @lru_cache(maxsize=None)
        def first(i):
            if i == len(items):
                return _EPS
            with_it = _cat(items[i], rest(i + 1))
            return with_it if req[i] else _alt(with_it, first(i + 1))

        return _cat(_cls({"{"}), _cat(first(0), _cls({"}"})))
    raise ValueError(f"unsupported schema: {schema!r}")


def dfa_from_json_schema(schema: dict, token_strings,
                         eos_id: int) -> TokenDFA:
    """Token DFA accepting exactly the JSON documents ``schema`` permits
    (compact rendering, optional single space after ':' and ','),
    followed by EOS. Served through the HTTP server's
    ``response_format={"type": "json_schema", ...}``."""
    root = json_schema_ast(schema)
    return _dfa_from_root(root, token_strings, eos_id,
                          what=f"json schema {schema!r:.120s}")
