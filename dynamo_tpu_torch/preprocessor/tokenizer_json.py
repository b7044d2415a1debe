"""HF `tokenizer.json` files in the standard library.

The card has no `tokenizers` or `transformers`, so the port runs a
tokenizer.json pipeline of its own, for the kinds the served families
ship: the BPE model with byte-level pieces (GPT-2, Llama-3, Qwen2: a
`Split` regex pre-tokenizer and `ByteLevel`, `ignore_merges`) or with
SentencePiece-style pieces (Llama-2, Phi-3, Gemma: `Metaspace`, or the
Prepend/Replace normalizer, `byte_fallback`), and the WordLevel model with
`Whitespace`. Each stage follows the Rust `tokenizers` crate's:

- added tokens are split out of the raw text first (leftmost-longest, with
  their single_word/lstrip/rstrip flags), normalized ones out of the
  normalized text;
- normalizers: NFC, Prepend, Replace (string patterns), Sequence;
- pre-tokenizers: Split (regex or string, Isolated), ByteLevel,
  Metaspace, Whitespace, Sequence;
- models: BPE (merge ranks in a dict, the lowest rank and then the
  leftmost pair first, a per-word cache, byte fallback, unk fusing) and
  WordLevel;
- decoders: ByteLevel, Replace, ByteFallback, Fuse, Strip, Metaspace,
  Sequence; with none, tokens join with spaces.

Any other type is refused by name at load.

Regexes: the crate compiles patterns with Oniguruma, a backtracking engine
with leftmost-first alternation, as Python's `re` is; `\\p{..}`, `\\s`,
`\\w` and `\\d` are rewritten into explicit classes built once per process
from `unicodedata` (Oniguruma's Unicode definitions: `\\s` White_Space,
`\\w` Alphabetic, marks, decimal digits, connector punctuation and
Join_Control, `\\d` decimal digits). Python 3.12's unicodedata is Unicode 15.0; where the
crate's Oniguruma tables are of another version, characters assigned in
between can fall in another class, and NFC can differ on them likewise.
"""

from __future__ import annotations

import functools
import heapq
import re
import sys
import unicodedata
from typing import Callable, Optional, Sequence

#: White_Space (Oniguruma's Unicode \s)
_WHITE_SPACE = ("\t", "\n", "\x0b", "\x0c", "\r", " ", "\x85", "\xa0", "\u1680",
                *(chr(c) for c in range(0x2000, 0x200B)), "\u2028", "\u2029", "\u202f",
                "\u205f", "\u3000")


#: Oniguruma's Unicode \w beyond L, M, Nd, Nl and Pc: Join_Control and the
#: So code points of Other_Alphabetic (circled and squared Latin letters;
#: its other members are marks)
_WORD_EXTRA = ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
               (0x1F170, 0x1F189))


def _escape(c: int) -> str:
    return f"\\U{c:08x}" if c > 0xFFFF else f"\\u{c:04x}"


@functools.lru_cache(maxsize=None)
def _category_runs() -> tuple[tuple[int, int, str], ...]:
    """(first, last, general category) runs over every code point: one
    pass of unicodedata, shared by every class built from it."""
    runs = []
    first, cat = 0, unicodedata.category("\x00")
    for c in range(1, sys.maxunicode + 1):
        k = unicodedata.category(chr(c))
        if k != cat:
            runs.append((first, c - 1, cat))
            first, cat = c, k
    runs.append((first, sys.maxunicode, cat))
    return tuple(runs)


@functools.lru_cache(maxsize=None)
def _class_body(name: str) -> str:
    """The body of a regex character class (no brackets) for a general
    category or its letter ("L", "N", "Lu", ...), or for "s", "w", "d"."""
    if name == "s":
        spans = [(ord(c), ord(c)) for c in _WHITE_SPACE]
    else:
        cats = {"w": ("L", "M", "Nd", "Nl", "Pc"), "d": ("Nd",)}.get(name, (name,))
        spans = [(a, b) for a, b, k in _category_runs() if k.startswith(cats)]
        if name == "w":
            spans = sorted(spans + list(_WORD_EXTRA))
    merged: list[list[int]] = []
    for a, b in spans:
        if merged and merged[-1][1] + 1 == a:
            merged[-1][1] = b
        else:
            merged.append([a, b])
    return "".join(_escape(a) if a == b else f"{_escape(a)}-{_escape(b)}" for a, b in merged)


_CLASS_ESCAPE = re.compile(r"\\([pP])\{(\w+)\}|\\([sSwWdD])")


def translate_regex(pattern: str) -> re.Pattern:
    """A tokenizer.json regex (Oniguruma syntax) as a Python pattern with
    the Unicode classes made explicit."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        m = _CLASS_ESCAPE.match(pattern, i) if c == "\\" else None
        if m:
            if m.group(1):
                name, negated = m.group(2), m.group(1) == "P"
            else:
                name, negated = m.group(3).lower(), m.group(3).isupper()
            if name not in ("s", "w", "d") and not re.fullmatch(r"[A-Z][a-z]?", name):
                raise ValueError(f"tokenizer regex: unsupported class \\p{{{name}}}")
            body = _class_body(name)
            if in_class:
                if negated:
                    raise ValueError(f"tokenizer regex: a negated class {m.group(0)} inside "
                                     "[...] is not supported")
                out.append(body)
            else:
                out.append(f"[{'^' if negated else ''}{body}]")
            i = m.end()
            continue
        if c == "\\":
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            if pattern[i + 1:i + 2] == "]":  # a literal ] first in the class
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return re.compile("".join(out))


# -- the GPT-2 byte alphabet ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's printable byte <-> unicode map (byte-level BPE vocabularies
    store pieces in this alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=None)
def unicode_to_bytes() -> dict[str, int]:
    return {u: b for b, u in bytes_to_unicode().items()}


# -- normalizers ----------------------------------------------------------------------

Normalizer = Callable[[str], str]


def _string_pattern(spec: dict, where: str) -> str:
    pat = spec["pattern"]
    if "String" not in pat:
        raise ValueError(f"tokenizer.json: {where} with a {sorted(pat)} pattern is not supported")
    return pat["String"]


def _normalizer(spec: Optional[dict]) -> Optional[Normalizer]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(s) for s in spec["normalizers"]]

        def seq(text: str) -> str:
            for p in parts:
                text = p(text)
            return text
        return seq
    if kind == "NFC":
        return functools.partial(unicodedata.normalize, "NFC")
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda text: pre + text if text else text
    if kind == "Replace":
        old, new = _string_pattern(spec, "the Replace normalizer"), spec["content"]
        return lambda text: text.replace(old, new)
    raise ValueError(f"tokenizer.json: normalizer {kind!r} is not supported by "
                     "dynamo_tpu_torch")


# -- pre-tokenizers --------------------------------------------------------------------

#: a pre-tokenizer maps (pieces of text, each with its start in the
#: original text) to finer pieces
Piece = tuple[str, int]
PreTokenizer = Callable[[list[Piece]], list[Piece]]


def _split(text: str, start: int, spans: list[tuple[int, int]], behavior: str) -> list[Piece]:
    """`text` cut at the regex matches `spans` as the crate's
    SplitDelimiterBehavior does (Isolated: each match a piece of its own;
    MergedWithNext: each match opens the next piece), empty pieces
    dropped. A piece's start is the parent's plus its offset (Metaspace
    reads only whether it is 0)."""
    if behavior not in ("Isolated", "MergedWithNext"):
        raise ValueError(f"tokenizer.json: split behavior {behavior!r} is not supported")
    cuts = sorted({0, len(text)} | {a for a, _ in spans}
                  | ({b for _, b in spans} if behavior == "Isolated" else set()))
    return [(text[a:b], start + a) for a, b in zip(cuts, cuts[1:]) if b > a]


def _regex_splitter(rx: re.Pattern, behavior: str) -> PreTokenizer:
    def split(pieces: list[Piece]) -> list[Piece]:
        out = []
        for text, start in pieces:
            spans = [m.span() for m in rx.finditer(text) if m.end() > m.start()]
            out += _split(text, start, spans, behavior)
        return out
    return split


#: GPT-2's pattern, ByteLevel's with use_regex
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _pre_tokenizer(spec: Optional[dict], add_prefix_space: Optional[bool]) -> PreTokenizer:
    """`add_prefix_space`: transformers' override of a top-level
    pre-tokenizer's flag (tokenizer_config.json's, False when absent)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if add_prefix_space is not None and "add_prefix_space" in spec:
        spec = {**spec, "add_prefix_space": add_prefix_space}
    if kind == "Sequence":
        parts = [_pre_tokenizer(s, None) for s in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "Split":
        if spec.get("invert"):
            raise ValueError("tokenizer.json: an inverted Split is not supported")
        pat = spec["pattern"]
        rx = translate_regex(pat["Regex"]) if "Regex" in pat else re.compile(re.escape(pat["String"]))
        return _regex_splitter(rx, spec["behavior"])
    if kind == "ByteLevel":
        b2u = bytes_to_unicode()
        rx = translate_regex(_GPT2_PATTERN) if spec.get("use_regex", True) else None
        prefix = spec.get("add_prefix_space", False)

        def byte_level(pieces):
            if prefix:
                pieces = [(t if t.startswith(" ") else " " + t, s) for t, s in pieces]
            if rx is not None:
                pieces = _regex_splitter(rx, "Isolated")(pieces)
            return [("".join(b2u[b] for b in t.encode("utf-8")), s) for t, s in pieces]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files written before prepend_scheme
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)
        splitter = _regex_splitter(re.compile(re.escape(rep)), "MergedWithNext")

        def metaspace(pieces):
            out = []
            for text, start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and start == 0)):
                    text = rep + text
                out.append((text, start))
            return splitter(out) if do_split else out
        return metaspace
    if kind == "Whitespace":
        rx = translate_regex(r"\w+|[^\w\s]+")

        def whitespace(pieces):
            return [(m.group(0), s + m.start()) for t, s in pieces for m in rx.finditer(t)]
        return whitespace
    raise ValueError(f"tokenizer.json: pre-tokenizer {kind!r} is not supported by "
                     "dynamo_tpu_torch")


# -- models -----------------------------------------------------------------------------


class _WordLevel:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")

    def tokenize(self, piece: str) -> list[int]:
        tid = self.vocab.get(piece)
        if tid is None:
            tid = self.vocab.get(self.unk) if self.unk is not None else None
            if tid is None:
                raise ValueError(f"WordLevel: {piece!r} is not in the vocabulary and it "
                                 "has no unk token")
        return [tid]


class _BPE:
    #: words remembered by tokenize (the crate's cache holds 10,000)
    CACHE = 10_000

    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise ValueError("tokenizer.json: BPE dropout is not supported")
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        if spec.get("continuing_subword_prefix") or spec.get("end_of_word_suffix"):
            raise ValueError("tokenizer.json: BPE subword prefixes and word suffixes are not "
                             "supported")
        #: (left id, right id) -> (rank, merged id)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
            except KeyError:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names a token not in "
                                 "the vocabulary") from None
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, piece: str) -> list[int]:
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        if self.ignore_merges and piece in self.vocab:
            ids = [self.vocab[piece]]
        else:
            ids = self._merge(self._symbols(piece))
        if len(self._cache) >= self.CACHE:
            self._cache.clear()
        self._cache[piece] = ids
        return ids

    def _symbols(self, word: str) -> list[int]:
        """The word's characters as ids, byte fallback or unk for characters
        out of the vocabulary."""
        out: list[int] = []
        unk_run = False
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                out.append(tid)
                unk_run = False
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(t is not None for t in fb):
                    out += fb
                    unk_run = False
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise ValueError(f"BPE: unk token {self.unk!r} is not in the vocabulary")
                if not (self.fuse_unk and unk_run):
                    out.append(self.vocab[self.unk])
                unk_run = True
        return out

    def _merge(self, syms: list[int]) -> list[int]:
        """Word::merge_all: pop the lowest (rank, position) pair, skip it
        if stale, merge, queue the pairs the merge made."""
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((syms[pos], syms[right]))
            if m is None or m[1] != new_id:
                continue
            syms[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = merges.get((syms[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, syms[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, a in zip(syms, alive) if a]


def _model(spec: dict):
    kind = spec.get("type") or ("BPE" if "merges" in spec else None)
    if kind == "BPE":
        return _BPE(spec)
    if kind == "WordLevel":
        return _WordLevel(spec)
    raise ValueError(f"tokenizer.json: model {kind!r} is not supported by dynamo_tpu_torch")


# -- decoders ---------------------------------------------------------------------------

Decoder = Callable[[list[str]], list[str]]


def _byte_token(tok: str) -> Optional[int]:
    if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
        try:
            return int(tok[3:5], 16)
        except ValueError:
            return None
    return None


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    run: list[int] = []

    def flush():
        if run:
            try:
                out.append(bytes(run).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run.clear()
    for tok in tokens:
        b = _byte_token(tok)
        if b is not None:
            run.append(b)
        else:
            flush()
            out.append(tok)
    flush()
    return out


def _decoder(spec: Optional[dict]) -> Optional[Decoder]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        u2b = unicode_to_bytes()

        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                try:
                    data += bytes(u2b[c] for c in t)
                except KeyError:  # outside the alphabet: the token's own bytes
                    data += t.encode("utf-8")
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        old, new = _string_pattern(spec, "the Replace decoder"), spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for _ in range(stop):
                    if b > a and t[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(t[a:b])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        drop_first = scheme != "never"
        return lambda tokens: [t.replace(rep, "" if i == 0 and drop_first else " ")
                               for i, t in enumerate(tokens)]
    raise ValueError(f"tokenizer.json: decoder {kind!r} is not supported by dynamo_tpu_torch")


# -- the tokenizer -----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _word_char() -> re.Pattern:
    """The crate's `\\w` for a single_word token's neighbours (the regex
    crate's Unicode \\w, which Oniguruma's equals)."""
    return re.compile(f"[{_class_body('w')}]")


def _is_word(ch: str) -> bool:
    return _word_char().match(ch) is not None


class AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip", "normalized", "special")

    def __init__(self, spec: dict):
        self.id = int(spec["id"])
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.single_word = bool(spec.get("single_word", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.normalized = bool(spec.get("normalized", not self.special))


class TokenizerJson:
    """A tokenizer.json (its parsed dict) and the added tokens transformers
    would add from tokenizer_config.json (`extra`: dicts of an added
    token's fields, `id` None for a token to place). `encode` gives
    `Tokenizer.encode(text, add_special_tokens=False)`'s ids, `decode`
    `Tokenizer.decode(ids, skip_special_tokens)`."""

    def __init__(self, spec: dict, extra: Sequence[dict] = (),
                 add_prefix_space: Optional[bool] = None):
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"), add_prefix_space)
        self.model = _model(spec["model"])
        self.decoder = _decoder(spec.get("decoder"))
        self.added: dict[str, AddedToken] = {}
        for t in spec.get("added_tokens") or ():
            self.added[t["content"]] = AddedToken(t)
        for t in extra:
            if t["content"] not in self.added:
                tid = t.get("id")
                if tid is None:
                    tid = self.model.vocab.get(t["content"])
                if tid is None:
                    top = max((a.id for a in self.added.values()), default=-1)
                    tid = max(len(self.model.vocab), top + 1)
                self.added[t["content"]] = AddedToken({**t, "id": tid})
        self.id_to_added = {a.id: a for a in self.added.values()}
        self.id_to_piece = {i: s for s, i in self.model.vocab.items()}
        self.special = {a.content for a in self.added.values() if a.special}
        self.vocab_size = len({**self.model.vocab, **{a.content: a.id
                                                      for a in self.added.values()}})
        # non-normalized tokens match the raw text; normalized ones match the
        # normalized text by their normalized content, as the crate does
        self._raw = self._matcher({a.content: a for a in self.added.values()
                                   if not a.normalized})
        norm = self.normalizer or (lambda text: text)
        self._norm = self._matcher({norm(a.content): a for a in self.added.values()
                                    if a.normalized})

    @staticmethod
    def _matcher(tokens: dict[str, AddedToken]):
        """(pattern, content -> token): leftmost-longest over the contents,
        an alternation, longest first, taking at each position the longest
        that matches there; None with no tokens."""
        if not tokens:
            return None
        alts = sorted(tokens, key=lambda s: (-len(s), s))
        return re.compile("|".join(re.escape(a) for a in alts)), tokens

    def token_to_id(self, token: str) -> Optional[int]:
        a = self.added.get(token)
        return a.id if a is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        a = self.id_to_added.get(tid)
        return a.content if a is not None else self.id_to_piece.get(tid)

    @staticmethod
    def _find_added(text: str, matcher) -> list[tuple[int, int, Optional[int]]]:
        """AddedVocabulary::find_matches: (start, end, id or None) spans
        covering `text`."""
        if matcher is None:
            return [(0, len(text), None)]
        rx, tokens = matcher
        out, start = [], 0
        for m in rx.finditer(text):
            a, b = m.span()
            tok = tokens[m.group(0)]
            if tok.single_word and not ((a == 0 or not _is_word(text[a - 1]))
                                        and (b == len(text) or not _is_word(text[b]))):
                continue
            if tok.lstrip:
                k = a
                while k > 0 and text[k - 1] in _WHITE_SPACE:
                    k -= 1
                a = max(k, start)
            if tok.rstrip:
                while b < len(text) and text[b] in _WHITE_SPACE:
                    b += 1
            if start < a:
                out.append((start, a, None))
            out.append((a, b, tok.id))
            start = b
        if start < len(text):
            out.append((start, len(text), None))
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for a, b, tid in self._find_added(text, self._raw):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[a:b]
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for c, d, tid2 in self._find_added(piece, self._norm):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                start = a + c
                for word, _ in self.pre_tokenizer([(piece[c:d], start)]):
                    ids += self.model.tokenize(word)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
