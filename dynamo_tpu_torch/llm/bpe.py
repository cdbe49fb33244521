"""A byte-level BPE tokenizer read from a HuggingFace ``tokenizer.json``, in
pure Python with the standard library only — the port's stand-in for the
``tokenizers`` package, which the card's machine does not have.

It reads these forms, and raises ``ValueError`` naming anything else:

- model ``BPE``: merges as ``"a b"`` strings or ``[a, b]`` pairs,
  ``ignore_merges`` (a whole pre-token found in the vocabulary is one id);
  ``dropout`` and ``unk_token`` null, ``byte_fallback`` false,
  ``continuing_subword_prefix`` / ``end_of_word_suffix`` null or empty;
- normalizer null, ``NFC``, or a ``Sequence`` of those;
- pre-tokenizer ``ByteLevel`` (``add_prefix_space``; ``use_regex`` with the
  GPT-2 pattern), ``Split`` (a ``Regex`` or ``String`` pattern, behavior
  ``Isolated``, ``invert`` false), or a ``Sequence`` of those;
- decoder ``ByteLevel``; post-processor null, ``ByteLevel``,
  ``TemplateProcessing`` or a ``Sequence`` of those (a template only with
  ``add_special_tokens=False``, which is all the pipeline passes);
- added tokens with ``special``, ``single_word``, ``lstrip``, ``rstrip``
  and ``normalized``, split out of the text before the pre-tokenizer.

Each step follows the Rust crate's code (tokenizers 0.22: ``models/bpe``,
``added_vocabulary.rs``, ``pre_tokenizers/byte_level.rs``,
``normalizer.rs``'s split, ``decoders/byte_level.rs``): added tokens are
matched leftmost-longest on the raw text (``normalized`` false) and then on
each normalized piece; empty pieces are dropped; BPE merges the lowest
(rank, position) pair first; an id that is in neither the vocabulary nor
the added tokens decodes to nothing.

The pre-tokenizers' patterns are Oniguruma regexes. ``translate_regex``
rewrites one for ``re``: ``\\p{..}`` / ``\\P{..}`` and ``\\s`` / ``\\S``
become explicit code-point classes built once per process from
``unicodedata`` (``\\s`` is Unicode White_Space, as in Oniguruma, not
``re``'s ``str.isspace``), inside and outside bracket classes; a construct
the translator does not know raises. The matches are iterated as the
``onig`` crate does (an empty match right after the previous one is
skipped). Results can differ from the Rust crate only at code points that
this Python's Unicode tables and Oniguruma's classify differently.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# -- byte level ----------------------------------------------------------------


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character map (byte_level.rs bytes_char)."""
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAC + 1)) \
        + list(range(0xAE, 0xFF + 1))
    out, n = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + n)
            n += 1
    return out


BYTES_CHAR = _bytes_to_unicode()
CHAR_BYTES = {c: b for b, c in BYTES_CHAR.items()}
_BYTE_TABLE = [BYTES_CHAR[b] for b in range(256)]

# ByteLevel's own split (byte_level.rs RE), used when use_regex is true.
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"

# -- Unicode classes -------------------------------------------------------------

# Unicode's White_Space property: Oniguruma's \s and Rust's char::is_whitespace.
WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
               (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
               (0x3000, 0x3000))
_WHITE_SPACE_CHARS = frozenset(chr(c) for a, b in WHITE_SPACE for c in range(a, b + 1))

_CATEGORY_RANGES: Optional[Dict[str, List[Tuple[int, int]]]] = None


def category_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """Code-point ranges of every general category and of each major class
    ("L", "N", ...), from one scan of ``unicodedata`` (built once per
    process, at the first pattern that needs it)."""
    global _CATEGORY_RANGES
    if _CATEGORY_RANGES is None:
        category = unicodedata.category
        runs = []  # (first code point, category) where the category changes
        last = None
        for cp in range(0x110000):
            cat = category(chr(cp))
            if cat != last:
                runs.append((cp, cat))
                last = cat
        out: Dict[str, List[Tuple[int, int]]] = {}
        for (a, cat), (b, _) in zip(runs, runs[1:] + [(0x110000, "")]):
            for key in (cat, cat[0]):
                r = out.setdefault(key, [])
                if r and r[-1][1] == a - 1:
                    r[-1] = (r[-1][0], b - 1)
                else:
                    r.append((a, b - 1))
        _CATEGORY_RANGES = out
    return _CATEGORY_RANGES


def _class_body(ranges: Sequence[Tuple[int, int]]) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges)


def _property_body(name: str) -> str:
    table = category_ranges()
    if name not in table or len(name) > 2:
        raise ValueError(f"regex property \\p{{{name}}} is not supported")
    return _class_body(table[name])


_SIMPLE_ESCAPES = set("rntfv\\.^$|?*+()[]{}/-'\" #&~,:;<=>!@%`_")


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern from a ``tokenizer.json`` rewritten for ``re``
    (see the module's docstring); raises ``ValueError`` on what it does
    not know."""
    out: List[str] = []
    i, n = 0, len(pattern)

    def escape_at(j: int, in_class: bool) -> Tuple[str, int]:
        """The translation of the escape at pattern[j] == '\\' and the index
        after it."""
        if j + 1 >= n:
            raise ValueError("regex ends with a lone backslash")
        c = pattern[j + 1]
        if c in "pP":
            if j + 2 >= n or pattern[j + 2] != "{":
                raise ValueError(f"regex escape \\{c} without braces is not supported")
            end = pattern.find("}", j + 3)
            if end < 0:
                raise ValueError("regex property escape is not closed")
            negate = c == "P"
            body = _property_body(pattern[j + 3:end])
            if in_class:
                if negate:
                    raise ValueError("a negated property inside a bracket class is not supported")
                return body, end + 1
            return f"[{'^' if negate else ''}{body}]", end + 1
        if c in "sS":
            body = _class_body(WHITE_SPACE)
            if in_class:
                if c == "S":
                    raise ValueError("\\S inside a bracket class is not supported")
                return body, j + 2
            return f"[{'^' if c == 'S' else ''}{body}]", j + 2
        if c in _SIMPLE_ESCAPES:
            return "\\" + c, j + 2
        raise ValueError(f"regex escape \\{c} is not supported")

    while i < n:
        c = pattern[i]
        if c == "\\":
            piece, i = escape_at(i, in_class=False)
            out.append(piece)
        elif c == "[":
            j = i + 1
            parts = ["["]
            if j < n and pattern[j] == "^":
                parts.append("^")
                j += 1
            first = True
            while True:
                if j >= n:
                    raise ValueError("regex bracket class is not closed")
                d = pattern[j]
                if d == "]" and not first:
                    break
                if d == "\\":
                    piece, j = escape_at(j, in_class=True)
                    parts.append(piece)
                elif d == "[" or pattern.startswith("&&", j):
                    raise ValueError("nested bracket classes and class intersections are "
                                     "not supported")
                elif d == "]":
                    parts.append("\\]")
                    j += 1
                else:
                    parts.append(d)
                    j += 1
                first = False
            parts.append("]")
            out.append("".join(parts))
            i = j + 1
        elif c == "(":
            if pattern.startswith("(?", i):
                for head in ("(?:", "(?=", "(?!", "(?<=", "(?<!", "(?>", "(?i:"):
                    if pattern.startswith(head, i):
                        out.append(head)
                        i += len(head)
                        break
                else:
                    raise ValueError(f"regex group {pattern[i:i + 4]!r} is not supported")
            else:
                out.append(c)
                i += 1
        elif c in "^$":
            raise ValueError(f"regex anchor {c!r} is not supported")
        else:
            out.append(c)
            i += 1
    return "".join(out)


def compile_regex(pattern: str) -> "re.Pattern[str]":
    try:
        return re.compile(translate_regex(pattern))
    except re.error as exc:  # e.g. a lookbehind of varying width
        raise ValueError(f"regex {pattern!r} does not compile for re: {exc}") from exc


def find_spans(regex: "re.Pattern[str]", text: str) -> List[Tuple[int, int]]:
    """(start, end) of each match, iterated as the onig crate's find_iter
    does: an empty match that starts where the previous match ended is
    skipped and the search moves on one character."""
    spans: List[Tuple[int, int]] = []
    pos, last_end = 0, None
    n = len(text)
    while pos <= n:
        m = regex.search(text, pos)
        if m is None:
            break
        s, e = m.span()
        if s == e and s == last_end:
            pos += 1
            continue
        spans.append((s, e))
        pos = last_end = e
    return spans


def split_isolated(regex: "re.Pattern[str]", text: str) -> List[str]:
    """``SplitDelimiterBehavior::Isolated``: every match and every span
    between matches is a piece; empty pieces are dropped."""
    pieces: List[str] = []
    prev = 0
    for s, e in find_spans(regex, text):
        if prev != s:
            pieces.append(text[prev:s])
        pieces.append(text[s:e])
        prev = e
    if prev != len(text):
        pieces.append(text[prev:])
    return [p for p in pieces if p]


# -- components ------------------------------------------------------------------


def _check_keys(kind: str, obj: Dict[str, Any], allowed: Sequence[str]) -> None:
    extra = sorted(set(obj) - set(allowed))
    if extra:
        raise ValueError(f"{kind}: unsupported field(s) {extra}")


def _normalizer(spec: Optional[Dict[str, Any]]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC":
        _check_keys("normalizer NFC", spec, ("type",))
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Sequence":
        _check_keys("normalizer Sequence", spec, ("type", "normalizers"))
        steps = [_normalizer(s) for s in spec["normalizers"]]
        steps = [s for s in steps if s is not None]

        def run(s: str) -> str:
            for step in steps:
                s = step(s)
            return s

        return run
    raise ValueError(f"normalizer {kind!r} is not supported (null, NFC or a Sequence of NFC)")


def _byte_level_map(piece: str) -> str:
    return "".join(_BYTE_TABLE[b] for b in piece.encode("utf-8"))


def _pre_tokenizer(spec: Optional[Dict[str, Any]]) -> Callable[[List[str]], List[str]]:
    """A function from the pieces so far to the pieces after this step."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "ByteLevel":
        _check_keys("pre_tokenizer ByteLevel", spec,
                    ("type", "add_prefix_space", "trim_offsets", "use_regex"))
        prefix = bool(spec.get("add_prefix_space", True))
        regex = compile_regex(GPT2_PATTERN) if spec.get("use_regex", True) else None

        def byte_level(pieces: List[str]) -> List[str]:
            out: List[str] = []
            for p in pieces:
                if prefix and not p.startswith(" "):
                    p = " " + p
                parts = split_isolated(regex, p) if regex is not None else [p]
                out.extend(_byte_level_map(q) for q in parts if q)
            return out

        return byte_level
    if kind == "Split":
        _check_keys("pre_tokenizer Split", spec, ("type", "pattern", "behavior", "invert"))
        if spec.get("behavior") != "Isolated":
            raise ValueError(f"pre_tokenizer Split behavior {spec.get('behavior')!r} is not "
                             "supported (Isolated only)")
        if spec.get("invert"):
            raise ValueError("pre_tokenizer Split invert=true is not supported")
        pat = spec.get("pattern") or {}
        if set(pat) == {"Regex"}:
            regex = compile_regex(pat["Regex"])
        elif set(pat) == {"String"}:
            regex = re.compile(re.escape(pat["String"]))
        else:
            raise ValueError(f"pre_tokenizer Split pattern {pat!r} is not supported")
        return lambda pieces: [q for p in pieces for q in split_isolated(regex, p)]
    if kind == "Sequence":
        _check_keys("pre_tokenizer Sequence", spec, ("type", "pretokenizers"))
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces: List[str]) -> List[str]:
            for step in steps:
                pieces = step(pieces)
            return pieces

        return run
    raise ValueError(f"pre_tokenizer {kind!r} is not supported (ByteLevel, Split or a Sequence)")


# Characters that make a word for an added token's single_word check: Rust
# regex-syntax's is_word_character (Unicode \w: Alphabetic, marks, decimal
# digits, connector punctuation, Join_Control). Alphabetic is the letters,
# Nl and Other_Alphabetic, whose members outside the marks are the circled
# and squared Latin letters listed here.
_WORD_CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "Pc")
_WORD_EXTRA = ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
               (0x1F170, 0x1F189))


def _is_word_char(ch: str) -> bool:
    if unicodedata.category(ch) in _WORD_CATEGORIES:
        return True
    cp = ord(ch)
    return any(a <= cp <= b for a, b in _WORD_EXTRA)


class _AddedVocabulary:
    """``added_tokens`` of a tokenizer.json (added_vocabulary.rs)."""

    FIELDS = ("id", "content", "single_word", "lstrip", "rstrip", "normalized", "special")

    def __init__(self, entries: List[Dict[str, Any]], vocab: Dict[str, int],
                 normalizer: Optional[Callable[[str], str]]) -> None:
        self.by_content: Dict[str, int] = {}
        self.by_id: Dict[int, Dict[str, Any]] = {}
        self.special: set = set()
        raw: List[str] = []
        normed: Dict[str, int] = {}
        for e in entries:
            _check_keys("added token", e, self.FIELDS)
            content = e["content"]
            if not content:
                continue
            if content in self.by_content:
                raise ValueError(f"added token {content!r} is listed twice")
            # AddedVocabulary::add_tokens: a token already in the vocabulary
            # keeps its id; another takes the vocabulary's size, or one past
            # the largest added id once that reaches it.
            if content in vocab:
                tid = vocab[content]
            else:
                top = max(self.by_id, default=None)
                tid = len(vocab) if top is None or (top < len(vocab) and vocab) else top + 1
            if e.get("id") is not None and e["id"] != tid:
                raise ValueError(f"added token {content!r} has id {e['id']} in the file but "
                                 f"would be given {tid}")
            tok = {k: bool(e.get(k, False)) for k in ("single_word", "lstrip", "rstrip",
                                                      "normalized", "special")}
            tok["content"] = content
            self.by_content[content] = tid
            self.by_id[tid] = tok
            if tok["special"]:
                self.special.add(content)
            if tok["normalized"]:
                key = normalizer(content) if normalizer is not None else content
                normed.setdefault(key, tid)
            else:
                raw.append(content)
        self._raw = self._alternation(raw)
        self._normed = self._alternation(list(normed))
        self._normed_ids = normed

    @staticmethod
    def _alternation(contents: List[str]) -> Optional["re.Pattern[str]"]:
        """Leftmost-longest matching (the crate's Aho-Corasick with
        MatchKind::LeftmostLongest): at the earliest position the first
        alternative that matches wins, so the longest go first."""
        if not contents:
            return None
        ordered = sorted(contents, key=len, reverse=True)
        return re.compile("|".join(re.escape(c) for c in ordered))

    def _find(self, text: str, regex: Optional["re.Pattern[str]"],
              ids: Dict[str, int]) -> List[Tuple[str, Optional[int]]]:
        """AddedVocabulary::find_matches + split_with_indices on one piece."""
        if regex is None or not text:
            return [(text, None)]
        spans: List[Tuple[Optional[int], int, int]] = []
        start_offset = 0
        n = len(text)
        for m in regex.finditer(text):
            start, stop = m.span()
            tid = ids[m.group(0)]
            tok = self.by_id[tid]
            if tok["single_word"]:
                start_space = start == 0 or not _is_word_char(text[start - 1])
                stop_space = stop == n or not _is_word_char(text[stop])
                if not (start_space and stop_space):
                    continue
            if tok["lstrip"]:
                k = start
                while k > 0 and text[k - 1] in _WHITE_SPACE_CHARS:
                    k -= 1
                start = max(k, start_offset)
            if tok["rstrip"]:
                while stop < n and text[stop] in _WHITE_SPACE_CHARS:
                    stop += 1
            if start > start_offset:
                spans.append((None, start_offset, start))
            spans.append((tid, start, stop))
            start_offset = stop
        if start_offset != n:
            spans.append((None, start_offset, n))
        return [(text[s:e], tid) for tid, s, e in spans]

    def split(self, text: str,
              normalizer: Optional[Callable[[str], str]]) -> List[Tuple[str, Optional[int]]]:
        """The text as pieces: (content, id) for each added token found and
        (normalized text, None) between them; empty pieces dropped."""
        out: List[Tuple[str, Optional[int]]] = []
        for piece, tid in self._find(text, self._raw, self.by_content):
            if tid is not None:
                out.append((piece, tid))
                continue
            if normalizer is not None:
                piece = normalizer(piece)
            out.extend(self._find(piece, self._normed, self._normed_ids))
        return [(p, t) for p, t in out if p]


class _BPE:
    """``models/bpe``: merges by rank over one pre-token's characters."""

    FIELDS = ("type", "dropout", "unk_token", "continuing_subword_prefix", "end_of_word_suffix",
              "fuse_unk", "byte_fallback", "ignore_merges", "vocab", "merges")
    CACHE_CAPACITY = 10_000  # the crate's DEFAULT_CACHE_CAPACITY
    CACHE_MAX_LENGTH = 256  # words at least this long are not cached (MAX_LENGTH)

    def __init__(self, spec: Dict[str, Any]) -> None:
        if spec.get("type") != "BPE":
            raise ValueError(f"model {spec.get('type')!r} is not supported (BPE only)")
        _check_keys("model BPE", spec, self.FIELDS)
        for key in ("dropout", "unk_token"):
            if spec.get(key) is not None:
                raise ValueError(f"model BPE {key}={spec[key]!r} is not supported (null only)")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise ValueError(f"model BPE {key}={spec[key]!r} is not supported (null only)")
        if spec.get("byte_fallback"):
            raise ValueError("model BPE byte_fallback=true is not supported")
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.vocab_r: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges") or []):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"model BPE merge {m!r} is not two tokens")
                a, b = parts
            elif isinstance(m, (list, tuple)) and len(m) == 2:
                a, b = m
            else:
                raise ValueError(f"model BPE merge {m!r} is not supported")
            for t in (a, b, a + b):
                if t not in self.vocab:
                    raise ValueError(f"model BPE merge {a!r} {b!r}: {t!r} is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return [tid]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = self._merge_word(word)
        if len(word) < self.CACHE_MAX_LENGTH and len(self._cache) < self.CACHE_CAPACITY:
            self._cache[word] = ids
        return ids

    def _merge_word(self, word: str) -> List[int]:
        """Word::merge_all: a heap of (rank, position) merges; an entry
        whose pair changed since it was pushed is skipped."""
        vocab, merges = self.vocab, self.merges
        ids = [vocab[c] for c in word if c in vocab]  # unknown characters are dropped
        n = len(ids)
        if n < 2:
            return ids
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] < n:
                prev[nxt[right]] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((ids[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            q = nxt[pos]
            if q < n:
                m = merges.get((new_id, ids[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]


def _decoder(spec: Optional[Dict[str, Any]]) -> Callable[[List[str]], str]:
    if spec is None or spec.get("type") != "ByteLevel":
        raise ValueError(f"decoder {None if spec is None else spec.get('type')!r} is not "
                         "supported (ByteLevel only)")
    _check_keys("decoder ByteLevel", spec,
                ("type", "add_prefix_space", "trim_offsets", "use_regex"))

    def decode(tokens: List[str]) -> str:
        """decoders/byte_level.rs: a token whose characters all map to
        bytes becomes those bytes, any other its UTF-8; bad bytes read as
        U+FFFD (String::from_utf8_lossy)."""
        buf = bytearray()
        for t in tokens:
            try:
                buf += bytes([CHAR_BYTES[c] for c in t])
            except KeyError:
                buf += t.encode("utf-8")
        return buf.decode("utf-8", "replace")

    return decode


def _adds_special_tokens(spec: Optional[Dict[str, Any]]) -> bool:
    """Whether a post-processor adds tokens when asked to: ByteLevel only
    trims offsets, TemplateProcessing adds its template's tokens (Llama-3
    chains the two in a Sequence)."""
    if spec is None:
        return False
    kind = spec.get("type")
    if kind == "Sequence":
        return any([_adds_special_tokens(p) for p in spec.get("processors") or []])
    if kind not in ("ByteLevel", "TemplateProcessing"):
        raise ValueError(f"post_processor {kind!r} is not supported")
    return kind == "TemplateProcessing"


class BpeTokenizer:
    """The ``tokenizers.Tokenizer`` calls the port makes: ``encode``,
    ``decode``, ``token_to_id`` and ``get_vocab_size``."""

    FIELDS = ("version", "truncation", "padding", "added_tokens", "normalizer", "pre_tokenizer",
              "post_processor", "decoder", "model")

    def __init__(self, spec: Dict[str, Any]) -> None:
        _check_keys("tokenizer.json", spec, self.FIELDS)
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"{key} is not supported (null only)")
        self._adds_tokens = _adds_special_tokens(spec.get("post_processor"))
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        self.model = _BPE(spec.get("model") or {})
        self.added = _AddedVocabulary(spec.get("added_tokens") or [], self.model.vocab,
                                      self._normalize)

    @classmethod
    def from_str(cls, text: str) -> "BpeTokenizer":
        return cls(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "BpeTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        if add_special_tokens and self._adds_tokens:
            raise ValueError("add_special_tokens=True with a TemplateProcessing post_processor "
                             "is not supported")
        ids: List[int] = []
        for piece, tid in self.added.split(text, self._normalize):
            if tid is not None:
                ids.append(tid)
                continue
            for word in self._pre_tokenize([piece]):
                ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens: List[str] = []
        added, vocab_r, special = self.added.by_id, self.model.vocab_r, self.added.special
        for i in ids:
            tok = added.get(i)
            t = tok["content"] if tok is not None else vocab_r.get(i)
            if t is None or (skip_special_tokens and t in special):
                continue
            tokens.append(t)
        return self._decode(tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.by_content.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def get_vocab_size(self) -> int:
        """With the added tokens (the crate's get_vocab_size(true): the
        vocabulary and the added tokens joined by content)."""
        return len(self.model.vocab.keys() | self.added.by_content.keys())
