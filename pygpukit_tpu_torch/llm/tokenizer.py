"""Tokenizer over a Hugging Face ``tokenizer.json`` (counterpart of
``pygpukit_tpu/llm/tokenizer.py``).

As in the reference, the HF ``tokenizers`` runtime serves where it imports,
and a byte-level BPE of the same file format (``_ByteLevelBPE``) where it
does not: the package's dependency rule, not a device fallback. The
byte-level BPE splits text as GPT-2's pre-tokenizer pattern does
(``_split_words``) and decodes a run of tokens as one byte string, so it
gives the HF runtime's ids and text on byte-level BPE files; the
reference's own BPE splits on spaces only and decodes token by token (see
ROADMAP, known faults of the reference).
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path


class Tokenizer:
    def __init__(self, path: str):
        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        self.path = str(p)
        self._hf = None
        self._bpe = None
        try:
            from tokenizers import Tokenizer as HFTokenizer
        except ImportError:
            self._bpe = _ByteLevelBPE(self.path)
        else:
            self._hf = HFTokenizer.from_file(self.path)

    def encode(self, text: str) -> list[int]:
        if self._hf is not None:
            return self._hf.encode(text).ids
        return self._bpe.encode(text)

    def decode(self, ids: list[int]) -> str:
        if self._hf is not None:
            return self._hf.decode(ids, skip_special_tokens=False)
        return self._bpe.decode(ids)

    @property
    def vocab_size(self) -> int:
        if self._hf is not None:
            return self._hf.get_vocab_size()
        return len(self._bpe.vocab.keys() | self._bpe.added.keys())

    def token_to_id(self, token: str) -> int | None:
        if self._hf is not None:
            return self._hf.token_to_id(token)
        return self._bpe.vocab.get(token, self._bpe.added.get(token))


def _bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte -> printable character table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class _ByteLevelBPE:
    """Byte-level BPE over a tokenizer.json's vocab, merges and added
    tokens."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        self.vocab: dict[str, int] = model["vocab"]
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(model.get("merges", [])):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            self.merge_ranks[pair] = i
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.added = {t["content"]: t["id"] for t in data.get("added_tokens", [])}

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.merge_ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts = parts[:best] + [parts[best] + parts[best + 1]] + parts[best + 2:]
        return parts

    def encode(self, text: str) -> list[int]:
        # added (special) tokens first, longest first
        segments: list = [text]
        for tok in sorted(self.added, key=len, reverse=True):
            new_segments = []
            for seg in segments:
                if isinstance(seg, int):
                    new_segments.append(seg)
                    continue
                while tok in seg:
                    pre, _, seg = seg.partition(tok)
                    if pre:
                        new_segments.append(pre)
                    new_segments.append(self.added[tok])
                if seg:
                    new_segments.append(seg)
            segments = new_segments
        ids: list[int] = []
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
                continue
            for word in _split_words(seg):
                mapped = "".join(self.byte_enc[b] for b in word.encode("utf-8"))
                for piece in self._bpe_word(mapped):
                    if piece in self.vocab:
                        ids.append(self.vocab[piece])
        return ids

    def decode(self, ids: list[int]) -> str:
        """Each run of vocabulary tokens as one byte string (a character
        split over tokens decodes whole), added tokens as their text."""
        inv_added = {v: k for k, v in self.added.items()}
        out: list[str] = []
        run = bytearray()
        for i in ids:
            if i in inv_added:
                out.append(run.decode("utf-8", errors="replace"))
                run.clear()
                out.append(inv_added[i])
            elif i in self.inv_vocab:
                run.extend(self.byte_dec.get(c, ord(" ")) for c in self.inv_vocab[i])
        out.append(run.decode("utf-8", errors="replace"))
        return "".join(out)


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _kind(ch: str) -> str:
    """"space", "letter", "number" or "other", the classes of GPT-2's
    pre-tokenizer pattern."""
    if ch.isspace():
        return "space"
    cat = unicodedata.category(ch)[0]
    return {"L": "letter", "N": "number"}.get(cat, "other")


def _split_words(text: str) -> list[str]:
    """``text`` split as GPT-2's pattern splits it (HF's ByteLevel
    pre-tokenizer): ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, tried in that order at each
    position."""
    words: list[str] = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == "'":
            suffix = next((s for s in _CONTRACTIONS if text.startswith(s, i + 1)), None)
            if suffix is not None:
                words.append(text[i:i + 1 + len(suffix)])
                i += 1 + len(suffix)
                continue
        start = i
        if text[i] == " " and i + 1 < n and _kind(text[i + 1]) != "space":
            i += 1                              # the optional leading space
        kind = _kind(text[i])
        if kind != "space":
            while i < n and _kind(text[i]) == kind:
                i += 1
            words.append(text[start:i])
            continue
        j = i
        while j < n and text[j].isspace():
            j += 1
        # \s+(?!\S): all of a run that ends the text, else all but its last
        # character, which a following word may take as its leading space;
        # a lone whitespace character before a non-space is \s+ alone
        if j < n and j - i > 1:
            j -= 1
        words.append(text[i:j])
        i = j
    return words
