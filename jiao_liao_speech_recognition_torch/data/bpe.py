"""Byte-level BPE tokenizer (Whisper vocab format), the port's own copy of
the JAX package's ``data/bpe.py`` (whose package ``__init__`` imports jax).

Loads the HF Whisper tokenizer files (vocab.json + merges.txt, GPT-2
byte-level BPE with added special tokens), pretokenizes with a state
machine equivalent to the GPT-2 regex (unicodedata category checks in place
of the `regex` package's \\p classes), and runs the lowest-rank-first merge
loop in Python (the JAX package's C++ merge runtime is not carried over).
``tests/test_torch_whisper.py`` pins encode and decode to the JAX module.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode printable mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _cat(ch: str) -> str:
    return unicodedata.category(ch)


def gpt2_pretokenize(text: str) -> List[str]:
    """Split like the GPT-2 regex
    `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`
    using unicodedata categories (no `regex` dependency)."""
    out: List[str] = []
    i, n = 0, len(text)
    contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
    while i < n:
        ch = text[i]
        # contractions
        if ch == "'":
            for c in contractions:
                if text.startswith(c, i):
                    out.append(c)
                    i += len(c)
                    break
            else:
                # fall through to "other" run below
                j = i + 1
                while j < n and not text[j].isspace() and not _is_letter(text[j]) and not _is_number(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
            continue
        # optional leading space + letters / numbers / other
        if ch == " " and i + 1 < n:
            nxt = text[i + 1]
            if _is_letter(nxt):
                j = i + 2
                while j < n and _is_letter(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
                continue
            if _is_number(nxt):
                j = i + 2
                while j < n and _is_number(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
                continue
            if not nxt.isspace() and nxt != "'":
                j = i + 2
                while j < n and not text[j].isspace() and not _is_letter(text[j]) and not _is_number(text[j]):
                    j += 1
                out.append(text[i:j])
                i = j
                continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
            continue
        if _is_number(ch):
            j = i + 1
            while j < n and _is_number(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
            continue
        if ch.isspace():
            j = i + 1
            while j < n and text[j].isspace():
                j += 1
            # `\s+(?!\S)` vs `\s+`: trailing space before a non-space sticks
            # to the next token (handled by the ' ?' branches above), so a
            # whitespace run keeps its last char only at end-of-text
            if j < n and not text[j].isspace():
                pass
            if j < n and (j - i) > 1:
                out.append(text[i : j - 1])
                i = j - 1
            else:
                out.append(text[i:j])
                i = j
            continue
        # other symbol run
        j = i + 1
        while j < n and not text[j].isspace() and not _is_letter(text[j]) and not _is_number(text[j]) and text[j] != "'":
            j += 1
        out.append(text[i:j])
        i = j
    return out


def _is_letter(ch: str) -> bool:
    return _cat(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return _cat(ch).startswith("N")


class ByteLevelBPE:
    """GPT-2-style byte-level BPE codec over HF vocab.json + merges.txt."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        special_tokens: Optional[Dict[str, int]] = None,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.special = dict(special_tokens or {})
        self.inv_special = {v: k for k, v in self.special.items()}
        self._b2u = bytes_to_unicode()
        self._u2b = {v: k for k, v in self._b2u.items()}

    # ------------------------------------------------------------------ load
    @classmethod
    def from_hf_dir(cls, path: str | Path) -> "ByteLevelBPE":
        """Load from an HF tokenizer directory (vocab.json, merges.txt,
        added_tokens.json / special ids inside vocab)."""
        p = Path(path)
        vocab = json.loads((p / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for line in (p / "merges.txt").read_text(encoding="utf-8").splitlines():
            if line.startswith("#") or not line.strip():
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
        special: Dict[str, int] = {}
        added = p / "added_tokens.json"
        if added.exists():
            special.update(json.loads(added.read_text(encoding="utf-8")))
        # Whisper convention: specials look like <|...|>
        special.update({k: v for k, v in vocab.items() if k.startswith("<|")})
        return cls(vocab, merges, special)

    def save_hf_dir(self, path: str | Path) -> None:
        """Write the files ``from_hf_dir`` reads: vocab.json, merges.txt (in
        rank order) and, for specials outside the vocab, added_tokens.json."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        (p / "vocab.json").write_text(json.dumps(self.vocab, ensure_ascii=False),
                                      encoding="utf-8")
        merges = sorted(self.ranks, key=self.ranks.get)
        (p / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
        added = {k: v for k, v in self.special.items() if k not in self.vocab}
        if added:
            (p / "added_tokens.json").write_text(json.dumps(added, ensure_ascii=False),
                                                 encoding="utf-8")

    # ----------------------------------------------------------------- codec
    def _bpe_merge(self, symbols: List[str]) -> List[str]:
        """Lowest-rank-first pair merging."""
        if len(symbols) < 2:
            return symbols
        while True:
            best = None
            best_rank = None
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                return symbols
            a, b = symbols[best], symbols[best + 1]
            out = []
            i = 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == a and symbols[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = out

    def encode(self, text: str, allow_special: bool = True) -> List[int]:
        """Encode text -> ids. Special tokens (``<|...|>``) appearing
        verbatim in the input map to their reserved ids instead of being
        BPE-merged as ordinary text; allow_special=False treats them as
        plain text (the safe mode for untrusted transcripts)."""
        if allow_special and self.special:
            rx = self._special_regex()
            ids: List[int] = []
            for part in rx.split(text):
                if not part:
                    continue
                if part in self.special:
                    ids.append(self.special[part])
                else:
                    ids.extend(self._encode_ordinary(part))
            return ids
        return self._encode_ordinary(text)

    def _special_regex(self):
        if getattr(self, "_special_rx", None) is None:
            import re

            pattern = "|".join(
                re.escape(s) for s in sorted(self.special, key=len, reverse=True)
            )
            self._special_rx = re.compile(f"({pattern})")
        return self._special_rx

    def _encode_ordinary(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in gpt2_pretokenize(text):
            mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            for piece in self._bpe_merge(list(mapped)):
                ids.append(self.vocab.get(piece, 0))
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        chunks: List[str] = []
        for i in ids:
            i = int(i)
            if i in self.inv_special:
                if not skip_special:
                    chunks.append(self.inv_special[i])
                continue
            tok = self.inv_vocab.get(i)
            if tok is not None:
                chunks.append(tok)
        text = "".join(chunks)
        data = bytes(self._u2b.get(c, ord("?")) for c in text)
        return data.decode("utf-8", errors="replace")

    def __len__(self) -> int:
        return len(self.vocab)
