"""Character tokenizer for the Mandarin CTC path, the twin of the JAX
package's ``data/tokenizer.py`` (which cannot be imported without jax).
Reads and writes the same ``vocab.json``: id 0 = CTC blank, id 1 = unk,
then the corpus characters."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

BLANK = "<blank>"
UNK = "<unk>"


class CharTokenizer:
    def __init__(self, vocab: Sequence[str]):
        if list(vocab[:2]) != [BLANK, UNK]:
            vocab = [BLANK, UNK] + [v for v in vocab if v not in (BLANK, UNK)]
        self.vocab: List[str] = list(vocab)
        self.to_id: Dict[str, int] = {c: i for i, c in enumerate(self.vocab)}

    @classmethod
    def build(cls, texts: Iterable[str]) -> "CharTokenizer":
        chars = sorted({c for t in texts for c in t if not c.isspace()})
        return cls([BLANK, UNK] + chars)

    @classmethod
    def load(cls, path: str | Path) -> "CharTokenizer":
        with open(path, encoding="utf-8") as fh:
            return cls(json.load(fh)["vocab"])

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"vocab": self.vocab}, fh, ensure_ascii=False)

    @property
    def blank_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 1

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        return [self.to_id.get(c, 1) for c in text if not c.isspace()]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids if 0 <= i < len(self.vocab) and i > 1)
