"""jsonl manifests, the twin of the JAX package's ``data/manifest.py``.

Row schema: {"audio": path, "text": transcript, "duration": seconds,
"dialect": name}.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Sequence


@dataclass
class ManifestRow:
    audio: str
    text: str
    duration: float = 0.0
    dialect: str = ""

    def to_json(self) -> str:
        return json.dumps(
            {"audio": self.audio, "text": self.text, "duration": self.duration,
             "dialect": self.dialect},
            ensure_ascii=False,
        )


@dataclass
class Manifest:
    rows: List[ManifestRow] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[ManifestRow]:
        return iter(self.rows)

    def filter_duration(self, min_s: float, max_s: float) -> "Manifest":
        return Manifest([r for r in self.rows if min_s <= r.duration <= max_s])

    def texts(self) -> List[str]:
        return [r.text for r in self.rows]

    def dialects(self) -> List[str]:
        """The rows' dialect names, each once, sorted."""
        return sorted({r.dialect for r in self.rows})


def read_manifest(path: str | Path) -> Manifest:
    rows = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            rows.append(
                ManifestRow(
                    audio=d["audio"],
                    text=d.get("text", ""),
                    duration=float(d.get("duration", 0.0)),
                    dialect=d.get("dialect", ""),
                )
            )
    return Manifest(rows)


def write_manifest(rows: Sequence[ManifestRow], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        for r in rows:
            fh.write(r.to_json() + "\n")
