"""SRT / WebVTT captions from per-token timestamp spans, the twin of the
JAX package's ``utils/captions.py`` (``transcribe --timestamps`` and
``--caption srt|vtt``).

Tokens accumulate into one cue until a silence gap, a duration ceiling or
a line-length ceiling (in characters: Mandarin has no spaces) splits them.
Word spans use the segmentation WER scores (``evals/metrics.segment_words``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def group_cues(
    tokens: Sequence[Dict],
    max_gap: float = 0.6,
    max_dur: float = 5.0,
    max_chars: int = 16,
) -> List[Dict]:
    """[{'token','start','end'}] -> [{'start','end','text'}] cue list.

    Splits before a token when the silence since the previous token exceeds
    ``max_gap`` seconds, the cue would exceed ``max_dur`` seconds, or its
    text would exceed ``max_chars`` characters.
    """
    cues: List[Dict] = []
    cur: Dict = {}
    for t in tokens:
        if cur and (
            t["start"] - cur["end"] > max_gap
            or t["end"] - cur["start"] > max_dur
            or len(cur["text"]) + len(t["token"]) > max_chars
        ):
            cues.append(cur)
            cur = {}
        if not cur:
            cur = {"start": t["start"], "end": t["end"], "text": t["token"]}
        else:
            cur["end"] = t["end"]
            cur["text"] += t["token"]
    if cur:
        cues.append(cur)
    return cues


def group_words(tokens: Sequence[Dict]) -> List[Dict]:
    """[{'token','start','end'}] -> [{'word','start','end'}] word-level
    timestamps, using the eval harness's Mandarin segmentation (jieba when
    importable, else characters and Latin runs: evals/metrics.segment_words) so word
    boundaries match the ones WER scores. A word spanning several tokens
    takes the first token's start and the last's end; tokens merging into
    one word merge their spans. Falls back to per-token words if the
    segmenter does not exactly re-cover the text (it always does for jieba's
    default cut)."""
    from ..evals.metrics import segment_words

    text = "".join(t["token"] for t in tokens)
    if not text:
        return []
    owner: List[int] = []
    for i, t in enumerate(tokens):
        owner.extend([i] * len(t["token"]))
    segs = [w for w in segment_words(text) if w]
    if "".join(segs) != text:
        segs = [t["token"] for t in tokens if t["token"]]
    words: List[Dict] = []
    pos = 0
    for w in segs:
        first, last = owner[pos], owner[pos + len(w) - 1]
        words.append({
            "word": w,
            "start": tokens[first]["start"],
            "end": tokens[last]["end"],
        })
        pos += len(w)
    return words


def _stamp(seconds: float, decimal_sep: str) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{decimal_sep}{ms:03d}"


def format_srt(cues: Sequence[Dict]) -> str:
    """SubRip: 1-based index, comma decimal separator, blank-line separated."""
    blocks = []
    for i, c in enumerate(cues, 1):
        blocks.append(
            f"{i}\n{_stamp(c['start'], ',')} --> {_stamp(c['end'], ',')}\n"
            f"{c['text']}\n"
        )
    return "\n".join(blocks)


def format_vtt(cues: Sequence[Dict]) -> str:
    """WebVTT: WEBVTT header, dot decimal separator."""
    blocks = ["WEBVTT\n"]
    for c in cues:
        blocks.append(
            f"{_stamp(c['start'], '.')} --> {_stamp(c['end'], '.')}\n"
            f"{c['text']}\n"
        )
    return "\n".join(blocks)
