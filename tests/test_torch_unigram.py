"""The port's unigram tokenizer (data/unigram.py) against the JAX package's:
``train`` (the pieces and their scores), ``encode``, ``decode``, ``save``
/ ``load`` in both file formats, ``save_sp_vocab``, a bundle's unigram
vocab.json and ``cli train-unigram``'s output. Both modules are pure
Python on the same seeded texts; the scores are held bit for bit (the same
float operations in the same order), which no tolerance hides."""

import json

import numpy as np
import pytest

from jiao_liao_speech_recognition_tpu.data.unigram import UnigramTokenizer as JUni
from jiao_liao_speech_recognition_torch.data.unigram import UnigramTokenizer as TUni


def _texts(seed=0, n=60, alphabet=24):
    """Seeded Mandarin-like texts with recurring words, spaces included."""
    rng = np.random.RandomState(seed)
    words = ["".join(chr(0x4E00 + int(c)) for c in rng.randint(0, alphabet, rng.randint(1, 4)))
             for _ in range(30)]
    return [" ".join(words[i] for i in rng.randint(0, len(words), rng.randint(2, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("vocab_size,max_piece_len,em_iters", [(24, 3, 4), (64, 4, 4),
                                                               (200, 2, 2), (8, 4, 1)])
def test_train_gives_jaxs_pieces_and_scores(vocab_size, max_piece_len, em_iters):
    texts = _texts()
    want = JUni.train(texts, vocab_size=vocab_size, max_piece_len=max_piece_len,
                      em_iters=em_iters)
    got = TUni.train(texts, vocab_size=vocab_size, max_piece_len=max_piece_len,
                     em_iters=em_iters)
    assert got.vocab == want.vocab
    assert got.logprobs == want.logprobs  # bitwise: the same float ops in order
    assert got.max_len == want.max_len and len(got) == len(want)


def test_train_on_nothing_is_blank_and_unk():
    assert TUni.train(["", "  "]).vocab == JUni.train(["", "  "]).vocab == ["<blank>", "<unk>"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_decode_equal_jaxs(seed):
    texts = _texts(seed)
    want = JUni.train(texts, vocab_size=48, max_piece_len=3)
    got = TUni(want.vocab, want.logprobs)
    probes = _texts(seed + 10, n=20, alphabet=30) + ["", "▁a▁b", "未见过的字"]
    for t in probes:
        ids = got.encode(t)
        assert ids == want.encode(t), t
        assert got.decode(ids) == want.decode(ids)
    assert got.blank_id == 0 and got.unk_id == 1


def test_save_load_and_sp_vocab_round_trip_across_packages(tmp_path):
    tok = TUni.train(_texts(), vocab_size=40, max_piece_len=3)
    tok.save(tmp_path / "t.json")
    j = JUni.load(tmp_path / "t.json")
    assert (j.vocab, j.logprobs) == (tok.vocab, tok.logprobs)
    JUni(tok.vocab, tok.logprobs).save(tmp_path / "j.json")
    assert (tmp_path / "j.json").read_text(encoding="utf-8") == \
        (tmp_path / "t.json").read_text(encoding="utf-8")
    back = TUni.load(tmp_path / "j.json")
    assert (back.vocab, back.logprobs) == (tok.vocab, tok.logprobs)
    tok.save_sp_vocab(tmp_path / "t.tsv")
    JUni(tok.vocab, tok.logprobs).save_sp_vocab(tmp_path / "j.tsv")
    assert (tmp_path / "t.tsv").read_text(encoding="utf-8") == \
        (tmp_path / "j.tsv").read_text(encoding="utf-8")
    sp_t, sp_j = TUni.load(tmp_path / "t.tsv"), JUni.load(tmp_path / "t.tsv")
    assert (sp_t.vocab, sp_t.logprobs) == (sp_j.vocab, sp_j.logprobs)
    # pieces without the blank / unk head get them prepended, as in JAX
    assert TUni(["x"], [-1.0]).vocab == JUni(["x"], [-1.0]).vocab


def test_cli_train_unigram_writes_jaxs_vocab(tmp_path, capsys):
    from jiao_liao_speech_recognition_torch import cli
    from jiao_liao_speech_recognition_torch.data.manifest import ManifestRow, write_manifest

    texts = _texts(3)
    write_manifest([ManifestRow(f"u{i}.wav", t, 1.0, "x") for i, t in enumerate(texts)],
                   tmp_path / "m.jsonl")
    rc = cli.main(["train-unigram", str(tmp_path / "m.jsonl"), "--output",
                   str(tmp_path / "u.json"), "--vocab-size", "50", "--max-piece-len", "3",
                   "--sp-vocab", str(tmp_path / "u.tsv")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = JUni.train(texts, vocab_size=50, max_piece_len=3)
    got = TUni.load(tmp_path / "u.json")
    assert (got.vocab, got.logprobs) == (want.vocab, want.logprobs)
    assert out == {"unigram_vocab": str(tmp_path / "u.json"), "vocab": len(want),
                   "texts": len(texts),
                   "multi_char_pieces": sum(1 for p in want.vocab[2:] if len(p) > 1)}
    assert (tmp_path / "u.tsv").exists()
