"""The port's corpus preparation, corpus CMVN, per-utterance CER/WER and
captions against the JAX package's: the same manifests row for row from
the same WAVs and tables, CMVN stats within CMVN_BAR, and the same cues,
words, SRT and WebVTT text."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import manifest as jman  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import prepare as jprep  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.evals import metrics as jmetrics  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import cmvn as jcmvn  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import captions as jcap  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import prepare as tprep  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.evals import metrics as tmetrics  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import cmvn as tcmvn  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import captions as tcap  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# corpus CMVN: f64 sums of f32 log-mel features that differ by ~1e-6 between
# the two packages' frontends
CMVN_BAR = 1e-4


def _dicts(m):
    return [dataclasses.asdict(r) for r in m.rows]


def _wavs(d, n, seed, secs=(1.0,)):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        s = secs[i % len(secs)]
        p = d / f"utt{i}.wav"
        write_wav(p, (0.1 * rng.randn(int(16000 * s)) + 0.2 * np.sin(
            np.arange(int(16000 * s)) * (0.05 + 0.01 * i))).astype(np.float32), 16000)
        paths.append(p)
    return paths


def _table(d, paths, extra=""):
    table = d / "trans.tsv"
    lines = [f"{p.name}\t胶辽话，{i}号！ " for i, p in enumerate(paths)]
    table.write_text("\n".join(lines) + extra, encoding="utf-8")
    return table


def test_wav_duration_table_and_directory_match_jax(tmp_path):
    paths = _wavs(tmp_path, 4, 1, secs=(1.0, 2.5, 0.2))
    for p in paths:
        assert tprep.wav_duration(p) == jprep.wav_duration(p)
    # a missing file (duration 0) and a one-column row (skipped)
    table = _table(tmp_path, paths, extra="\nmissing.wav\t没有\njust_one_column\n")
    for normalize in (False, True):
        kw = dict(audio_root=tmp_path, dialect="jiaoliao", normalize=normalize)
        assert _dicts(tprep.from_transcript_table(table, **kw)) == \
            _dicts(jprep.from_transcript_table(table, **kw))
    transcripts = {p.stem: f"文本{p.stem}" for p in paths[:3]}
    assert _dicts(tprep.from_directory(tmp_path, transcripts, "jilu")) == \
        _dicts(jprep.from_directory(tmp_path, transcripts, "jilu"))


@pytest.mark.parametrize("n, dev, test, seed", [(40, 0.1, 0.1, 7), (18, 0.05, 0.05, 0),
                                                (3, 0.5, 0.2, 2)])
def test_split_manifest_matches_jax(n, dev, test, seed):
    rows = [dict(audio=f"a{i}.wav", text="x" * (1 + i % 3), duration=1.0, dialect="d")
            for i in range(n)]
    got = tprep.split_manifest(tman.Manifest([tman.ManifestRow(**r) for r in rows]),
                               dev, test, seed)
    want = jprep.split_manifest(jman.Manifest([jman.ManifestRow(**r) for r in rows]),
                                dev, test, seed)
    assert [_dicts(m) for m in got] == [_dicts(m) for m in want]


def test_prepare_corpus_matches_jax(tmp_path):
    paths = _wavs(tmp_path, 12, 2, secs=(1.0, 0.2, 3.0))
    table = _table(tmp_path, paths)
    kw = dict(audio_root=tmp_path, dialect="jiaoliao", min_seconds=0.3, max_seconds=2.0,
              dev_fraction=0.1, test_fraction=0.2, seed=3)
    got = tprep.prepare_corpus(table, tmp_path / "torch", **kw)
    want = jprep.prepare_corpus(table, tmp_path / "jax", **kw)
    assert set(got) == set(want) == {"train", "dev", "test"}
    for split in got:
        assert got[split].replace("/torch/", "/jax/") == want[split]
        assert _dicts(tman.read_manifest(got[split])) == _dicts(jman.read_manifest(want[split]))
    assert len(tman.read_manifest(got["train"])) == 4 - 1 - 1  # the 1 s rows kept


def test_corpus_cmvn_matches_jax(tmp_path):
    paths = _wavs(tmp_path, 7, 3, secs=(1.0, 1.7, 0.6))
    m = tprep.from_transcript_table(_table(tmp_path, paths), tmp_path, "jiaoliao")
    jm = jman.Manifest([jman.ManifestRow(**r) for r in _dicts(m)])
    kw = dict(batch_size=2, bucket_boundaries_seconds=(1.0, 2.0), min_audio_seconds=0.3)
    with jax.default_matmul_precision("highest"):
        want = jcmvn.compute_corpus_cmvn(jm, JTok.build(jm.texts()), jcfg.DataConfig(**kw),
                                         jcfg.FrontendConfig(), max_batches=2)
    got = tcmvn.compute_corpus_cmvn(m, TTok.build(m.texts()), tcfg.DataConfig(**kw),
                                    tcfg.FrontendConfig(), max_batches=2, device="cpu")
    assert got.n == want.n > 0
    for a, b in zip(got.finalize(), want.finalize()):
        np.testing.assert_allclose(a, b, atol=CMVN_BAR, rtol=0)
    got.save(tmp_path / "t.npz")
    want.save(tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) and int(t["count"]) == int(j["count"])
    # the unmasked update and the stats' affine application
    feats = np.random.RandomState(4).randn(2, 80, 9).astype(np.float32)
    a, b = tcmvn.GlobalCMVN(80), jcmvn.GlobalCMVN(80)
    a.update(feats), b.update(feats)
    for x, y in zip(a.finalize(), b.finalize()):
        np.testing.assert_array_equal(x, y)
    mean, std = a.finalize()
    np.testing.assert_allclose(
        tcmvn.apply_global_cmvn(torch.from_numpy(feats), mean, std).numpy(),
        np.asarray(jcmvn.apply_global_cmvn(feats, mean, std)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ref, hyp", [("胶辽官话", "胶辽官话"), ("胶辽官话", "胶东话"),
                                      ("你好，世界！", "你好世界"), ("", ""), ("", "多"),
                                      ("abc 你好", "ABC你"), ("山东半岛", "")])
def test_per_utterance_cer_wer_match_jax(ref, hyp):
    for normalize in (True, False):
        assert tmetrics.cer(ref, hyp, normalize=normalize) == \
            jmetrics.cer(ref, hyp, normalize=normalize)
        assert tmetrics.wer(ref, hyp, normalize=normalize) == \
            jmetrics.wer(ref, hyp, normalize=normalize)


def _tokens(seed, n=40):
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.choice([0.04, 0.12, 0.5, 0.9]))
        end = t + float(rng.choice([0.04, 0.08, 0.2]))
        token = "".join(rng.choice(list("你好吗胶辽官话山东ab1"), rng.randint(1, 3)))
        out.append({"token": token, "start": round(t, 3), "end": round(end, 3)})
        t = end
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_captions_match_jax(seed):
    toks = _tokens(seed)
    assert tcap.group_words(toks) == jcap.group_words(toks)
    for kw in ({}, {"max_gap": 0.3, "max_dur": 2.0, "max_chars": 5}):
        cues = tcap.group_cues(toks, **kw)
        assert cues == jcap.group_cues(toks, **kw)
        assert tcap.format_srt(cues) == jcap.format_srt(cues)
        assert tcap.format_vtt(cues) == jcap.format_vtt(cues)
    assert tcap.group_words([]) == jcap.group_words([]) == []
