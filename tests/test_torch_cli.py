"""The port's CLI on the CPU (``--device cpu``) against the JAX package's:
train with and without stages, transcribe (plain, --timestamps, --caption
srt; --timestamps on a Whisper bundle too), evaluate --per-utt, featurize,
prepare --cmvn and serve (argv and --stdin, --int8, --timestamps) print
what the JAX CLI prints (the same JSON keys; the same manifests; features
and CMVN stats within their bars), transcribe's and serve's texts are
``api.transcribe``'s, transcribe --stream prints the JAX CLI's lines one
for one on its own random init (and raises its error on a Whisper bundle),
the joint family's strategies, --timestamps and --stream print the JAX
CLI's lines on one checkpoint both packages read, ``train-lm`` writes the
JAX CLI's LM, --lm-path / --lm-weight reach a Whisper beam, a CTC
bundle's beam (transcribe --strategy beam / beam_device, evaluate --decode
beam) prints the JAX CLI's lines, build-native builds the native
libraries, export-whisper and --profile write their files, and train
--multihost trains in two processes with the primary alone writing."""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from jiao_liao_speech_recognition_tpu import cli as jcli  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch import cli  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.data.manifest import (  # noqa: E402
    ManifestRow,
    read_manifest,
    write_manifest,
)
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# log-mel of two f32 implementations (the C3 bar); corpus CMVN stats
LOGMEL_BAR = 2e-4
CMVN_BAR = 1e-4
TINY = [
    "data.batch_size=2", "data.bucket_boundaries_seconds=[2.0]", "data.min_audio_seconds=0.1",
    "frontend.chunk_seconds=2.0", "ctc_model.d_model=64", "ctc_model.num_layers=1",
    "ctc_model.num_heads=4", "ctc_model.mlp_dim=128", "ctc_model.conv_channels=32",
    "ctc_model.use_flash_attention=false", "ctc_model.dtype=float32",
    "train.optimizer.warmup_steps=1", "train.optimizer.learning_rate=1e-3",
    "train.log_every_steps=2",
]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    rows = {"jiaoliao": [], "jilu": []}
    table = []
    for i in range(8):
        dialect = "jiaoliao" if i % 2 else "jilu"
        secs = 1.2 if i < 6 else 0.7
        t = np.arange(int(16000 * secs)) / 16000
        wav = (0.1 * rng.randn(len(t)) + 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t))
        write_wav(tmp / f"u{i}.wav", wav.astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 12, 2 + i % 3))
        rows[dialect].append(ManifestRow(str(tmp / f"u{i}.wav"), text, secs, dialect))
        table.append(f"u{i}.wav\t{text}")
    for dialect, r in rows.items():
        write_manifest(r, tmp / f"{dialect}.jsonl")
    write_manifest(rows["jiaoliao"] + rows["jilu"], tmp / "train.jsonl")
    (tmp / "table.tsv").write_text("\n".join(table), encoding="utf-8")
    tiny = tcfg.apply_overrides(tcfg.ExperimentConfig(), TINY)
    tcfg.save_yaml(tiny, str(tmp / "tiny.yaml"))
    return tmp


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


def _train(env, capsys, name, *extra):
    return _run(cli.main, [
        "train", "--config", str(env / "tiny.yaml"), "--device", "cpu",
        f"data.train_manifest={env}/train.jsonl", f"train.checkpoint_dir={env}/{name}",
        f"train.metrics_path={env}/{name}.jsonl", *extra], capsys)


FT = ["train.optimizer.total_steps=4", "data.dialect_weights={jiaoliao: 2.0, jilu: 1.0}"]


@pytest.fixture(scope="module")
def final(env):
    """A bundle trained by `train` without stages (4 steps, dialect mixing)."""
    assert cli.main(["train", "--config", str(env / "tiny.yaml"), "--device", "cpu",
                     f"data.train_manifest={env}/train.jsonl",
                     f"train.checkpoint_dir={env}/ft", *FT]) == 0
    return env / "ft" / "final"


def test_train_without_stages_saves_the_bundle(env, final, capsys):
    assert all((final / f).exists() for f in ("params.npz", "config.yaml", "vocab.json"))
    assert sorted(p.name for p in final.parent.iterdir()) == ["00000004", "final"]
    rc, out = _train(env, capsys, "ft", *FT, "--resume")
    assert rc == 0 and out[-1] == f"saved final bundle to {final} (step 4)"


def test_train_with_stages_prints_history_and_saves_the_bundle(env, capsys):
    stages = (f"stages=[{{name: neighbor, manifests: [{env}/jilu.jsonl, {env}/jiaoliao.jsonl],"
              f" steps: 2, train_adapters_only: false, mix_weights: [1.0, 2.0]}},"
              f" {{name: target, manifests: [{env}/jiaoliao.jsonl], steps: 2}}]")
    rc, out = _train(env, capsys, "st", "ctc_model.adapter.kind=att",
                     "ctc_model.adapter.att_num_heads=2", "ctc_model.adapter.att_key_dim=16",
                     stages)
    assert rc == 0
    history = [json.loads(line) for line in out[:-1]]
    # the JAX history: {"stage", **the step's metrics} = loss, nll_sum, grad_norm
    assert [sorted(h) for h in history] == [["grad_norm", "loss", "nll_sum", "stage"]] * 2
    assert [h["stage"] for h in history] == ["neighbor", "target"]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert out[-1] == f"saved final bundle to {env}/st/final"
    assert sorted(p.name for p in (env / "st").iterdir()) == \
        ["final", "stage_0_neighbor", "stage_1_target"]
    saved = tcfg.load_yaml(str(env / "st" / "final" / "config.yaml"))
    assert [s.name for s in saved.stages] == ["neighbor", "target"]
    served = api.load(str(env / "st" / "final"), device="cpu")
    assert served.config.ctc_model.adapter.kind == "att"
    # --resume over the finished stages takes no step: the same bundle
    before = dict(np.load(env / "st" / "final" / "params.npz"))
    rc, out = _train(env, capsys, "st", "ctc_model.adapter.kind=att",
                     "ctc_model.adapter.att_num_heads=2", "ctc_model.adapter.att_key_dim=16",
                     stages, "--resume")
    assert rc == 0 and [json.loads(line) for line in out[:-1]] == \
        [{"stage": "neighbor"}, {"stage": "target"}]
    with np.load(env / "st" / "final" / "params.npz") as after:
        assert sorted(after.files) == sorted(before)
        assert all(np.array_equal(after[k], v) for k, v in before.items())


def _same_shape(got, want):
    """The same keys, and in lists that both fill, dicts of the same keys."""
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if isinstance(v, list) and v and want[k]:
            assert {kk for d in v for kk in d} == {kk for d in want[k] for kk in d}, k


@pytest.mark.parametrize("flags", [[], ["--timestamps"], ["--caption", "srt"]])
def test_transcribe_prints_what_jax_prints(env, final, flags, capsys):
    wavs = [str(env / "u0.wav"), str(env / "u7.wav")]
    rc, out = _run(cli.main, ["transcribe", *wavs, "--checkpoint", str(final),
                              "--device", "cpu", *flags], capsys)
    assert rc == 0 and len(out) == 2
    got = [json.loads(line) for line in out]
    texts = api.transcribe(api.load(str(final), device="cpu"), wavs)
    assert [r["audio"] for r in got] == wavs and [r["text"] for r in got] == texts
    if flags == ["--caption", "srt"]:
        assert got[0]["caption"] == str(env / "u0.srt")
        srt = (env / "u0.srt").read_text(encoding="utf-8")
        assert srt.startswith("1\n00:00:0") if texts[0] else srt == ""
    if flags == ["--timestamps"]:
        assert all({"token", "start", "end"} == set(t) for r in got for t in r["tokens"])
        assert all({"word", "start", "end"} == set(w) for r in got for w in r["words"])
    # the JAX CLI on a random-init bundle of the same config: the same keys
    rc, out = _run(jcli.main, ["transcribe", *wavs, "--config", str(env / "tiny.yaml"),
                               *flags], capsys)
    assert rc == 0 and len(out) == 2
    for a, b in zip(got, out):
        _same_shape(a, json.loads(b))


def test_evaluate_per_utt_prints_what_jax_prints(env, final, capsys):
    args = ["evaluate", "--manifest", str(env / "train.jsonl"), "--batch-size", "3"]
    rc, out = _run(cli.main, [*args, "--checkpoint", str(final), "--device", "cpu",
                              "--per-utt", str(env / "t.jsonl")], capsys)
    assert rc == 0
    got = json.loads(out[-1])
    rc, out = _run(jcli.main, [*args, "--config", str(env / "tiny.yaml"),
                               "--per-utt", str(env / "j.jsonl")], capsys)
    assert rc == 0
    want = json.loads(out[-1])
    assert sorted(got) == sorted(want) and got["utterances"] == want["utterances"] == 8
    rows = [json.loads(line) for line in (env / "t.jsonl").read_text().splitlines()]
    jrows = [json.loads(line) for line in (env / "j.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in rows] == [sorted(r) for r in jrows]
    assert [(r["audio"], r["dialect"], r["ref"]) for r in rows] == \
        [(r["audio"], r["dialect"], r["ref"]) for r in jrows]
    m = read_manifest(env / "train.jsonl")
    hyps = api.transcribe(api.load(str(final), device="cpu"), [r.audio for r in m.rows])
    assert [r["hyp"] for r in rows] == hyps


def test_featurize_matches_jax(env, capsys):
    rc, out = _run(cli.main, ["featurize", str(env / "u1.wav"), "--output",
                              str(env / "t.npy"), "--device", "cpu"], capsys)
    assert rc == 0 and out[-1].startswith(f"wrote {env}/t.npy shape=(1, 80, ")
    with jax.default_matmul_precision("highest"):
        rc, jout = _run(jcli.main, ["featurize", str(env / "u1.wav"), "--output",
                                    str(env / "j.npy")], capsys)
    assert rc == 0 and out[-1].split("shape=")[1] == jout[-1].split("shape=")[1]
    np.testing.assert_allclose(np.load(env / "t.npy"), np.load(env / "j.npy"),
                               atol=LOGMEL_BAR, rtol=0)


def test_prepare_cmvn_matches_jax(env, capsys):
    args = ["prepare", str(env / "table.tsv"), "--audio-root", str(env), "--dialect",
            "jiaoliao", "--min-seconds", "0.1", "--test-fraction", "0.25", "--cmvn"]
    rc, out = _run(cli.main, [*args, "--out-dir", str(env / "tp"), "--device", "cpu"], capsys)
    assert rc == 0
    got = json.loads(out[-1])
    with jax.default_matmul_precision("highest"):
        rc, out = _run(jcli.main, [*args, "--out-dir", str(env / "jp")], capsys)
    assert rc == 0
    want = json.loads(out[-1])
    assert sorted(got) == sorted(want) == ["cmvn_stats", "dev", "test", "train"]
    for split in ("train", "dev", "test"):
        assert [r.to_json() for r in read_manifest(got[split]).rows] == \
            [r.to_json() for r in read_manifest(want[split]).rows]
    with np.load(got["cmvn_stats"]) as t, np.load(want["cmvn_stats"]) as j:
        assert int(t["count"]) == int(j["count"]) > 0
        for k in ("mean", "std"):
            np.testing.assert_allclose(t[k], j[k], atol=CMVN_BAR, rtol=0)


def test_train_multihost_runs_stages_in_two_processes(env, tmp_path):
    """The multi-dialect stages under `train --multihost` in two CPU
    processes (stage 1 trains the backbone, stage 2 the adapters only, on
    the model the first stage wrapped): the primary alone prints the
    history and saves the bundle, which loads."""
    from torch_ranks import spawn

    stages = (f"stages=[{{name: neighbor, manifests: [{env}/jilu.jsonl, {env}/jiaoliao.jsonl],"
              f" steps: 2, train_adapters_only: false}},"
              f" {{name: target, manifests: [{env}/jiaoliao.jsonl], steps: 2}}]")
    argv = ["-m", "jiao_liao_speech_recognition_torch.cli", "train", "--config",
            str(env / "tiny.yaml"), "--multihost", "--device", "cpu",
            "ctc_model.adapter.kind=wf", "ctc_model.adapter.wf_rank=4",
            f"train.checkpoint_dir={tmp_path}/st", f"train.metrics_path={tmp_path}/m.jsonl",
            stages]
    (rc0, out0), (rc1, out1) = spawn(argv, 2, timeout=120)
    assert rc0 == 0 and rc1 == 0, out0[-3000:] + out1[-3000:]
    lines = out0.strip().splitlines()
    assert lines[-1] == f"saved final bundle to {tmp_path}/st/final"
    history = [json.loads(line) for line in lines if line.startswith("{")]
    assert [h["stage"] for h in history] == ["neighbor", "target"]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "saved final bundle" not in out1 and '"stage"' not in out1
    summaries = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()
                 if '"stage_index"' in line]
    assert [r["stage"] for r in summaries] == ["neighbor", "target"]
    served = api.load(str(tmp_path / "st" / "final"), device="cpu")
    assert served.config.ctc_model.adapter.kind == "wf"


@pytest.mark.parametrize("argv", [
    ["train-unigram", "m.jsonl", "--output", "u.json"],
    ["export-whisper", "--checkpoint", "WHISPER", "--out", "o"], ["build-native"],
    ["transcribe", "u0.wav", "--checkpoint", "FINAL", "--profile", "d"],
    ["train", "--config", "tiny.yaml", "--profile", "d"],
    ["train", "--config", "tiny.yaml", "--multihost"],
])
def test_unported_subcommands_and_flags_exit_2(argv, capsys, tmp_path, monkeypatch, request):
    """No flag is left unported (the exit-2 path stays for later ones).
    train --multihost runs as two CPU processes of one process group
    (JL_* variables): both exit 0, the primary alone prints the bundle line
    and writes the metrics (one record a step), and the bundle loads.
    build-native builds native/beam.cpp, wavio.cpp and
    flacio.cpp, prints the JAX CLI's line and the libraries load.
    train-unigram writes the vocab JAX's trains on the same manifest and
    prints the JAX CLI's keys. export-whisper writes the HF checkpoint
    files and prints the JAX CLI's line. --profile writes a torch.profiler
    trace under its directory, and transcribe prints what it prints
    without it."""
    if argv[0] == "train-unigram":
        from jiao_liao_speech_recognition_tpu.data.unigram import UnigramTokenizer as JUni
        from jiao_liao_speech_recognition_torch.data.manifest import ManifestRow, write_manifest

        texts = ["你好世界", "你好朋友", "世界真好", "你好你好世界"] * 5
        write_manifest([ManifestRow(f"u{i}.wav", t, 1.0, "") for i, t in enumerate(texts)],
                       tmp_path / "m.jsonl")
        monkeypatch.chdir(tmp_path)
        assert cli.main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert sorted(out) == ["multi_char_pieces", "texts", "unigram_vocab", "vocab"]
        want = JUni.train(texts)
        got = json.loads((tmp_path / "u.json").read_text(encoding="utf-8"))
        assert (got["pieces"], got["logprobs"]) == (want.vocab, want.logprobs)
        return
    if argv == ["build-native"]:
        from jiao_liao_speech_recognition_torch.utils import native_ext

        assert cli.main(argv) == 0
        assert capsys.readouterr().out.splitlines() == ["native build: ok"]
        for name in ("beam", "wavio", "flacio"):
            assert native_ext.native_available(name), name
        assert native_ext.load_beam() and native_ext.load_wavio() and native_ext.load_flacio()
        return
    if "--multihost" in argv:
        from torch_ranks import spawn

        env = request.getfixturevalue("env")
        assert cli.NOT_PORTED == {}
        argv = ["-m", "jiao_liao_speech_recognition_torch.cli", "train", "--config",
                str(env / "tiny.yaml"), "--multihost", "--device", "cpu",
                f"data.train_manifest={env}/train.jsonl", "train.optimizer.total_steps=2",
                "train.log_every_steps=1", f"train.checkpoint_dir={tmp_path}/ckpt",
                f"train.metrics_path={tmp_path}/m.jsonl"]
        (rc0, out0), (rc1, out1) = spawn(argv, 2, timeout=120)
        assert rc0 == 0 and rc1 == 0, out0[-3000:] + out1[-3000:]
        final = tmp_path / "ckpt" / "final"
        assert out0.strip().splitlines()[-1] == f"saved final bundle to {final} (step 2)"
        assert "saved final bundle" not in out1
        records = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
        assert [r["step"] for r in records] == [1, 2]
        assert all(np.isfinite(r["loss"]) and "grad_norm" in r for r in records)
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["00000002", "final"]
        assert api.load(str(final), device="cpu").config.model_family == "ctc"
        return
    env = request.getfixturevalue("env")
    paths = {"WHISPER": lambda: str(request.getfixturevalue("whisper")),
             "FINAL": lambda: str(request.getfixturevalue("final")),
             "o": lambda: str(tmp_path / "o"), "d": lambda: str(tmp_path / "d"),
             "u0.wav": lambda: str(env / "u0.wav"), "tiny.yaml": lambda: str(env / "tiny.yaml")}
    argv = [paths[a]() if a in paths else a for a in argv] + ["--device", "cpu"]
    if argv[0] == "export-whisper":
        rc, out = _run(cli.main, argv, capsys)
        assert rc == 0 and json.loads(out[-1]) == {"out": str(tmp_path / "o")}
        assert sorted(f.name for f in (tmp_path / "o").iterdir()) == \
            ["config.json", "generation_config.json", "model.safetensors"]
        return
    if argv[0] == "train":
        argv += [f"data.train_manifest={env}/train.jsonl", "train.optimizer.total_steps=2",
                 f"train.checkpoint_dir={tmp_path}/ckpt"]
    capsys.readouterr()
    rc, out = _run(cli.main, argv, capsys)
    assert rc == 0
    traces = list((tmp_path / "d").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    if argv[0] == "transcribe":
        i = argv.index("--profile")
        assert _run(cli.main, argv[:i] + argv[i + 2:], capsys)[1] == out


@pytest.fixture(scope="module")
def ctc_beam_ckpt(env):
    """One CTC checkpoint directory both CLIs load (the JAX bundle's save
    plus the same weights as the port's params.npz): tiny, f32, V = 17, so
    beam_topk 16 is V - 1 and JAX's engine and host routes agree."""
    from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok

    cfg = jcfg.ExperimentConfig(ctc_model=jcfg.CTCModelConfig(
        vocab_size=17, d_model=64, num_layers=1, num_heads=4, mlp_dim=128, conv_channels=32,
        use_flash_attention=False, dtype="float32"))
    cfg.frontend.chunk_seconds = 2.0
    params = jax.tree_util.tree_map(np.asarray, JBundle._init_params(cfg, seed=4))
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8.0  # decisive rows
    JBundle(config=cfg, params=params, tokenizer=JTok([chr(0x4E00 + i) for i in range(15)])
            ).save(str(env / "ctc_beam"))
    convert.write_npz_params(params, env / "ctc_beam" / "params.npz")
    return env / "ctc_beam"


@pytest.mark.parametrize("argv", [["transcribe", "--strategy", "beam"],
                                  ["transcribe", "--strategy", "beam_device", "--beam-size", "4"],
                                  ["evaluate", "--decode", "beam"]])
def test_ctc_beam_exits_2_naming_its_item(env, ctc_beam_ckpt, argv, capsys):
    """Once refused with exit 2, the CTC beam is ported: the same argv exits
    0 and prints the JAX CLI's lines on one checkpoint both CLIs read."""
    where = [str(env / "u0.wav"), str(env / "u7.wav")] if argv[0] == "transcribe" else \
        ["--manifest", str(env / "jilu.jsonl"), "--batch-size", "3"]
    args = [argv[0], *where, *argv[1:], "--checkpoint", str(ctc_beam_ckpt)]
    rc, got = _run(cli.main, [*args, "--device", "cpu"], capsys)
    assert rc == 0
    with jax.default_matmul_precision("highest"):
        rc, want = _run(jcli.main, args, capsys)
    assert rc == 0 and got == want
    assert len(got) == (2 if argv[0] == "transcribe" else 1)


@pytest.mark.parametrize("tokenizer", ["built", "checkpoint"])
def test_train_lm_writes_the_jax_clis_lm(env, final, tokenizer, capsys):
    """train-lm: the JAX CLI's JSON line and counts; each package's file
    loads in the other's NGramCharLM."""
    from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM
    from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM

    extra = ["--checkpoint", str(final)] if tokenizer == "checkpoint" else []
    manifests = [str(env / "jilu.jsonl"), str(env / "jiaoliao.jsonl")]
    out = {}
    for name, main in (("torch", cli.main), ("jax", jcli.main)):
        if name == "jax" and extra:  # the JAX CLI reads the tokenizer through its own load
            from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok

            tok = JTok.load(final / "vocab.json")
            texts = [t for m in manifests for t in read_manifest(m).texts()]
            lm = JLM.train_from_texts(texts, tok, order=2)
            lm.save(env / f"lm_{name}_{tokenizer}.npz")
            out[name] = {"lm": str(env / f"lm_{name}_{tokenizer}.npz"), "order": 2,
                         "vocab": lm.vocab_size, "ngrams": len(lm.counts), "texts": len(texts)}
            continue
        rc, lines = _run(main, ["train-lm", *manifests, "--output",
                                str(env / f"lm_{name}_{tokenizer}.npz"), "--order", "2",
                                *extra], capsys)
        assert rc == 0
        out[name] = json.loads(lines[-1])
    assert {k: v for k, v in out["torch"].items() if k != "lm"} == \
        {k: v for k, v in out["jax"].items() if k != "lm"}
    assert out["torch"]["texts"] == 8 and out["torch"]["ngrams"] > 0
    a, b = NGramCharLM.load(out["jax"]["lm"]), JLM.load(out["torch"]["lm"])
    assert a.counts == b.counts and a.vocab_size == b.vocab_size


@pytest.mark.parametrize("main", [cli.main, jcli.main], ids=["torch", "jax"])
def test_int8_of_a_ctc_bundle_exits_2(env, final, main, capsys):
    args = ["--checkpoint", str(final), "--device", "cpu"] if main is cli.main else \
        ["--config", str(env / "tiny.yaml")]
    assert main(["transcribe", str(env / "u0.wav"), "--int8", *args]) == 2
    assert "error: --int8:" in capsys.readouterr().err


# --- Whisper: serve, and transcribe --timestamps ------------------------------------

WHISPER = dict(vocab_size=96, d_model=64, encoder_layers=1, decoder_layers=2, num_heads=2,
               mlp_dim=128, max_source_positions=100, max_target_positions=16,
               prompt_ids=(1, 3), eot_id=95, dtype="float32", use_flash_attention=False)


@pytest.fixture(scope="module")
def whisper(env):
    """A tiny random-init Whisper checkpoint of the port (2 s windows, a char
    vocabulary) and its config as YAML, which the JAX CLI initializes."""
    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=tcfg.WhisperConfig(**WHISPER))
    cfg.frontend.chunk_seconds = 2.0
    cfg.decode.max_decode_len = 12
    tcfg.save_yaml(cfg, str(env / "whisper.yaml"))
    bundle = api.load(config=cfg, device="cpu")
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(94)])
    bundle.save(str(env / "wh"))
    return env / "wh"


def _serve(env, whisper, flags, capsys, stdin=None, monkeypatch=None):
    wavs = [str(env / f"u{i}.wav") for i in (0, 6, 7)]
    argv = ["serve", *wavs[:2], "--checkpoint", str(whisper), "--device", "cpu", "--slots", "2",
            "--steps-per-dispatch", "3", *flags]
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(f"\n{wavs[2]}\n"))
        argv.append("--stdin")
    else:
        argv.insert(3, wavs[2])
    capsys.readouterr()
    rc = cli.main(argv)
    out, err = capsys.readouterr()
    return rc, wavs, [json.loads(line) for line in out.strip().splitlines()], err


@pytest.mark.parametrize("flags", [[], ["--int8"], ["--timestamps"], ["--stdin"]])
def test_serve_prints_what_jax_prints(env, whisper, flags, capsys, monkeypatch):
    stdin = flags == ["--stdin"]
    rc, wavs, got, err = _serve(env, whisper, [] if stdin else flags, capsys,
                                stdin=stdin or None, monkeypatch=monkeypatch)
    assert rc == 0 and sorted(r["audio"] for r in got) == sorted(wavs)
    assert "served 3 utterances in " in err and "latency mean" in err
    bundle = api.load(str(whisper), device="cpu")
    if "--int8" in flags:
        bundle = bundle.quantize()
    want = dict(zip(wavs, api.transcribe(bundle, wavs)))
    assert {r["audio"]: r["text"] for r in got} == want
    assert all(r["latency_s"] >= 0 for r in got)
    if "--timestamps" in flags:
        timed = dict(zip(wavs, bundle.transcribe_timed(wavs)))
        assert all(r["tokens"] == timed[r["audio"]] for r in got)
        assert all({"word", "start", "end"} == set(w) for r in got for w in r["words"])
        assert all("".join(w["word"] for w in r["words"]) == r["text"] for r in got)
    # the JAX CLI on a random-init bundle of the same config: the same keys
    capsys.readouterr()
    rc = jcli.main(["serve", *wavs, "--config", str(env / "whisper.yaml"), "--slots", "2",
                    "--steps-per-dispatch", "3", *([] if stdin else flags)])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 3
    for a, b in zip(got, out):
        _same_shape(a, json.loads(b))


def test_serve_refuses_a_ctc_bundle(env, final, capsys):
    assert cli.main(["serve", str(env / "u0.wav"), "--checkpoint", str(final),
                     "--device", "cpu"]) == 2
    assert "CTC" in capsys.readouterr().err


def test_whisper_transcribe_timestamps_print_what_jax_prints(env, whisper, capsys):
    wavs = [str(env / "u0.wav"), str(env / "u7.wav")]
    rc, out = _run(cli.main, ["transcribe", *wavs, "--checkpoint", str(whisper),
                              "--device", "cpu", "--timestamps"], capsys)
    assert rc == 0 and len(out) == 2
    got = [json.loads(line) for line in out]
    bundle = api.load(str(whisper), device="cpu")
    assert [r["tokens"] for r in got] == bundle.transcribe_timed(wavs)
    assert [r["text"] for r in got] == api.transcribe(bundle, wavs)
    rc, out = _run(jcli.main, ["transcribe", *wavs, "--config", str(env / "whisper.yaml"),
                               "--timestamps"], capsys)
    assert rc == 0 and len(out) == 2
    for a, b in zip(got, out):
        _same_shape(a, json.loads(b))


@pytest.fixture(scope="module")
def jax_init(env):
    """The port's checkpoint of the JAX CLI's own random init of tiny.yaml
    (seed 0, blank + unk vocabulary), so both CLIs serve one model."""
    params = JBundle._init_params(jcfg.load_yaml(str(env / "tiny.yaml")))
    bundle = api.load(config=str(env / "tiny.yaml"), device="cpu")
    bundle.model.load_state_dict(convert.params_to_state_dict(params))
    bundle.save(str(env / "jinit"))
    return env / "jinit"


@pytest.mark.parametrize("flags", [
    [], ["--stream-window", "1.28", "--stream-hop", "0.32", "--stream-lookahead", "0.16"]])
def test_transcribe_stream_prints_what_jax_prints(env, jax_init, flags, capsys):
    """transcribe --stream: one line a hop, then the final text, line for
    line the JAX CLI's on the same weights (f32, JAX at HIGHEST)."""
    wavs = [str(env / "u0.wav"), str(env / "u7.wav")]
    rc, got = _run(cli.main, ["transcribe", *wavs, "--checkpoint", str(jax_init),
                              "--device", "cpu", "--stream", *flags], capsys)
    assert rc == 0
    with jax.default_matmul_precision("highest"):
        rc, want = _run(jcli.main, ["transcribe", *wavs, "--config", str(env / "tiny.yaml"),
                                    "--stream", *flags], capsys)
    assert rc == 0 and got == want
    hop = 0.4 if not flags else 0.32
    assert len(got) == sum(-(-int(16000 * s) // int(16000 * hop)) + 1 for s in (1.2, 0.7))
    assert [sorted(json.loads(line)) for line in got[:2]] == [
        ["audio", "partial", "preview", "t"]] * 2
    assert sorted(json.loads(got[-1])) == ["audio", "text"]


def test_transcribe_stream_refuses_a_whisper_bundle(env, whisper):
    """--stream on a Whisper bundle raises the JAX package's ValueError."""
    with pytest.raises(ValueError) as got:
        cli.main(["transcribe", str(env / "u0.wav"), "--checkpoint", str(whisper),
                  "--device", "cpu", "--stream"])
    with pytest.raises(ValueError) as want:
        jcli.main(["transcribe", str(env / "u0.wav"), "--config", str(env / "whisper.yaml"),
                   "--stream"])
    assert str(got.value) == str(want.value) == (
        "streaming supports the ctc/joint families, not 'whisper'; whisper serving is "
        "serve/engine.py")


# --- the joint family ---------------------------------------------------------------

JOINT = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2, mlp_dim=64,
             conv_channels=16, dropout=0.0, dtype="float32", use_flash_attention=False,
             max_target_positions=32)


@pytest.fixture(scope="module")
def joint(env):
    """One checkpoint directory both CLIs load: the JAX bundle's save
    (orbax params/, config.yaml, vocab.json) of a seeded WF-adapted joint
    model, plus the same weights as the port's params.npz."""
    from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok

    cfg = jcfg.ExperimentConfig(model_family="joint", joint=jcfg.JointModelConfig(
        adapter=jcfg.AdapterConfig(kind="wf", wf_rank=2), **JOINT))
    cfg.frontend.chunk_seconds = 2.0
    cfg.decode.max_decode_len = 10
    cfg.decode.beam_size = 3
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * noise.randn(*x.shape).astype(np.float32), JBundle._init_params(cfg))
    JBundle(config=cfg, params=params, tokenizer=JTok([chr(0x4E00 + i) for i in range(30)])
            ).save(str(env / "joint"))
    convert.write_npz_params(params, env / "joint" / "params.npz")
    return env / "joint"


@pytest.mark.parametrize("flags", [
    [], ["--strategy", "greedy"], ["--strategy", "ctc_greedy"], ["--strategy", "spec_greedy"],
    ["--strategy", "beam", "--beam-size", "2"], ["--timestamps"],
    ["--stream", "--stream-window", "1.28", "--stream-hop", "0.32", "--stream-lookahead", "0.16"],
])
def test_joint_transcribe_prints_what_jax_prints(env, joint, flags, capsys):
    """The config's beam (K 3, CTC rescoring), each strategy, timestamps and
    the CTC branch streamed: line for line the JAX CLI's (f32, JAX at
    HIGHEST) on the same checkpoint."""
    wavs = [str(env / "u0.wav"), str(env / "u7.wav")]
    rc, got = _run(cli.main, ["transcribe", *wavs, "--checkpoint", str(joint),
                              "--device", "cpu", *flags], capsys)
    assert rc == 0
    with jax.default_matmul_precision("highest"):
        rc, want = _run(jcli.main, ["transcribe", *wavs, "--checkpoint", str(joint), *flags],
                        capsys)
    assert rc == 0 and got == want
    assert any(json.loads(line).get("text") for line in got)


def test_transcribe_lm_flags_reach_a_whisper_beam(env, whisper, tmp_path, capsys):
    """--strategy beam --beam-size --lm-path --lm-weight: the texts of the
    bundle's transcribe with that DecodeConfig, which the LM changes."""
    import dataclasses

    from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM

    NGramCharLM.train([[7, 8, 7, 8, 9], [7, 9, 9, 40]], 2, WHISPER["vocab_size"]).save(
        tmp_path / "lm.npz")
    wavs = [str(env / "u0.wav"), str(env / "u7.wav")]
    bundle = api.load(str(whisper), device="cpu")
    texts = {}
    for w in ("0", "4"):
        rc, out = _run(cli.main, ["transcribe", *wavs, "--checkpoint", str(whisper), "--device",
                                  "cpu", "--strategy", "beam", "--beam-size", "2", "--lm-path",
                                  str(tmp_path / "lm.npz"), "--lm-weight", w], capsys)
        assert rc == 0
        texts[w] = [json.loads(line)["text"] for line in out]
        dc = dataclasses.replace(bundle.config.decode, strategy="beam", beam_size=2,
                                 lm_path=str(tmp_path / "lm.npz"), lm_weight=float(w))
        assert texts[w] == api.transcribe(bundle, wavs, decode_cfg=dc)
    assert texts["0"] != texts["4"]
