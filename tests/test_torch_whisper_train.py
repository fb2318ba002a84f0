"""The port's Whisper fine-tuning against the JAX package's: the teacher
forcing of ``batch_to_device(..., family="whisper")``, the tokenizer and
vocabulary sizing of ``build_tokenizer_for`` (char, unigram, byte-level
BPE), the loss and adapter gradients of ``make_whisper_loss_fn``, four
steps that lower the loss on a frozen backbone, a killed ``cli train``
resumed bit for bit, ``api.fine_tune`` and ``cli train`` (on
configs/whisper_large_v3_adapters.yaml with tiny overrides) writing a bundle
that loads and transcribes, adapted logits (WF, Att, bottleneck), the Att
adapter's cached decode, and int8 greedy decode of a WF-adapted model.

Tiny models (d 64, 2 + 2 blocks, 4 heads; d 128 with heads of 64 for the
int8 kernels' plain versions), the same seeded numpy inputs and, through
the Whisper weight bridge, the same weights on both sides; f32 at JAX's
"highest" matmul precision where the port is held to JAX, with dropout 0
and SpecAugment off there."""

import dataclasses
import json
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.manifest import Manifest as JManifest  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.manifest import ManifestRow as JRow  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.unigram import UnigramTokenizer as JUni  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jq  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import engine as jeng  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api, cli  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.bpe import ByteLevelBPE  # noqa: E402
from jiao_liao_speech_recognition_torch.data.unigram import UnigramTokenizer as TUni  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert, layers  # noqa: E402
from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.train import checkpoints as tckpt  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

TINY = dict(vocab_size=50, d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4,
            mlp_dim=128, max_target_positions=24, use_flash_attention=False, dropout=0.0,
            dtype="float32")
EOT = 2
PROMPT = (1, 3)
ADAPTERS = {
    "wf": dict(kind="wf", wf_rank=2),
    "att": dict(kind="att", att_num_heads=2, att_key_dim=8, dropout=0.0),
    "bottleneck": dict(kind="bottleneck", bottleneck_dim=8, dropout=0.0),
}
# f32 at "highest": the same arithmetic in both packages, sums reordered,
# from features that already differ by ~1e-6 (two f32 log-mel
# implementations). The loss within LOSS_REL_BAR; each adapter gradient
# within GRAD_REL_BAR of that gradient's largest magnitude; logits within
# LOGIT_BAR (the Whisper slice's f32 logit bar); a cached decode step
# within STEP_BAR of the teacher-forced pass (the same port arithmetic).
LOSS_REL_BAR = 1e-5
GRAD_REL_BAR = 1e-4
LOGIT_BAR = 2e-4
STEP_BAR = 1e-5


def _wcfg(c, kind="wf", **kw):
    return c.WhisperConfig(prompt_ids=PROMPT, eot_id=EOT, adapter=c.AdapterConfig(**ADAPTERS[kind]),
                           **dict(TINY, **kw))


def _exp(c, kind="wf", **kw):
    return c.ExperimentConfig(model_family="whisper", whisper=_wcfg(c, kind),
                              frontend=c.FrontendConfig(chunk_seconds=1.0),
                              specaugment=c.SpecAugmentConfig(enabled=False), **kw)


def _params(jc, seed=0):
    """JAX init with the adapters moved off their identity (WF's zero B, the
    zero out_proj / up of the slots)."""
    params = JBundle._init_params(jc, seed=seed)
    noise = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 0.05 * noise.randn(*v.shape)).astype(np.float32)
        if any("adapter_" in str(getattr(k, "key", "")) for k in path) else np.asarray(v),
        params)


def _port_model(wcfg, params):
    model = WhisperModel(wcfg)
    model.load_state_dict(convert.whisper_params_to_state_dict(params))
    return model


def _host_batch(mod, B=2, seed=0, lens=(7, 4), samples=16000):
    rng = np.random.RandomState(seed)
    S = max(max(lens), 1)
    labels = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(4, 50, n)
    return mod.Batch(audio=(0.1 * rng.randn(B, samples)).astype(np.float32),
                     audio_lengths=np.asarray([samples, samples - 5000, samples][:B], np.int32),
                     labels=labels, label_lengths=np.asarray(lens, np.int32),
                     texts=[""] * B, bucket_seconds=1.0)


def _bpe_dir(d: Path) -> Path:
    """An HF-format byte-level BPE directory: the 256 byte symbols, a few
    merges, and Whisper-style specials after them."""
    from jiao_liao_speech_recognition_torch.data.bpe import bytes_to_unicode

    d.mkdir(parents=True, exist_ok=True)
    vocab = {s: i for i, s in enumerate(bytes_to_unicode().values())}
    merges = [("ä", "¸"), ("Ġ", "a"), ("e", "r")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    for name in ("<|endoftext|>", "<|startoftranscript|>", "<|zh|>"):
        vocab[name] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
                                  encoding="utf-8")
    return d


# ------------------------------------------------------------ teacher forcing


@pytest.mark.parametrize("prompt,eot", [(None, None), (PROMPT, EOT), ((7,), 9)])
@pytest.mark.parametrize("lens", [(7, 0, 3), (1, 5, 5), (9, 9, 2)])
def test_batch_to_device_whisper_tokens_and_targets_are_jaxs(prompt, eot, lens):
    """The prompt prefix, the labels, EOT to the end; targets shifted by
    one with EOT after the last label and -100 elsewhere: the default
    multilingual prompt and EOT, and custom ones, over ragged lengths."""
    want = jeng.batch_to_device(_host_batch(jpipe, B=3, lens=lens), family="whisper",
                                whisper_prompt=prompt, eot_id=eot)
    got = teng.batch_to_device(_host_batch(tpipe, B=3, lens=lens), "cpu", family="whisper",
                               whisper_prompt=prompt, eot_id=eot)
    assert set(got) == set(want)
    for key in ("tokens", "targets", "labels", "label_lengths", "audio_lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == torch.int32
    P = len(prompt or twg.default_prompt())
    assert got["tokens"].shape[1] == P + max(lens) + 1
    assert (got["targets"] >= 0).sum(1).tolist() == [n + 1 for n in lens]


@pytest.mark.parametrize("kind", ["char", "unigram", "bpe"])
@pytest.mark.parametrize("family", ["whisper", "ctc"])
def test_build_tokenizer_for_gives_jaxs_vocabulary_and_sizing(kind, family, tmp_path):
    """Char and unigram vocabularies size Whisper's vocab to max(n + 8, 16)
    with prompt (n,) and EOT n + 1 (the CTC head to n); a BPE directory
    leaves the config as it is. The ids of every text equal JAX's."""
    texts = ["你好 世界", "世界真好", "你好朋友 er", "a b c"]
    rows_t = tman.Manifest([tman.ManifestRow(f"u{i}.wav", t, 1.0, "") for i, t in enumerate(texts)])
    rows_j = JManifest([JRow(f"u{i}.wav", t, 1.0, "") for i, t in enumerate(texts)])
    jc, tc = (c.ExperimentConfig(model_family=family) for c in (jcfg, tcfg))
    for c in (jc, tc):
        if kind == "unigram":
            JUni.train(texts * 3, vocab_size=20, max_piece_len=2).save(tmp_path / "u.json")
            c.data.unigram_vocab = str(tmp_path / "u.json")
        elif kind == "bpe":
            c.data.tokenizer_dir = str(_bpe_dir(tmp_path / "bpe"))
    want = jeng.build_tokenizer_for(jc, rows_j)
    got = teng.build_tokenizer_for(tc, rows_t)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want)
    for t in texts:
        assert got.encode(t) == want.encode(t), t
    assert dataclasses.asdict(tc.whisper) == dataclasses.asdict(jc.whisper)
    assert tc.ctc_model.vocab_size == jc.ctc_model.vocab_size
    if kind != "bpe" and family == "whisper":
        n = len(got)
        assert (tc.whisper.vocab_size, tc.whisper.prompt_ids, tc.whisper.eot_id) == \
            (max(n + 8, 16), (n,), n + 1)


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("kind,train", [("wf", False), ("wf", True), ("att", True),
                                        ("bottleneck", False)])
def test_whisper_loss_and_adapter_grads_match_jax(kind, train):
    """The loss within LOSS_REL_BAR and every adapter gradient within
    GRAD_REL_BAR of JAX's make_whisper_loss_fn under stop_gradient on the
    frozen leaves (build_train_setup's mask); no backbone gradient is
    formed. train=True runs the training mode with SpecAugment and dropout
    off, so both sides are deterministic."""
    jc, tc = _exp(jcfg, kind), _exp(tcfg, kind)
    params = _params(jc)
    jbatch = jeng.batch_to_device(_host_batch(jpipe), family="whisper", whisper_prompt=PROMPT,
                                  eot_id=EOT)
    jloss_fn = jeng.make_whisper_loss_fn(jc, JBundle._model(jc))
    mask = jeng.adapter_mask(params)

    def lf(p):
        p_eff = jax.tree_util.tree_map(lambda m, x: x if m else jax.lax.stop_gradient(x), mask, p)
        return jloss_fn(p_eff, jbatch, jax.random.PRNGKey(0), train)

    with jax.default_matmul_precision("highest"):
        (jl, _), jgrads = jax.value_and_grad(lf, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params))
    jgrads = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))

    model = _port_model(tc.whisper, params)
    teng.set_trainable(model, adapters_only=True)
    batch = teng.batch_to_device(_host_batch(tpipe), "cpu", family="whisper",
                                 whisper_prompt=PROMPT, eot_id=EOT)
    loss, metrics = teng.make_loss_fn(tc, model)(batch, (0, 0), train)
    loss.backward()
    assert set(metrics) == {"loss"}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_REL_BAR)
    named = dict(model.named_parameters())
    n_adapter = 0
    for path, g in jgrads.items():
        p = named[convert.whisper_torch_key(path)]
        if any(s.startswith("adapter_") for s in path):
            n_adapter += 1
            scale = max(np.abs(g).max(), 1e-12)
            np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_REL_BAR * scale, rtol=0,
                                       err_msg=str(path))
        else:
            assert p.grad is None and not p.requires_grad, path
    per_block = {"wf": (6 * 3, 10 * 3), "att": (2 * 6, 2 * 6), "bottleneck": (2 * 6, 2 * 6)}[kind]
    assert n_adapter == 2 * per_block[0] + 2 * per_block[1]


def test_four_steps_lower_the_loss_and_the_backbone_stays_bitwise():
    """Four AdamW steps on one batch lower the loss; under
    train_adapters_only every backbone tensor keeps its bits while every
    adapter tensor moves."""
    jc, tc = _exp(jcfg), _exp(tcfg, train=tcfg.TrainConfig(train_adapters_only=True))
    tc.train.optimizer = tcfg.OptimizerConfig(learning_rate=1e-2, warmup_steps=0,
                                              schedule="constant")
    model = _port_model(tc.whisper, _params(jc))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = teng.init_state(tc, model)
    step = teng.make_train_step(teng.make_loss_fn(tc, model), tc.train.optimizer)
    batch = teng.batch_to_device(_host_batch(tpipe), "cpu", family="whisper",
                                 whisper_prompt=PROMPT, eot_id=EOT)
    losses = [float(step(state, batch, False)["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]
    for key, v in model.state_dict().items():
        if param_is_adapter(key):
            assert not torch.equal(v, before[key]), key
        else:
            assert torch.equal(v, before[key]), key


# ---------------------------------------- fine_tune, cli train, resume, serve


def _corpus(tmp_path, n=6, seed=4):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        secs = 1.0 if i % 3 else 0.8
        write_wav(tmp_path / f"u{i}.wav", (0.1 * rng.randn(int(16000 * secs))).astype(np.float32),
                  16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 20, 2 + i % 4))
        rows.append(tman.ManifestRow(str(tmp_path / f"u{i}.wav"), text, secs, "jiaoliao"))
    tman.write_manifest(rows, tmp_path / "train.jsonl")
    return tmp_path / "train.jsonl"


def _train_cfg(tmp_path, manifest, kind="wf", total=4, dropout=0.1, specaugment=True):
    cfg = _exp(tcfg, kind)
    cfg.whisper = dataclasses.replace(cfg.whisper, dropout=dropout)
    cfg.specaugment = tcfg.SpecAugmentConfig(enabled=specaugment)
    cfg.data = tcfg.DataConfig(train_manifest=str(manifest), batch_size=2,
                               bucket_boundaries_seconds=(1.0,), max_audio_seconds=1.0,
                               min_audio_seconds=0.1, max_text_len=8, num_host_workers=2)
    cfg.train = tcfg.TrainConfig(
        optimizer=tcfg.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=total),
        train_adapters_only=True, checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every_steps=100, log_every_steps=1,
        metrics_path=str(tmp_path / "metrics.jsonl"))
    cfg.decode = tcfg.DecodeConfig(strategy="greedy", beam_size=2, max_decode_len=8)
    return cfg


def _served(final, wavs, int8=True):
    bundle = api.load(str(final), device="cpu")
    assert bundle.config.model_family == "whisper"
    runs = [bundle] + ([bundle.quantize()] if int8 else [])
    for b in runs:
        for strategy in ("greedy", "beam"):
            texts = api.transcribe(b, wavs, decode_cfg=dataclasses.replace(
                b.config.decode, strategy=strategy))
            assert len(texts) == len(wavs) and all(isinstance(t, str) for t in texts)
    return bundle


def test_fine_tune_writes_a_bundle_that_loads_and_transcribes(tmp_path):
    """api.fine_tune on a char vocab: Whisper's sizing, three steps, the
    final bundle equal to the trained model, served in bf16-less f32 and
    int8 by greedy and beam."""
    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=3)
    state, bundle = api.fine_tune(cfg, device="cpu")
    assert state.step == 3 and all(np.isfinite(state.info["losses"]))
    n = len(bundle.tokenizer)
    assert (cfg.whisper.vocab_size, cfg.whisper.prompt_ids, cfg.whisper.eot_id) == \
        (max(n + 8, 16), (n,), n + 1)
    records = [json.loads(s) for s in Path(cfg.train.metrics_path).read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3] and all("loss" in r for r in records)
    served = _served(tmp_path / "ckpt" / "final", [str(tmp_path / "u0.wav"),
                                                   str(tmp_path / "u1.wav")])
    assert served.config.whisper.vocab_size == cfg.whisper.vocab_size
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[k], v), k


LARGE_V3 = Path(__file__).resolve().parent.parent / "configs" / "whisper_large_v3_adapters.yaml"


def _large_v3_tiny_overrides(tmp_path, manifest, tokenizer_dir, unigram=""):
    """configs/whisper_large_v3_adapters.yaml cut to a CPU: tiny widths and
    depth, 1 s chunks, a few steps; the WF rank, mels and optimizer kept."""
    return [
        f"data.train_manifest={manifest}", f"data.tokenizer_dir={tokenizer_dir}",
        f"data.unigram_vocab={unigram}", "data.batch_size=2", "data.bucket_boundaries_seconds=[1.0]",
        "data.max_audio_seconds=1.0", "data.min_audio_seconds=0.1", "data.max_text_len=8",
        "data.num_host_workers=1", "frontend.chunk_seconds=1.0", "whisper.d_model=64",
        "whisper.encoder_layers=2", "whisper.decoder_layers=2", "whisper.num_heads=4",
        "whisper.mlp_dim=128", "whisper.max_target_positions=24", "whisper.vocab_size=272",
        "whisper.prompt_ids=[260,261]", "whisper.eot_id=259", "whisper.dtype=float32",
        "train.optimizer.total_steps=3", "train.optimizer.warmup_steps=1",
        f"train.checkpoint_dir={tmp_path / 'ckpt'}", f"train.metrics_path={tmp_path / 'm.jsonl'}",
        "train.log_every_steps=1", "decode.max_decode_len=8",
    ]


def test_cli_train_on_the_large_v3_config_writes_a_bundle_that_transcribes(tmp_path, capsys):
    """cli train --config configs/whisper_large_v3_adapters.yaml with tiny
    overrides, a byte-level BPE tokenizer_dir and --device cpu: WF rank 16
    trained for three steps; the bundle carries the BPE files, loads, and
    transcribes in f32 and int8."""
    manifest = _corpus(tmp_path)
    bpe = _bpe_dir(tmp_path / "bpe")
    argv = ["train", "--config", str(LARGE_V3), "--device", "cpu",
            *_large_v3_tiny_overrides(tmp_path, manifest, bpe)]
    assert cli.main(argv) == 0
    final = tmp_path / "ckpt" / "final"
    assert capsys.readouterr().out.strip().endswith(f"saved final bundle to {final} (step 3)")
    assert (final / "merges.txt").exists() and (final / "vocab.json").exists()
    bundle = _served(final, [str(tmp_path / "u0.wav"), str(tmp_path / "u2.wav")])
    assert isinstance(bundle.tokenizer, ByteLevelBPE) and len(bundle.tokenizer) == 262
    w = bundle.config.whisper
    assert (w.adapter.kind, w.adapter.wf_rank, w.vocab_size) == ("wf", 16, 272)
    trained = {k: v for k, v in bundle.model.state_dict().items() if k.endswith("adapter_wf.b")}
    assert trained and all(v.abs().sum() > 0 for v in trained.values())
    assert cli.main(["evaluate", "--manifest", str(manifest), "--checkpoint", str(final),
                     "--device", "cpu", "--int8"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["utterances"] == 6 and np.isfinite(out["cer"])


def test_killed_cli_train_of_a_tiny_whisper_resumes_bitwise(tmp_path, monkeypatch):
    """Dropout and SpecAugment on, a unigram vocab: a SIGTERM at the second
    step of ``cli train`` checkpoints and exits; ``cli train --resume``
    finishes with the bundle's parameters bitwise those of an uninterrupted
    run."""
    manifest = _corpus(tmp_path)
    texts = tman.read_manifest(manifest).texts()
    uni = TUni.train(texts, vocab_size=30, max_piece_len=2)
    uni.save(tmp_path / "u.json")
    eot = len(uni) + 1  # Whisper's sizing past the vocab

    def argv(name, *extra):
        cfg = _train_cfg(tmp_path / name, manifest)
        cfg.data.unigram_vocab = str(tmp_path / "u.json")
        tcfg.save_yaml(cfg, str(tmp_path / f"{name}.yaml"))
        return ["train", "--config", str(tmp_path / f"{name}.yaml"), "--device", "cpu", *extra]

    assert cli.main(argv("full")) == 0
    real = teng.batch_to_device
    calls = {"n": 0}

    def batch_then_sigterm(batch, device, **kw):
        assert kw == {"family": "whisper", "whisper_prompt": (len(uni),), "eot_id": eot}
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return real(batch, device, **kw)

    monkeypatch.setattr(teng, "batch_to_device", batch_then_sigterm)
    assert cli.main(argv("killed")) == 0
    assert tckpt.TrainCheckpointer(tmp_path / "killed" / "ckpt").latest_step() == 2
    monkeypatch.setattr(teng, "batch_to_device", real)
    assert cli.main(argv("killed", "--resume")) == 0
    assert tckpt.TrainCheckpointer(tmp_path / "killed" / "ckpt").latest_step() == 4
    full = convert.read_npz_params(tmp_path / "full" / "ckpt" / "final" / "params.npz")
    resumed = convert.read_npz_params(tmp_path / "killed" / "ckpt" / "final" / "params.npz")
    flat_f, flat_r = convert.flatten_params(full), convert.flatten_params(resumed)
    assert set(flat_f) == set(flat_r)
    for k, v in flat_f.items():
        np.testing.assert_array_equal(flat_r[k], v, err_msg=str(k))
    loaded = api.load(str(tmp_path / "killed" / "ckpt" / "final"), device="cpu")
    assert isinstance(loaded.tokenizer, TUni) and loaded.config.whisper.eot_id == eot


# -------------------------------------------------------- adapted inference


@pytest.mark.parametrize("kind", ["wf", "att", "bottleneck"])
def test_adapted_whisper_logits_match_jax(kind):
    """Teacher-forced logits of a WF-, Att- or bottleneck-adapted Whisper in
    eval mode (the port's serving route: K7's plain version for WF) within
    LOGIT_BAR of JAX's module path."""
    jc = _wcfg(jcfg, kind)
    params = _params(jcfg.ExperimentConfig(model_family="whisper", whisper=jc))
    jm = JWhisper(jc)
    rng = np.random.RandomState(2)
    mel = (0.3 * rng.randn(2, 80, 60)).astype(np.float32)
    toks = rng.randint(0, 50, (2, 7)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    model = _port_model(_wcfg(tcfg, kind), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 7, 50)
    assert np.abs(got - want).max() < LOGIT_BAR


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_att_slot_cached_decode_steps_equal_teacher_forcing(layout):
    """An Att-adapted Whisper decodes over its slot caches: each cached
    step's logits within STEP_BAR of the teacher-forced pass, in both cache
    layouts; the slot caches' shapes are the JAX init_cache's."""
    jc = _wcfg(jcfg, "att")
    params = _params(jcfg.ExperimentConfig(model_family="whisper", whisper=jc))
    model = _port_model(_wcfg(tcfg, "att"), params).eval()
    rng = np.random.RandomState(5)
    mel = torch.from_numpy((0.3 * rng.randn(2, 80, 60)).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, 50, (2, 6)))
    with torch.no_grad():
        enc = model.encode(mel)
        full = model.decode(toks, enc)
        caches = model.init_cache(2, enc, 10, layout)
        for pos in range(6):
            logits, caches = model.decode_step(toks[:, pos:pos + 1], pos, enc, caches)
            np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=STEP_BAR)
    jm = JWhisper(jc)
    monkey = 1 if layout == "head_major" else 1 << 30
    old = jlayers.HEAD_MAJOR_MIN_BATCH
    jlayers.HEAD_MAJOR_MIN_BATCH = monkey
    try:
        jcache = jm.apply({"params": params}, 2, jnp.asarray(enc.numpy()), 10,
                          method=jm.init_cache)
    finally:
        jlayers.HEAD_MAJOR_MIN_BATCH = old
    for i in range(2):
        slots = caches[f"block_{i}"]["slots"]
        for s in ("post_attn", "post_mlp"):
            att = getattr(model.decoder.blocks[i], f"{s}_slot").adapter_att
            for n in ("k", "v"):
                assert tuple(slots[s][n].shape) == jcache[f"block_{i}"]["slots"][s][n].shape \
                    == att.cache_shape(2, slots[s][n].shape[1])
    # a beam carries the slot caches along its hypotheses: a beam of one
    # is greedy, and two beams stay finite
    with torch.no_grad():
        g, gl = twg.greedy_from_enc(model, enc, None, 10, PROMPT, EOT, layout=layout)
        b, bl, _ = twg.beam_from_enc(model, enc, None, 1, 10, PROMPT, EOT, layout=layout)
        np.testing.assert_array_equal(b[:, 0].numpy(), g.numpy())
        _, _, scores = twg.beam_from_enc(model, enc, None, 2, 10, PROMPT, EOT, layout=layout)
    assert torch.isfinite(scores[:, 0]).all()


# -------------------------------------------------------------- int8 serving

Q_SMALL = dict(vocab_size=300, d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
               mlp_dim=256, max_target_positions=24, use_flash_attention=False)


def _jax_tpu_routes(monkeypatch):
    """The JAX package's TPU dispatch on the CPU: the int8 kernels in
    interpret mode (rows <= MAX_KERNEL_ROWS), the XLA functions beyond
    (tests/test_torch_quant.py's helper)."""
    monkeypatch.setattr(jlayers, "_on_tpu", lambda: True)

    def int8_matmul(x, q, scale):
        lead = x.shape[:-1]
        rows = int(np.prod(lead))
        if rows > jq.MAX_KERNEL_ROWS:
            return jq._int8_matmul_xla(x, q, scale)
        y = jq._int8_matmul_pallas(x.reshape(rows, x.shape[-1]), q, scale)
        return y.reshape(*lead, q.shape[1]).astype(x.dtype)

    def int8_tied_logits(x, q_vd, scale_v):
        if x.shape[0] > jq.MAX_KERNEL_ROWS:
            return jq._int8_tied_logits_xla(x, q_vd, scale_v)
        return jq._int8_tied_logits_pallas(x, q_vd, scale_v)

    monkeypatch.setattr(jq, "int8_matmul", int8_matmul)
    monkeypatch.setattr(jq, "int8_tied_logits", int8_tied_logits)


@pytest.mark.parametrize("layout", [None, "head_major"])
def test_int8_greedy_of_a_wf_adapted_whisper_equals_jaxs(monkeypatch, layout):
    """quantize() of a WF-adapted bf16 Whisper keeps each insert beside its
    int8 layer (bitwise JAX's quantized tree through the bridge), and its
    greedy tokens from one encoder output equal JAX's quantized
    greedy_from_enc on its TPU routes (interpret mode): int8 cross caches
    with bf16 self caches, and all-int8 caches."""
    ad = ADAPTERS["wf"]
    jw = jcfg.WhisperConfig(dtype="bfloat16", adapter=jcfg.AdapterConfig(**ad), **Q_SMALL)
    jexp = jcfg.ExperimentConfig(model_family="whisper", whisper=jw)
    params = _params(jexp, seed=3)
    jm = JWhisper(jw)
    qparams = JBundle(config=jexp, params=params, tokenizer=None).quantize().params
    _jax_tpu_routes(monkeypatch)
    if layout == "head_major":
        monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1)
    mel = (np.random.RandomState(7).randn(2, 80, 60) * 0.3).astype(np.float32)
    enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    enc_t = torch.from_numpy(np.asarray(enc, np.float32)).to(torch.bfloat16)
    want, want_len = jwg.greedy_from_enc(jm, qparams, enc, None, max_len=16, prompt=PROMPT,
                                         eot_id=EOT)
    tw = tcfg.WhisperConfig(dtype="bfloat16", prompt_ids=PROMPT, eot_id=EOT,
                            adapter=tcfg.AdapterConfig(**ad), **Q_SMALL)
    model = _port_model(tw, params).eval()
    layers.cast_for_serving(model, torch.bfloat16)
    bundle = ModelBundle(tcfg.ExperimentConfig(model_family="whisper", whisper=tw), model, None)
    qmodel = bundle.quantize().model
    got_state = qmodel.state_dict()
    for key, t in convert.whisper_params_to_state_dict(qparams).items():
        assert torch.equal(got_state[key], t), key
    assert sum(isinstance(m, layers.Int8Dense) and hasattr(m, "adapter_wf")
               for m in qmodel.decoder.modules()) == 2 * 10
    got, got_len = twg.greedy_from_enc(qmodel, enc_t, None, 16, PROMPT, EOT, layout=layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert len(set(got.numpy().ravel().tolist())) > 1


def test_adapter_only_npz_round_trips_a_whisper_model_with_jax(tmp_path):
    """save_adapter_only of a WF-adapted Whisper writes JAX's keys and
    arrays; JAX's own adapter-only npz loads back into the port."""
    from jiao_liao_speech_recognition_tpu.train import checkpoints as jckpt

    jc = _exp(jcfg, "att")
    params = _params(jc)
    model = _port_model(_wcfg(tcfg, "att"), params)
    tckpt.save_adapter_only(str(tmp_path / "t.npz"), model)
    jckpt.save_adapter_only(str(tmp_path / "j.npz"), params)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) and len(t.files) > 0
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    fresh = _port_model(_wcfg(tcfg, "att"), JBundle._init_params(jc, seed=0))
    tckpt.load_adapter_only(str(tmp_path / "j.npz"), fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
