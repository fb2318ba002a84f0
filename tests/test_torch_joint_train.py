"""The port's joint CTC/attention training against the JAX package's:
``batch_to_device(..., family="joint")`` tokens and targets, the hybrid
loss (loss, loss_ctc, loss_att) and the adapter gradients of
``make_joint_loss_fn`` in eval and train mode, the CE's precision rule in
bf16, four steps that lower the loss, the frozen backbone, ``api.fine_tune``
and ``cli train`` writing a bundle that loads and transcribes, a killed run
resumed bit for bit, and ``run_stages`` on a joint config step for step.
Tiny models (tests/test_joint.py's ``tiny_cfg`` with a WF adapter of rank
2) in float32 with dropout 0 and SpecAugment off where the port is held to
JAX; the same seeded numpy inputs and, through the joint weight bridge, the
same weights on both sides; the JAX side at "highest" matmul precision."""

import dataclasses
import json
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import engine as jeng  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import schedules as jsched  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api, cli  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter  # noqa: E402
from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel  # noqa: E402
from jiao_liao_speech_recognition_torch.train import checkpoints as tckpt  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.train import schedules as tsched  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

TINY = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2,
            mlp_dim=64, conv_channels=16, dropout=0.0, dtype="float32",
            use_flash_attention=False, max_target_positions=32, ctc_weight=0.3)
WF = dict(kind="wf", wf_rank=2)
# f32 at "highest" precision: the same arithmetic in both packages, sums
# reordered, from features that already differ by ~1e-6 (two f32 log-mel
# implementations). Losses within LOSS_REL_BAR; each adapter gradient within
# GRAD_REL_BAR of that gradient's largest magnitude; after run_stages every
# parameter within PARAM_BAR of its largest magnitude.
LOSS_REL_BAR = 1e-5
GRAD_REL_BAR = 1e-4
PARAM_BAR = 1e-5
# the CE in bf16: both sides round each op to bf16; XLA may keep a fused
# intermediate in f32, so allow one bf16 ulp of the value
CE_BF16_ULPS = 1.0


def _exp(c, **kw):
    return c.ExperimentConfig(
        model_family="joint", joint=c.JointModelConfig(**TINY, adapter=c.AdapterConfig(**WF)),
        frontend=c.FrontendConfig(chunk_seconds=1.0),
        specaugment=c.SpecAugmentConfig(enabled=False), **kw)


def _params(jc, seed=0):
    """JAX init with the WF inserts moved off their identity (zero B)."""
    params = JBundle._init_params(jc, seed=seed)
    noise = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 0.05 * noise.randn(*v.shape)).astype(np.float32)
        if any("adapter_" in str(getattr(k, "key", "")) for k in path) else np.asarray(v),
        params)


def _port_model(tc, params):
    model = JointCTCAttentionModel(tc.joint)
    model.load_state_dict(convert.joint_params_to_state_dict(params))
    return model


def _host_batch(mod, B=2, seed=0, lens=(7, 4), samples=16000):
    rng = np.random.RandomState(seed)
    S = max(lens)
    labels = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.randint(2, 32, n)
    return mod.Batch(audio=(0.1 * rng.randn(B, samples)).astype(np.float32),
                     audio_lengths=np.asarray([samples, samples - 5000][:B], np.int32),
                     labels=labels, label_lengths=np.asarray(lens, np.int32),
                     texts=[""] * B, bucket_seconds=1.0)


# ------------------------------------------------------------ teacher forcing


@pytest.mark.parametrize("lens", [(7, 0, 3), (1, 5, 5), (9, 9, 2)])
def test_batch_to_device_joint_tokens_and_targets_are_jaxs(lens):
    want = jeng.batch_to_device(_host_batch(jpipe, B=3, lens=lens), family="joint")
    got = teng.batch_to_device(_host_batch(tpipe, B=3, lens=lens), "cpu", family="joint")
    assert set(got) == set(want)
    for key in ("tokens", "targets", "labels", "label_lengths", "audio_lengths"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert got[key].dtype == torch.int32
    assert int(got["tokens"][0, 0]) == 0  # sos = the blank
    assert "tokens" not in teng.batch_to_device(_host_batch(tpipe), "cpu")  # ctc: none
    # the whisper family is ported too: its default prompt and EOT, as JAX's
    want = jeng.batch_to_device(_host_batch(jpipe, B=3, lens=lens), family="whisper")
    got = teng.batch_to_device(_host_batch(tpipe, B=3, lens=lens), "cpu", family="whisper")
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("train", [False, True])
def test_joint_loss_and_adapter_grads_match_jax(train):
    """The three losses within LOSS_REL_BAR and every adapter gradient
    within GRAD_REL_BAR of JAX's make_joint_loss_fn under stop_gradient on
    the frozen leaves (build_train_setup's mask); no backbone gradient is
    formed."""
    jc, tc = _exp(jcfg), _exp(tcfg)
    params = _params(jc)
    jbatch = jeng.batch_to_device(_host_batch(jpipe), family="joint")
    jloss_fn = jeng.make_joint_loss_fn(jc, JBundle._model(jc))
    mask = jeng.adapter_mask(params)

    def lf(p):
        p_eff = jax.tree_util.tree_map(lambda m, x: x if m else jax.lax.stop_gradient(x), mask, p)
        return jloss_fn(p_eff, jbatch, jax.random.PRNGKey(0), train)

    with jax.default_matmul_precision("highest"):
        (_, jm), jgrads = jax.value_and_grad(lf, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params))
    jgrads = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))

    model = _port_model(tc, params)
    teng.set_trainable(model, adapters_only=True)
    batch = teng.batch_to_device(_host_batch(tpipe), "cpu", family="joint")
    loss, metrics = teng.make_joint_loss_fn(tc, model)(batch, (0, 0), train)
    loss.backward()
    for key in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=LOSS_REL_BAR,
                                   err_msg=key)
    named = dict(model.named_parameters())
    n_adapter = 0
    for path, g in jgrads.items():
        p = named[convert.joint_torch_key(path)]
        if any(s.startswith("adapter_") for s in path):
            n_adapter += 1
            scale = max(np.abs(g).max(), 1e-12)
            np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_REL_BAR * scale, rtol=0,
                                       err_msg=str(path))
        else:
            assert p.grad is None and not p.requires_grad, path
    # (2 encoder blocks x 6 + 2 decoder blocks x 10) WF Dense layers x (a, g, b)
    assert n_adapter == (2 * 6 + 2 * 10) * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_follows_optax_precision(dtype):
    """optax computes the CE in the logits' dtype: the port's CE on bf16
    logits is bf16 and within CE_BF16_ULPS of optax's; in f32 within 1e-6."""
    rng = np.random.RandomState(3)
    logits = (3.0 * rng.randn(4, 9, 50)).astype(np.float32)
    targets = rng.randint(0, 50, (4, 9)).astype(np.int32)
    jl = jnp.asarray(logits).astype(dtype)
    want = np.asarray(optax.softmax_cross_entropy_with_integer_labels(jl, jnp.asarray(targets))
                      .astype(jnp.float32))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = teng.cross_entropy_like_optax(tl, torch.from_numpy(targets))
    assert got.dtype == tl.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (np.abs(got.float().numpy() - want) / ulp).max() <= CE_BF16_ULPS


# ------------------------------------------------------------- train steps


def test_four_steps_lower_the_loss_and_the_backbone_stays_bitwise():
    """JAX's test_joint_loss_and_train_step on the port: four AdamW steps on
    one batch lower the loss, loss = w * loss_ctc + (1 - w) * loss_att, and
    under train_adapters_only every backbone tensor keeps its bits while
    every adapter tensor moves."""
    jc, tc = _exp(jcfg), _exp(tcfg, train=tcfg.TrainConfig(train_adapters_only=True))
    tc.train.optimizer = tcfg.OptimizerConfig(learning_rate=1e-2, warmup_steps=0,
                                              schedule="constant")
    model = _port_model(tc, _params(jc))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = teng.init_state(tc, model)
    step = teng.make_train_step(teng.make_loss_fn(tc, model), tc.train.optimizer)
    batch = teng.batch_to_device(_host_batch(tpipe), "cpu", family="joint")
    losses = []
    for _ in range(4):
        m = step(state, batch, False)
        losses.append(float(m["loss"]))
        assert {"loss", "loss_ctc", "loss_att", "grad_norm"} <= set(m)
    w = tc.joint.ctc_weight
    np.testing.assert_allclose(losses[-1], w * float(m["loss_ctc"])
                               + (1 - w) * float(m["loss_att"]), rtol=1e-5)
    assert losses[-1] < losses[0]
    for key, v in model.state_dict().items():
        if param_is_adapter(key):
            assert not torch.equal(v, before[key]), key
        else:
            assert torch.equal(v, before[key]), key


# ------------------------------------------- fine_tune, cli train, resume


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


def _train_cfg(tmp_path, manifest, total=4, dropout=0.1, specaugment=True):
    cfg = _exp(tcfg)
    cfg.joint = dataclasses.replace(cfg.joint, dropout=dropout)
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


def _served(ckpt, wavs):
    bundle = api.load(str(ckpt / "final"), device="cpu")
    assert bundle.config.model_family == "joint" and bundle.config.joint.adapter.kind == "wf"
    out = {s: api.transcribe(bundle, wavs, decode_cfg=dataclasses.replace(
        bundle.config.decode, strategy=s)) for s in ("ctc_greedy", "greedy", "beam")}
    assert all(len(t) == len(wavs) and all(isinstance(x, str) for x in t) for t in out.values())
    return bundle


@pytest.mark.parametrize("entry", ["api", "cli"])
def test_fine_tune_and_cli_train_write_a_bundle_that_loads_and_transcribes(tmp_path, entry,
                                                                            capsys):
    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=3)
    if entry == "api":
        state, bundle = api.fine_tune(cfg, device="cpu")
        assert state.step == 3 and all(np.isfinite(state.info["losses"]))
        trained = bundle.model.state_dict()
    else:
        tcfg.save_yaml(cfg, str(tmp_path / "joint.yaml"))
        assert cli.main(["train", "--config", str(tmp_path / "joint.yaml"), "--device",
                         "cpu"]) == 0
        assert capsys.readouterr().out.strip().endswith(
            f"saved final bundle to {tmp_path / 'ckpt' / 'final'} (step 3)")
        trained = None
    records = [json.loads(s) for s in Path(cfg.train.metrics_path).read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all({"loss", "loss_ctc", "loss_att"} <= set(r) for r in records)
    served = _served(tmp_path / "ckpt", [str(tmp_path / "u0.wav"), str(tmp_path / "u1.wav")])
    assert served.config.joint.vocab_size == len(served.tokenizer)
    if trained is not None:
        for k, v in trained.items():
            assert torch.equal(served.model.state_dict()[k], v), k


def test_killed_joint_run_resumes_bitwise(tmp_path, monkeypatch):
    """Dropout and SpecAugment on: a SIGTERM at the second step checkpoints
    and exits; resume=True finishes with parameters bitwise those of an
    uninterrupted run, and the same losses for the steps it took."""
    manifest = _corpus(tmp_path)
    m = tman.read_manifest(manifest)

    def run(name, resume=False):
        cfg = _train_cfg(tmp_path / name, manifest)
        tok = teng.build_tokenizer_for(cfg, m)
        model = teng.make_model(cfg, "cpu")
        return teng.train_loop(cfg, m, tok, model, resume=resume), model

    (_, full_info), full = run("full")
    real = teng.batch_to_device
    calls = {"n": 0}

    def batch_then_sigterm(batch, device, **kw):
        assert kw == {"family": "joint"}
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return real(batch, device, **kw)

    monkeypatch.setattr(teng, "batch_to_device", batch_then_sigterm)
    (state, info), _ = run("killed")
    assert info["terminated"] and state.step == 2
    monkeypatch.setattr(teng, "batch_to_device", real)
    (state, info), resumed = run("killed", resume=True)
    assert state.step == 4 and info["losses"] == full_info["losses"][2:]
    for (k, a), (_, b) in zip(full.state_dict().items(), resumed.state_dict().items()):
        assert torch.equal(a, b), k
    assert tckpt.TrainCheckpointer(tmp_path / "killed" / "ckpt").latest_step() == 4


# ------------------------------------------------------------- run_stages


def _stage_corpus(d, tag, n, seed):
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        write_wav(d / f"{tag}{i}.wav", (0.1 * rng.randn(16000)).astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 16, 2 + i % 3))
        rows.append(tman.ManifestRow(str(d / f"{tag}{i}.wav"), text, 1.0, tag))
    tman.write_manifest(rows, d / f"{tag}.jsonl")
    return str(d / f"{tag}.jsonl")


def _stage_cfg(c, tmp_path, name, paths):
    cfg = _exp(c)
    cfg.data = c.DataConfig(batch_size=2, bucket_boundaries_seconds=(1.5,),
                            min_audio_seconds=0.1, max_text_len=8, num_host_workers=1)
    cfg.train = c.TrainConfig(
        optimizer=c.OptimizerConfig(name="sgd", learning_rate=0.05, warmup_steps=0,
                                    schedule="constant"),
        checkpoint_dir=str(tmp_path / name / "ckpt"), checkpoint_every_steps=100,
        log_every_steps=1, metrics_path=str(tmp_path / name / "metrics.jsonl"))
    cfg.stages = (
        c.DialectStage(name="neighbor", manifests=(paths[0], paths[1]), steps=2,
                       train_adapters_only=False, mix_weights=(1.0, 2.0)),
        c.DialectStage(name="target", manifests=(paths[2],), steps=2, train_adapters_only=True),
    )
    return cfg


def test_run_stages_on_a_joint_config_matches_jax(tmp_path):
    """Two stages of a joint config (the whole model, then the adapters),
    the same initial weights and vocabulary: the joint vocabulary is sized
    as JAX sizes it, per-step losses and the final parameters agree, and
    stage 2 leaves the backbone bitwise as stage 1 ended."""
    paths = [_stage_corpus(tmp_path / "data", tag, 4, seed)
             for tag, seed in (("jilu", 1), ("zhongyuan", 2), ("jiaoliao", 3))]
    jc = _stage_cfg(jcfg, tmp_path, "jax", paths)
    tc = _stage_cfg(tcfg, tmp_path, "torch", paths)
    texts = [t for s in jc.stages for t in jsched.build_stage_manifest(s).texts()]
    jtok = JTok.build(texts)
    jc.joint.vocab_size = len(jtok)
    params = _params(jc)
    with jax.default_matmul_precision("highest"):
        jparams, _, jhist = jsched.run_stages(jc, params=params, tokenizer=jtok)
    tc.joint.vocab_size = len(jtok)
    model = _port_model(tc, params)
    model, ttok, thist = tsched.run_stages(tc, model=model, tokenizer=TTok(jtok.vocab),
                                           device="cpu")
    assert tc.joint.vocab_size == len(ttok) == jc.joint.vocab_size

    def losses(path):
        return [json.loads(s)["loss"] for s in Path(path).read_text().splitlines()
                if "stage" not in json.loads(s)]

    tl, jl = losses(tc.train.metrics_path), losses(jc.train.metrics_path)
    assert len(tl) == 4
    np.testing.assert_allclose(tl, jl, rtol=LOSS_REL_BAR)
    assert [h["stage"] for h in thist] == [h["stage"] for h in jhist]
    want = convert.joint_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=PARAM_BAR * scale, rtol=0,
                                   err_msg=key)
    stage1 = torch.load(Path(tc.train.checkpoint_dir) / "stage_0_neighbor" / "00000002"
                        / "state.pt", weights_only=False)["model"]
    for key, v in got.items():
        if not param_is_adapter(key):
            assert torch.equal(v, stage1[key]), key
