"""The port's training slice against the JAX package: CTC loss, schedule,
optimizer, adapters, one model-level train step, SpecAugment and dropout,
the data pipeline, checkpoints with exact resume, the weight bridge with
adapters, adapter interchange between the packages, and the CER/WER twin.
Inputs come from numpy seeds; tiny models (2 layers, d=128) in float32 at
"highest" matmul precision, where the point is the algorithm."""

import dataclasses
import importlib
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import manifest as jman  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.evals import metrics as jmetrics  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import specaugment as jspec  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import checkpoints as jckpt  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import engine as jeng  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.evals import metrics as tmetrics  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import specaugment as tspec  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.layers import Dropout  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import ctc_loss as tctc  # noqa: E402
from jiao_liao_speech_recognition_torch.train import checkpoints as tckpt  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# the JAX ops package re-exports the function under the module's name
jctc = importlib.import_module("jiao_liao_speech_recognition_tpu.ops.ctc_loss")

TINY = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256, conv_channels=64,
            vocab_size=30, dtype="float32", dropout=0.0)
# f32 at "highest" precision: the same arithmetic in both packages, sums
# reordered (log-probs of O(1..10) over 2 blocks)
LOGP_BAR = 1e-4
# loss relative bar and per-parameter gradient bar (relative to the
# gradient's largest magnitude) for one train step: each gradient is a sum
# over every frame of the batch, taken in another order, from features that
# already differ by ~1e-6 (two f32 log-mel implementations)
LOSS_REL_BAR = 1e-5
GRAD_REL_BAR = 5e-4
# optimizer updates of O(lr) in f32: AdamW's sqrt/division in another order
PARAM_BAR = 1e-6


def _jax_model(adapter=None, **kw):
    ad = jcfg.AdapterConfig(**(adapter or {}))
    cfg = jcfg.CTCModelConfig(**dict(TINY, **kw), adapter=ad)
    model = JModel(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64), jnp.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, adapter=None, **kw):
    ad = tcfg.AdapterConfig(**(adapter or {}))
    model = CTCEncoderModel(tcfg.CTCModelConfig(**dict(TINY, **kw), adapter=ad))
    model.load_state_dict(convert.params_to_state_dict(params))
    return model


def _perturb_adapters(params, seed):
    """Nonzero values for every adapter leaf, so each insert matters."""
    rng = np.random.RandomState(seed)
    flat = convert.flatten_params(params)
    out = {}
    for path, v in flat.items():
        if any(p.startswith("adapter_") for p in path):
            v = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def _feats(B=2, secs=2.0, seed=0):
    from jiao_liao_speech_recognition_tpu.frontend import features as jf

    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(B, int(16000 * secs))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        return np.array(jf.log_mel_spectrogram(jnp.asarray(wav)))


# --------------------------------------------------------------- CTC loss


def test_ctc_loss_value_and_grad_match_jax_including_infeasible():
    rng = np.random.RandomState(1)
    B, T, V, S = 4, 20, 9, 6
    logits = rng.randn(B, T, V).astype(np.float32)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeat: needs a blank between
    T_lens = np.asarray([20, 13, 20, 4], np.int32)
    L_lens = np.asarray([6, 4, 0, 6], np.int32)  # row 3: 6 labels in 4 frames
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))

    def jloss(x):
        return jctc.ctc_loss(x, jnp.asarray(T_lens), jnp.asarray(labels), jnp.asarray(L_lens))

    want = np.asarray(jloss(jnp.asarray(lp)))
    feasible = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jloss(x) * feasible))(jnp.asarray(lp)))
    x = torch.from_numpy(lp).requires_grad_(True)
    got = tctc.ctc_loss(x, *map(torch.from_numpy, (T_lens, labels, L_lens)))
    # feasible rows: the same NLL (f32 sums in another order); the
    # infeasible row: the JAX recursion's floor, 1e30, exactly
    np.testing.assert_allclose(got.detach().numpy()[:3], want[:3], rtol=1e-5)
    assert want[3] == np.float32(1e30) and got[3].item() == want[3]
    (got * torch.from_numpy(feasible)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=1e-5, rtol=0)
    assert np.all(x.grad.numpy()[3] == 0.0)  # no gradient from the floor


# ----------------------------------------------------- schedule, optimizer


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant", "noam"])
def test_schedule_matches_optax(schedule):
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=50, schedule=schedule)
    want = jeng.make_schedule(jcfg.OptimizerConfig(**kw))
    got = teng.make_schedule(tcfg.OptimizerConfig(**kw))
    # optax evaluates in f32: within one f32 ulp of the peak rate (the cosine
    # tail, 1 + cos(...) near 0, cancels in f32 and not in the port's f64)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1.2e-7 * 3e-4)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_updates_match_optax_with_clip_and_mask(name):
    """Three updates on the same gradients: only trainable leaves move,
    the global-norm clip sees trainable leaves only (the second leaf's
    large frozen gradient would otherwise dominate)."""
    cfg_kw = dict(name=name, learning_rate=1e-2, warmup_steps=1, total_steps=10,
                  weight_decay=0.1, grad_clip_norm=0.5)
    rng = np.random.RandomState(2)
    p0 = {"adapter_a": rng.randn(3, 4).astype(np.float32),
          "frozen": rng.randn(5).astype(np.float32),
          "adapter_b": rng.randn(4).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in p0.items()}
             for s in (1.0, 0.01, 3.0)]
    for g in grads:
        g["frozen"] *= 100.0
    mask = {k: k.startswith("adapter") for k in p0}
    tx = jeng.make_optimizer(jcfg.OptimizerConfig(**cfg_kw), mask)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    tparams["frozen"].requires_grad_(False)
    opt_cfg = tcfg.OptimizerConfig(**cfg_kw)
    tstate = teng.TrainState(0, None, teng.make_optimizer(
        opt_cfg, [tparams["adapter_a"], tparams["adapter_b"]]), torch.Generator())
    sched = teng.make_schedule(opt_cfg)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in ("adapter_a", "adapter_b"):
            tparams[k].grad = torch.from_numpy(g[k].copy())
        tstate.step += 1
        teng.apply_update(tstate, opt_cfg, sched)
        for k in p0:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=PARAM_BAR, rtol=0, err_msg=k)
    assert np.array_equal(tparams["frozen"].detach().numpy(), p0["frozen"])
    assert not np.allclose(tparams["adapter_a"].detach().numpy(), p0["adapter_a"])


def test_grad_accumulation_averages_like_optax_multisteps():
    cfg_kw = dict(name="adam", learning_rate=1e-2, warmup_steps=0, schedule="constant",
                  grad_accum_steps=2, grad_clip_norm=10.0)
    rng = np.random.RandomState(3)
    p0 = rng.randn(6).astype(np.float32)
    gs = [rng.randn(6).astype(np.float32) for _ in range(4)]
    tx = jeng.make_optimizer(jcfg.OptimizerConfig(**cfg_kw))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    opt_cfg = tcfg.OptimizerConfig(**cfg_kw)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    tstate = teng.TrainState(0, None, teng.make_optimizer(opt_cfg, [p]), torch.Generator())
    sched = teng.make_schedule(opt_cfg)
    for i, g in enumerate(gs):
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy()) if p.grad is None else p.grad + torch.from_numpy(g)
        tstate.step += 1
        if tstate.step % 2 == 0:
            teng.apply_update(tstate, opt_cfg, sched)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=PARAM_BAR, rtol=0)


# ------------------------------------------------------------- adapters


KINDS = {
    "wf": dict(kind="wf", wf_rank=4),
    "att": dict(kind="att", att_num_heads=2, att_key_dim=64, dropout=0.0),
    "bottleneck": dict(kind="bottleneck", bottleneck_dim=16, dropout=0.0),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_adapted_model_matches_flax_in_serving_and_module_paths(kind):
    """Every adapter leaf perturbed: the port's serving path (eval, no
    grad: K7 / plain sublayers, slots) and its module path (train mode,
    dropout 0, under autograd) both give the JAX model's log-probs."""
    jmodel, params = _jax_model(KINDS[kind])
    params = _perturb_adapters(params, seed=4)
    feats = _feats(seed=4)
    flens = np.asarray([200, 120], np.int32)
    with jax.default_matmul_precision("highest"):
        want, wl = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens))
    want, wl = np.asarray(want), np.asarray(wl)
    valid = np.arange(want.shape[1])[None, :] < wl[:, None]
    model = _port_model(params, KINDS[kind]).eval()
    with torch.no_grad():
        got, _ = model(torch.from_numpy(feats), torch.from_numpy(flens))
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=LOGP_BAR, rtol=0)
    model.train()
    got_m, _ = model(torch.from_numpy(feats), torch.from_numpy(flens))
    assert got_m.requires_grad
    np.testing.assert_allclose(got_m.detach().numpy()[valid], want[valid], atol=LOGP_BAR, rtol=0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_zero_initialised_adapters_are_the_exact_identity(kind):
    _, params = _jax_model()
    base = _port_model(params).eval()
    model = CTCEncoderModel(tcfg.CTCModelConfig(**TINY, adapter=tcfg.AdapterConfig(**KINDS[kind])))
    state = model.state_dict()
    state.update(base.state_dict())  # same backbone, adapters at their init
    model.load_state_dict(state)
    model.eval()
    feats = torch.from_numpy(_feats(seed=5))
    with torch.no_grad():
        assert torch.equal(model(feats)[0], base(feats)[0])
    model.train()
    base.train()
    assert torch.equal(model(feats)[0], base(feats)[0])


# ----------------------------------------------------- one train step


def _batch(B=2, secs=2.0, seed=6, vocab=30):
    rng = np.random.RandomState(seed)
    audio = (0.1 * rng.randn(B, int(16000 * secs))).astype(np.float32)
    return {"audio": audio, "audio_lengths": np.asarray([32000, 21000], np.int32),
            "labels": rng.randint(1, vocab, (B, 7)).astype(np.int32),
            "label_lengths": np.asarray([7, 4], np.int32)}


def test_one_wf_train_step_matches_jax_and_freezes_the_backbone():
    """f32, dropout and SpecAugment off, WF rank 4: the loss and every
    adapter gradient equal the JAX loss_fn under stop_gradient on frozen
    leaves; after the AdamW step the adapters equal optax's and the
    backbone is bitwise unchanged."""
    wf = dict(kind="wf", wf_rank=4)
    jmodel, params = _jax_model(wf)
    params = _perturb_adapters(params, seed=7)
    opt = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")

    def exp(c):
        return c.ExperimentConfig(
            ctc_model=c.CTCModelConfig(**TINY, adapter=c.AdapterConfig(**wf)),
            specaugment=c.SpecAugmentConfig(enabled=False),
            train=c.TrainConfig(optimizer=c.OptimizerConfig(**opt), train_adapters_only=True))

    jc, tc = exp(jcfg), exp(tcfg)
    batch = _batch()
    jloss_fn = jeng.make_ctc_loss_fn(jc, jmodel)
    mask = jeng.adapter_mask(params)

    def lf(p):
        p_eff = jax.tree_util.tree_map(lambda m, x: x if m else jax.lax.stop_gradient(x), mask, p)
        return jloss_fn(p_eff, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0), True)[0]

    with jax.default_matmul_precision("highest"):
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        want_loss, jgrads = jax.value_and_grad(lf)(jparams)
        tx = jeng.make_optimizer(jc.train.optimizer, mask)
        upd, _ = tx.update(jgrads, tx.init(jparams), jparams)
        jnew = convert.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                             optax.apply_updates(jparams, upd)))
    jgrads = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))

    model = _port_model(params, wf)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = teng.init_state(tc, model)
    loss, _ = teng.make_ctc_loss_fn(tc, model)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, (0, 0), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_REL_BAR)
    named = dict(model.named_parameters())
    n_adapter = 0
    for path, g in jgrads.items():
        p = named[convert.torch_key(path)]
        if any(s.startswith("adapter_") for s in path):
            n_adapter += 1
            scale = max(np.abs(g).max(), 1e-12)
            np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_REL_BAR * scale, rtol=0,
                                       err_msg=str(path))
        else:
            assert p.grad is None and not p.requires_grad, path  # no backbone dW formed
    assert n_adapter == 2 * 6 * 3  # 2 blocks x 6 WF Dense layers x (a, g, b)
    state.step = 1
    teng.apply_update(state, tc.train.optimizer, teng.make_schedule(tc.train.optimizer))
    # AdamW's first update is lr * g / (|g| + eps): where |g| clears the
    # gradient bar its sign is settled and the parameters agree within
    # PARAM_BAR; on near-zero gradients the two differ by at most one step
    for key, v in model.state_dict().items():
        path = convert.flax_path(key)
        if any(s.startswith("adapter_") for s in path):
            g = jgrads[path]
            settled = np.abs(g) > 2 * GRAD_REL_BAR * max(np.abs(g).max(), 1e-12)
            diff = np.abs(v.numpy() - jnew[path])
            assert diff[settled].max(initial=0) <= PARAM_BAR, path
            assert diff.max() <= 2 * opt["learning_rate"], path
        else:
            assert torch.equal(v, before[key]), key


# ------------------------------------------------- SpecAugment, dropout


def test_specaugment_distribution_matches_jax():
    cfg_kw = dict(num_freq_masks=2, freq_mask_width=27, num_time_masks=2, time_mask_fraction=0.05)
    B, M, T = 256, 80, 300
    feats = np.ones((B, M, T), np.float32)
    want = np.asarray(jspec.spec_augment(jax.random.PRNGKey(0), jnp.asarray(feats),
                                         jcfg.SpecAugmentConfig(**cfg_kw)))
    got = tspec.spec_augment(torch.Generator().manual_seed(0), torch.from_numpy(feats),
                             tcfg.SpecAugmentConfig(**cfg_kw)).numpy()
    for arr in (want, got):
        assert set(np.unique(arr)) <= {0.0, 1.0}  # fill = 0 (replace_with_zero)
    # masked mel bins and frames per example: bounded by counts x widths,
    # and the same distribution (means within 15%, 256 examples)
    fmask = lambda a: (a == 0).all(axis=2).sum(1)  # noqa: E731
    tmask = lambda a: (a == 0).all(axis=1).sum(1)  # noqa: E731
    for f in (fmask, tmask):
        w, g = f(want), f(got)
        assert g.max() <= (2 * 27 if f is fmask else 2 * 15)
        assert abs(g.mean() - w.mean()) <= 0.15 * w.mean(), (g.mean(), w.mean())
    # mean fill: masked values equal the utterance mean
    rnd = np.random.RandomState(8).randn(2, M, T).astype(np.float32)
    out = tspec.spec_augment(torch.Generator().manual_seed(1), torch.from_numpy(rnd),
                             tcfg.SpecAugmentConfig(replace_with_zero=False)).numpy()
    changed = out != rnd
    assert changed.any()
    for b in range(2):  # f32 means summed in another order than numpy's
        np.testing.assert_allclose(out[b][changed[b]], rnd[b].mean(dtype=np.float64), rtol=1e-5)
    assert tspec.spec_augment(torch.Generator(), torch.ones(1, 4, 4),
                              tcfg.SpecAugmentConfig(enabled=False)).eq(1).all()


def test_dropout_keep_rate_scale_and_reproducible_masks():
    d = Dropout(0.1).train()
    d.seed = 123
    x = torch.ones(1000, 1000)
    y = d(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.002
    assert torch.all(y[kept] == torch.tensor(1.0 / 0.9))
    assert torch.equal(d(x), y)  # the same seed and site: the same mask (remat)
    d.site = 1
    assert not torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)
    d.train().seed = None
    with pytest.raises(RuntimeError, match="seed"):
        d(x)


# ------------------------------------------------------------ pipeline


def _corpus(tmp_path, n=7, seed=9):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        secs = [0.5, 1.2, 2.5, 0.8, 1.9, 2.9, 1.0][i % 7]
        write_wav(tmp_path / f"u{i}.wav", 0.3 * rng.randn(int(16000 * secs)), 16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 12, 1 + i % 4))
        rows.append(tman.ManifestRow(str(tmp_path / f"u{i}.wav"), text, secs, "d"))
    tman.write_manifest(rows, tmp_path / "m.jsonl")
    return tmp_path / "m.jsonl"


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_batch_iterator_plan_and_batches_match_jax(tmp_path, wire):
    path = _corpus(tmp_path)
    jm, tm = jman.read_manifest(path), tman.read_manifest(path)
    assert [dataclasses.asdict(r) for r in tm] == [dataclasses.asdict(r) for r in jm]
    kw = dict(batch_size=2, bucket_boundaries_seconds=(1.0, 2.0, 3.0), max_text_len=5,
              shuffle_seed=3, transfer_dtype=wire, min_audio_seconds=0.3, max_audio_seconds=3.0)
    jtok = JTok.build(jm.texts())
    jit = jpipe.BatchIterator(jm, jtok, jcfg.DataConfig(**kw), process_index=0, process_count=1)
    tit = tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw))
    for _ in range(7):  # past the end of an epoch
        a, b = next(jit), next(tit)
        for f in ("audio", "audio_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.texts == a.texts and b.bucket_seconds == a.bucket_seconds
        assert tit.state_dict() == jit.state_dict()
    resumed = tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw))
    resumed.load_state_dict(tit.state_dict())
    np.testing.assert_array_equal(next(resumed).audio, next(tit).audio)


def test_prefetch_iterator_state_is_that_of_the_last_batch_handed_out(tmp_path):
    path = _corpus(tmp_path)
    m = tman.read_manifest(path)
    cfg = tcfg.DataConfig(batch_size=2, bucket_boundaries_seconds=(3.0,), max_audio_seconds=3.0)
    tok = TTok.build(m.texts())
    it = tpipe.PrefetchIterator(tpipe.BatchIterator(m, tok, cfg), depth=3)
    first = [next(it) for _ in range(2)]
    state = it.state_dict()
    it.close()
    again = tpipe.BatchIterator(m, tok, cfg)
    [next(again) for _ in range(2)]
    assert state == again.state_dict()
    np.testing.assert_array_equal(first[1].audio, tpipe.make_batches(m, tok, cfg, 2)[1].audio)


# ---------------------------------------------- checkpoints and resume


def _train_cfg(tmp_path, manifest, total=4, **train_kw):
    cfg = tcfg.ExperimentConfig(
        frontend=tcfg.FrontendConfig(chunk_seconds=3.0),
        specaugment=tcfg.SpecAugmentConfig(enabled=True),
        ctc_model=tcfg.CTCModelConfig(**dict(TINY, dropout=0.1),
                                      adapter=tcfg.AdapterConfig(kind="wf", wf_rank=4)),
        data=tcfg.DataConfig(train_manifest=str(manifest), batch_size=2,
                             bucket_boundaries_seconds=(3.0,), max_audio_seconds=3.0,
                             num_host_workers=2),
        train=tcfg.TrainConfig(
            optimizer=tcfg.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=total),
            train_adapters_only=True, checkpoint_dir=str(tmp_path / "ckpt"),
            checkpoint_every_steps=100, **train_kw),
    )
    return cfg


def _fresh(cfg, manifest):
    tok = teng.build_tokenizer_for(cfg, tman.read_manifest(manifest))
    return tok, CTCEncoderModel(cfg.ctc_model, seed=cfg.train.seed)


def test_exact_resume_matches_an_uninterrupted_run(tmp_path):
    """Dropout and SpecAugment on: 2 steps, checkpoint, a fresh process
    state restores (model, optimizer, seed generator, data position) and
    takes 2 more; every parameter equals a 4-step run bit for bit."""
    manifest = _corpus(tmp_path)
    m = tman.read_manifest(manifest)
    cfg_a = _train_cfg(tmp_path / "a", manifest)
    tok, model_a = _fresh(cfg_a, manifest)
    _, info_a = teng.train_loop(cfg_a, m, tok, model_a, kernels=False)
    assert len(info_a["losses"]) == 4 and all(np.isfinite(info_a["losses"]))

    cfg_b = _train_cfg(tmp_path / "b", manifest)
    tok, model_b = _fresh(cfg_b, manifest)
    state_b, _ = teng.train_loop(cfg_b, m, tok, model_b, max_steps=2)
    assert state_b.step == 2
    assert tckpt.TrainCheckpointer(cfg_b.train.checkpoint_dir).latest_step() == 2
    tok, model_c = _fresh(cfg_b, manifest)
    state_c, info_c = teng.train_loop(cfg_b, m, tok, model_c, resume=True)
    assert state_c.step == 4 and len(info_c["losses"]) == 2
    for (k, a), (_, c) in zip(model_a.state_dict().items(), model_c.state_dict().items()):
        assert torch.equal(a, c), k
    assert info_c["losses"] == info_a["losses"][2:]


def test_sigterm_checkpoints_and_exits(tmp_path, monkeypatch):
    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=6)
    tok, model = _fresh(cfg, manifest)
    real = teng.batch_to_device
    calls = {"n": 0}

    def batch_then_sigterm(batch, device, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGTERM)
        return real(batch, device, **kw)

    monkeypatch.setattr(teng, "batch_to_device", batch_then_sigterm)
    state, info = teng.train_loop(cfg, tman.read_manifest(manifest), tok, model)
    assert info["terminated"] and state.step == 2
    ck = tckpt.TrainCheckpointer(cfg.train.checkpoint_dir, keep=1)
    assert ck.latest_step() == 2
    extra = ck.restore(teng.init_state(cfg, _fresh(cfg, manifest)[1]))
    assert extra["data_iter"] == {"epoch": 0, "cursor": 2}


def test_checkpointer_keeps_the_newest(tmp_path):
    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest)
    _, model = _fresh(cfg, manifest)
    state = teng.init_state(cfg, model)
    ck = tckpt.TrainCheckpointer(str(tmp_path / "k"), keep=2)
    for s in (1, 2, 3):
        state.step = s
        ck.save(s, state, {"s": s})
    assert sorted(p.name for p in (tmp_path / "k").iterdir()) == ["00000002", "00000003"]
    assert ck.restore(state, 2) == {"s": 2} and state.step == 2


# ------------------------------------- weight bridge, adapter interchange


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_weight_bridge_round_trips_adapter_trees_exactly(kind, tmp_path):
    _, params = _jax_model(KINDS[kind])
    state = convert.params_to_state_dict(params)
    model = CTCEncoderModel(tcfg.CTCModelConfig(**TINY, adapter=tcfg.AdapterConfig(**KINDS[kind])))
    assert set(state) == set(model.state_dict())
    back = convert.flatten_params(convert.state_dict_to_params(state))
    want = convert.flatten_params(params)
    assert set(back) == set(want)
    for k in want:
        assert np.array_equal(back[k], want[k]) and back[k].shape == want[k].shape, k
    convert.write_npz_params(convert.state_dict_to_params(state), tmp_path / "p.npz")
    again = convert.params_to_state_dict(convert.read_npz_params(tmp_path / "p.npz"))
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_adapter_npz_interchanges_with_the_jax_package(tmp_path):
    """Port -> JAX: an adapter-only npz the port writes loads through the
    JAX load_adapter_only into a JAX model with the same backbone and gives
    the port's log-probs. JAX -> port: the reverse."""
    wf = dict(kind="wf", wf_rank=4)
    jmodel, params = _jax_model(wf)
    feats = _feats(seed=10)
    flens = np.asarray([200, 150], np.int32)
    valid = np.arange(50)[None, :] < ((flens + 3) // 4)[:, None]

    port = _port_model(params, wf).eval()
    with torch.no_grad():
        for name, p in port.named_parameters():
            if "adapter_" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
        want, _ = port(torch.from_numpy(feats), torch.from_numpy(flens))
    tckpt.save_adapter_only(str(tmp_path / "port_adapters.npz"), port)
    with np.load(tmp_path / "port_adapters.npz") as z:
        assert len(z.files) == 2 * 6 * 3
    jparams = jckpt.load_adapter_only(str(tmp_path / "port_adapters.npz"), params)
    with jax.default_matmul_precision("highest"):
        got, _ = jmodel.apply({"params": jparams}, jnp.asarray(feats), jnp.asarray(flens))
    np.testing.assert_allclose(np.asarray(got)[valid], want.numpy()[valid], atol=LOGP_BAR, rtol=0)

    jtrained = _perturb_adapters(params, seed=11)
    jckpt.save_adapter_only(str(tmp_path / "jax_adapters.npz"), jtrained)
    with jax.default_matmul_precision("highest"):
        want2, _ = jmodel.apply({"params": jtrained}, jnp.asarray(feats), jnp.asarray(flens))
    port2 = tckpt.load_adapter_only(str(tmp_path / "jax_adapters.npz"), _port_model(params, wf))
    with torch.no_grad():
        got2, _ = port2.eval()(torch.from_numpy(feats), torch.from_numpy(flens))
    np.testing.assert_allclose(got2.numpy()[valid], np.asarray(want2)[valid], atol=LOGP_BAR, rtol=0)


# ------------------------------------------------------------- metrics


def test_corpus_cer_wer_twin_matches_jax():
    refs = ["胶辽官话，你好！", "海阳话 莱阳", "abc 123", ""]
    hyps = ["胶辽官话你好", "海阳 莱阳话吧", "abd 12", "多"]
    assert tmetrics.corpus_cer(refs, hyps) == jmetrics.corpus_cer(refs, hyps)
    assert tmetrics.corpus_wer(refs, hyps) == jmetrics.corpus_wer(refs, hyps)
    for a, b in zip(refs, hyps):
        assert tmetrics.edit_distance(list(a), list(b)) == jmetrics.edit_distance(list(a), list(b))


# ------------------------------------------------- remat, fine_tune API


def test_remat_recomputes_blocks_with_the_same_dropout_masks(monkeypatch):
    """cfg.remat wraps every block in torch.utils.checkpoint in training;
    the recomputed forward draws the same dropout masks, so loss and
    gradients equal the run without remat bit for bit."""
    from jiao_liao_speech_recognition_torch.models import ctc_model as tcm

    feats = torch.from_numpy(_feats(seed=12))
    flens = torch.tensor([200, 130])
    results = {}
    real = tcm.checkpoint
    for remat in (False, True):
        calls = {"n": 0}

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(tcm, "checkpoint", counting)
        cfg = tcfg.CTCModelConfig(**dict(TINY, dropout=0.1, remat=remat),
                                  adapter=tcfg.AdapterConfig(kind="wf", wf_rank=4))
        model = CTCEncoderModel(cfg, seed=3).train()
        lp, _ = model(feats, flens, dropout_seed=5)
        lp[:, :40].sum().backward()
        results[remat] = (lp.detach(), {n: p.grad for n, p in model.named_parameters()})
        assert calls["n"] == (TINY["num_layers"] if remat else 0)
    assert torch.equal(results[True][0], results[False][0])
    for name, g in results[False][1].items():
        assert torch.equal(results[True][1][name], g), name


def test_fine_tune_api_then_serve_the_checkpoint_on_cpu(tmp_path):
    """api.fine_tune on a tiny WF config (device="cpu"): checkpoints, the
    final bundle, a frozen backbone; api.load + api.transcribe serve it."""
    from jiao_liao_speech_recognition_torch import api

    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=3)
    cfg.train.checkpoint_every_steps = 2
    state, bundle = api.fine_tune(cfg, device="cpu")
    assert state.step == 3 and all(np.isfinite(state.info["losses"]))
    ckpt = tmp_path / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["00000002", "00000003", "final"]
    init = CTCEncoderModel(cfg.ctc_model, seed=cfg.train.seed).state_dict()
    moved = [k for k, v in bundle.model.state_dict().items() if not torch.equal(v, init[k])]
    assert moved and all("adapter_" in k for k in moved)
    served = api.load(str(ckpt / "final"), device="cpu")
    assert served.config.ctc_model.adapter.kind == "wf"
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(served.model.state_dict()[k], v), k
    texts = api.transcribe(served, [str(tmp_path / "u0.wav"), str(tmp_path / "u1.wav")])
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
