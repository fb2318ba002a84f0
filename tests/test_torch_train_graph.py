"""The JAX package's jitted train step as the port runs it on one card:
each bucket's step captured once as a CUDA graph and replayed
(``train/engine.TrainStep``), reached on the CPU through the train-step twin
of tests/torch_graph_twin.py (each "capture" runs nothing, each replay runs
the step eagerly and rewrites the twin's static outputs in place).

Held here: the captured route gives the graph=False route's per-step
metrics, trainable weights and optimizer state bit for bit for the ctc (WF),
joint and Whisper families, over two bucket shapes, with grad_accum_steps 1
and 2, the backbone bit-unchanged; the losses train_loop returns are each
step's own; one captured (replayed) WF step against JAX's jitted step; the
plain CTC recursion (``ops/ctc_loss.py``, the CUDA kernel's CPU twin)
against the JAX loss in value and in ``jax.grad``; SpecAugment built from
the host's draws against the masks drawn and applied on the host; dropout
masks seeded on the host against the model's own seeding; exact resume
through the captured route and a checkpoint of either optimizer route
loading into the other; and the process-group rule (an explicit eager
route, and a ValueError for a captured FSDP2 step). Tiny models in f32; the
JAX side at "highest" matmul precision."""

import dataclasses
import importlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import engine as jeng  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import specaugment as tspec  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.layers import (  # noqa: E402
    dropout_generators, seed_dropout)
from jiao_liao_speech_recognition_torch.ops import ctc_loss as tctc  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.train import checkpoints as tckpt  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.logging import MetricsLogger  # noqa: E402
from torch_graph_twin import ReplayedOnCPU, captured_steps  # noqa: E402

# the JAX ops package re-exports the function under the module's name
jctc = importlib.import_module("jiao_liao_speech_recognition_tpu.ops.ctc_loss")

WF = dict(kind="wf", wf_rank=2)
STEPS = 4
# the JAX comparisons, as tests/test_torch_train.py states them: the loss
# relative bar; gradients relative to their largest magnitude; parameters
# after an AdamW step where the gradient's sign is settled
LOSS_REL_BAR = 1e-5
GRAD_REL_BAR = 5e-4
PARAM_BAR = 1e-6
# the plain CTC recursion against the JAX scan: the same f32 recursion,
# log1p / exp from another library; the gradient summed by a scatter
CTC_NLL_REL_BAR = 1e-5
CTC_GRAD_BAR = 1e-5


# ------------------------------------------------------------------ helpers


def _corpus(d, seconds=(0.8, 1.6), n_each=4, seed=0):
    """n_each utterances of each length (one bucket shape each) with 2-5
    characters of a 20-character alphabet."""
    rng = np.random.RandomState(seed)
    rows = []
    for i, secs in enumerate(s for s in seconds for _ in range(n_each)):
        path = d / f"u{i}.wav"
        write_wav(path, (0.1 * rng.randn(int(16000 * secs))).astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 20, 2 + i % 4))
        rows.append(tman.ManifestRow(str(path), text, secs, "jiaoliao"))
    tman.write_manifest(rows, d / "train.jsonl")
    return d / "train.jsonl"


def _cfg(family, d, manifest, accum=1, dropout=0.1, total=STEPS):
    c = tcfg
    cfg = c.ExperimentConfig(
        model_family=family, frontend=c.FrontendConfig(chunk_seconds=2.0),
        specaugment=c.SpecAugmentConfig(enabled=True),
        data=c.DataConfig(train_manifest=str(manifest), batch_size=2,
                          bucket_boundaries_seconds=(1.0, 2.0), max_audio_seconds=2.0,
                          min_audio_seconds=0.1, max_text_len=8, num_host_workers=1),
        train=c.TrainConfig(
            optimizer=c.OptimizerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=total,
                                        grad_accum_steps=accum),
            train_adapters_only=True, checkpoint_dir=str(d / "ckpt"),
            checkpoint_every_steps=100, log_every_steps=1))
    wf = c.AdapterConfig(**WF)
    if family == "ctc":
        cfg.ctc_model = c.CTCModelConfig(d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
                                         conv_channels=16, dtype="float32", dropout=dropout,
                                         adapter=wf)
    elif family == "joint":
        cfg.joint = c.JointModelConfig(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2,
                                       num_heads=2, mlp_dim=64, conv_channels=16,
                                       dropout=dropout, dtype="float32",
                                       use_flash_attention=False, max_target_positions=32,
                                       ctc_weight=0.3, adapter=wf)
    else:
        cfg.whisper = c.WhisperConfig(vocab_size=50, d_model=32, encoder_layers=2,
                                      decoder_layers=2, num_heads=2, mlp_dim=64,
                                      max_target_positions=24, use_flash_attention=False,
                                      dropout=dropout, dtype="float32", adapter=wf)
    return cfg


def _train(cfg, manifest, graph, **kw):
    """train_loop of a fresh model -> (model, its initial state dict, state,
    info, a metrics record a step without the timing)."""
    rows = tman.read_manifest(manifest)
    tok = teng.build_tokenizer_for(cfg, rows)
    model = teng.make_model(cfg, "cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    buf = io.StringIO()
    state, info = teng.train_loop(cfg, rows, tok, model, logger=MetricsLogger(stream=buf),
                                  graph=graph, **kw)
    records = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "steps_per_sec")}
               for line in buf.getvalue().splitlines()]
    return model, init, state, info, records


def _optimizer_tensors(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {f"{names[id(p)]}/{k}": v for p, st in state.optimizer.state.items()
            for k, v in st.items()}


# ------------------------------------------- the captured route, bitwise


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("family", ["ctc", "joint", "whisper"])
def test_captured_route_is_bitwise_the_eager_route(family, accum, tmp_path, monkeypatch):
    """STEPS steps over two bucket shapes, dropout and SpecAugment on: the
    captured route's metrics a step (loss, the joint's two terms, the grad
    norm of each update), trainable weights and optimizer state equal the
    graph=False route's bit for bit; the backbone is bit-unchanged; one
    graph a bucket (and one update graph with grad_accum_steps 2), each
    registering every dropout generator."""
    manifest = _corpus(tmp_path)
    eager = _train(_cfg(family, tmp_path / "eager", manifest, accum), manifest, graph=False)
    captured_steps(monkeypatch)
    graph = _train(_cfg(family, tmp_path / "graph", manifest, accum), manifest, graph=True)

    (model_e, init, state_e, info_e, rec_e), (model_g, _, state_g, info_g, rec_g) = eager, graph
    assert info_e["graph"]["route"] == "eager: graph=False" and not info_e["graph"]["captured"]
    g = info_g["graph"]
    graphs = 2 + (accum > 1)
    assert g["route"].startswith("captured") and g["graphs"] == graphs
    assert g["replays"] == STEPS - 2 + (accum > 1) * (STEPS // accum - 1)
    assert len(ReplayedOnCPU.made) == graphs
    gens = {id(x) for x in dropout_generators(model_g)}
    assert gens and all({id(x) for x in t.generators} == gens for t in ReplayedOnCPU.made)

    assert len(rec_g) == STEPS and rec_g == rec_e
    assert sum("grad_norm" in r for r in rec_g) == STEPS // accum
    trained = {n for n, p in model_g.named_parameters() if p.requires_grad}
    assert trained and all(param_is_adapter(n) for n in trained)
    for (name, a), (_, b) in zip(model_g.state_dict().items(), model_e.state_dict().items()):
        assert torch.equal(a, b), name
        if not param_is_adapter(name):
            assert torch.equal(a, init[name]), name
    opt_g, opt_e = _optimizer_tensors(state_g), _optimizer_tensors(state_e)
    assert opt_g.keys() == opt_e.keys() and len(opt_g) == 3 * len(trained)
    assert all(torch.equal(opt_g[k], opt_e[k]) for k in opt_g)


def test_train_loop_returns_each_steps_own_loss(tmp_path, monkeypatch):
    """One bucket, STEPS steps: the first warms and captures, the rest are
    replays that rewrite one static loss; the losses returned are each
    step's own (cloned out), the graph=False route's."""
    manifest = _corpus(tmp_path, seconds=(0.8,), n_each=2 * STEPS)
    eager = _train(_cfg("ctc", tmp_path / "e", manifest), manifest, graph=False)[3]
    captured_steps(monkeypatch)
    info = _train(_cfg("ctc", tmp_path / "g", manifest), manifest, graph=True)[3]
    assert info["graph"]["graphs"] == 1 and info["graph"]["replays"] == STEPS - 1
    assert len(set(info["losses"])) == STEPS and info["losses"] == eager["losses"]
    assert info["last_metrics"]["loss"] == info["losses"][-1]


# ----------------------------------------------- one captured step vs JAX


TINY = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256, conv_channels=64,
            vocab_size=30, dtype="float32", dropout=0.0)


def test_a_captured_wf_step_matches_jax_and_freezes_the_backbone(monkeypatch):
    """The second step of one bucket is a replay. With a linear warmup of
    one update the first update's rate is 0 on both sides, so the replayed
    step starts from the initial weights with AdamW's moments of one equal
    gradient, and its update is the first-update formula lr * g / (|g| +
    eps): the loss and grad norm of the replay against JAX's jitted second
    step, and the adapters after it within test_torch_train's bars, the
    backbone bitwise."""
    wf = dict(kind="wf", wf_rank=4)
    lr = 1e-3
    rng = np.random.RandomState(7)

    def exp(c):
        return c.ExperimentConfig(
            ctc_model=c.CTCModelConfig(**TINY, adapter=c.AdapterConfig(**wf)),
            specaugment=c.SpecAugmentConfig(enabled=False),
            train=c.TrainConfig(optimizer=c.OptimizerConfig(
                learning_rate=lr, warmup_steps=1, total_steps=100, schedule="linear"),
                train_adapters_only=True))

    jc, tc = exp(jcfg), exp(tcfg)
    jmodel = JModel(jc.ctc_model)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 64), jnp.float32))["params"])
    flat = convert.flatten_params(params)
    moved = {}
    for path, v in flat.items():  # every adapter leaf off its init (WF's B is zero)
        if any(p.startswith("adapter_") for p in path):
            v = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        node = moved
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    params = moved
    batch = {"audio": (0.1 * rng.randn(2, 32000)).astype(np.float32),
             "audio_lengths": np.asarray([32000, 21000], np.int32),
             "labels": rng.randint(1, 30, (2, 7)).astype(np.int32),
             "label_lengths": np.asarray([7, 4], np.int32)}

    with jax.default_matmul_precision("highest"):
        _, jloss_fn, tx, jitted = jeng.build_train_setup(jc, params)
        jstate = jeng.init_state(jc, tx, jax.tree_util.tree_map(jnp.asarray, params))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, _ = jitted(jstate, jb)
        jstate, jm = jitted(jstate, jb)
        jgrads = jax.grad(lambda p: jloss_fn(p, jb, jax.random.PRNGKey(0), True)[0])(
            jax.tree_util.tree_map(jnp.asarray, params))
    jnew = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    jgrads = convert.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))

    model = CTCEncoderModel(tc.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    captured_steps(monkeypatch)
    runner = teng.TrainStep(tc, teng.init_state(tc, model), graph=True)
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    runner(host)
    m = runner(host)
    assert runner.replays == 1 and len(ReplayedOnCPU.made) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL_BAR)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_REL_BAR)
    for key, v in model.state_dict().items():
        path = convert.flax_path(key)
        if any(s.startswith("adapter_") for s in path):
            g = jgrads[path]
            settled = np.abs(g) > 2 * GRAD_REL_BAR * max(np.abs(g).max(), 1e-12)
            diff = np.abs(v.numpy() - jnew[path])
            assert diff[settled].max(initial=0) <= PARAM_BAR, path
            assert diff.max() <= 2 * lr, path
        else:
            assert torch.equal(v, before[key]), key


# ------------------------------------------------- the plain CTC recursion


def _ctc_case(name):
    rng = np.random.RandomState({"repeats": 1, "empty": 2, "infeasible": 3, "long": 4}[name])
    if name == "long":  # T' = 750 at S = 128, lengths spread
        B, T, V, S = 3, 750, 40, 128
        t_lens = np.asarray([750, 600, 300], np.int32)
        l_lens = np.asarray([128, 100, 128], np.int32)
    else:
        B, T, V, S = 4, 24, 9, 6
        t_lens = np.asarray([24, 7 if name == "infeasible" else 15, 24, 9], np.int32)
        l_lens = {"repeats": [6, 4, 5, 3], "empty": [0, 4, 0, 2],
                  "infeasible": [6, 6, 2, 6]}[name]
        l_lens = np.asarray(l_lens, np.int32)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    labels[:, 1] = labels[:, 0]  # a repeat in every row: a blank between
    if name in ("repeats", "infeasible"):
        labels[:, 3] = labels[:, 2]
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.randn(B, T, V).astype(np.float32)), -1))
    weight = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return lp, t_lens, labels, l_lens, weight


@pytest.mark.parametrize("case", ["repeats", "empty", "infeasible", "long"])
def test_plain_ctc_recursion_matches_the_jax_loss_and_its_grad(case):
    """ctc_forward_plain / ctc_backward_plain (what jl_ctc_loss is held to
    on the card) against the JAX scan: each feasible row's NLL within
    CTC_NLL_REL_BAR, the gradient of sum(w * nll) over feasible rows within
    CTC_GRAD_BAR of its largest magnitude; an infeasible row is 1e30 on both
    sides with a zero gradient here."""
    lp, t_lens, labels, l_lens, weight = _ctc_case(case)
    want = np.asarray(jctc.ctc_loss(jnp.asarray(lp), jnp.asarray(t_lens), jnp.asarray(labels),
                                    jnp.asarray(l_lens)))
    reps = np.asarray([sum(labels[b, s] == labels[b, s - 1] for s in range(1, l_lens[b]))
                       for b in range(len(l_lens))])
    feasible = t_lens >= l_lens + reps
    assert feasible.any() and (case != "infeasible" or not feasible.all())
    w = weight * feasible
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jctc.ctc_loss(
        x, jnp.asarray(t_lens), jnp.asarray(labels), jnp.asarray(l_lens)) * w))(jnp.asarray(lp)))

    x = torch.from_numpy(lp.copy()).requires_grad_(True)
    got = tctc.ctc_loss(x, *map(torch.from_numpy, (t_lens, labels, l_lens)))
    (got * torch.from_numpy(weight)).sum().backward()
    got = got.detach().numpy()
    np.testing.assert_allclose(got[feasible], want[feasible], rtol=CTC_NLL_REL_BAR)
    assert np.all(got[~feasible] == np.float32(1e30)) and np.all(want[~feasible] == got[~feasible])
    g = x.grad.numpy()
    np.testing.assert_allclose(g[feasible], want_g[feasible],
                               atol=CTC_GRAD_BAR * np.abs(want_g).max(), rtol=0)
    assert np.all(g[~feasible] == 0.0)
    for b in range(len(t_lens)):  # nothing past a row's frames
        assert np.all(g[b, max(t_lens[b], 1):] == 0.0)


# ------------------------------------------------- SpecAugment, dropout


def _host_spec_augment(gen, features, cfg, rows=None):
    """SpecAugment as the port drew and applied it on the host before the
    draws and the masks were split: each axis's masks drawn and built on
    the CPU, then moved to the features' device."""

    def mask_axis(x, axis, num_masks, max_width, fill):
        size, b = x.shape[axis], x.shape[0]
        first, total = rows or (0, b)
        widths = torch.randint(0, max(max_width, 1) + 1, (total, num_masks),
                               generator=gen)[first:first + b]
        hi = torch.clamp(size - widths, min=1)
        u = torch.rand(total, num_masks, generator=gen)[first:first + b]
        starts = torch.minimum((u * hi).long(), hi - 1)
        pos = torch.arange(size)
        hit = ((pos[None, None, :] >= starts[..., None])
               & (pos[None, None, :] < (starts + widths)[..., None]))
        shape = [b, 1, 1]
        shape[axis] = size
        return torch.where(hit.any(dim=1).to(x.device).reshape(shape), fill, x)

    fill = (torch.zeros((), dtype=features.dtype) if cfg.replace_with_zero
            else features.mean(dim=(1, 2), keepdim=True))
    t = features.shape[2]
    out = mask_axis(features, 1, cfg.num_freq_masks, cfg.freq_mask_width, fill)
    return mask_axis(out, 2, cfg.num_time_masks, int(cfg.time_mask_fraction * t), fill)


@pytest.mark.parametrize("zero,rows", [(True, None), (False, (1, 5))])
def test_specaugment_from_the_steps_draws_is_bitwise_the_host_masks(zero, rows):
    """The train step's route (step_inputs draws on the host, a copy of the
    draws, apply_masks on the features) and spec_augment give bitwise the
    masks of the host-side implementation, from one seed."""
    cfg = tcfg.ExperimentConfig(specaugment=tcfg.SpecAugmentConfig(
        enabled=True, replace_with_zero=zero, num_time_masks=3, time_mask_fraction=0.1))
    feats = torch.from_numpy(np.random.RandomState(9).randn(3, 80, 300).astype(np.float32))
    want = _host_spec_augment(torch.Generator().manual_seed(11), feats, cfg.specaugment, rows)
    got = tspec.spec_augment(torch.Generator().manual_seed(11), feats, cfg.specaugment, rows)
    batch = {"audio": torch.zeros(3, 300 * cfg.frontend.hop_length)}
    if rows is not None:
        batch["rows"] = rows
    draws = teng.step_inputs(cfg, torch.nn.Module(), batch, [11, 0, 0])
    static = {k[5:]: v.clone() for k, v in draws.items()}
    assert set(static) == {"freq_width", "freq_u", "time_width", "time_u"}
    stepped = tspec.apply_masks(feats, static, cfg.specaugment)
    assert not torch.equal(want, feats)
    assert torch.equal(got, want) and torch.equal(stepped, want)


def _dropout_model(remat=False):
    cfg = tcfg.CTCModelConfig(d_model=32, num_layers=2, num_heads=2, mlp_dim=64,
                              conv_channels=16, dtype="float32", dropout=0.2, remat=remat,
                              adapter=tcfg.AdapterConfig(**WF))
    feats = torch.from_numpy(np.random.RandomState(3).randn(2, 80, 120).astype(np.float32))
    return CTCEncoderModel(cfg, seed=2).train(), feats, torch.tensor([120, 90])


def test_dropout_masks_are_the_same_on_both_routes_and_change_each_step():
    """A model seeding its sites for the forward (dropout_seed) and a train
    step seeding them on the host before the forward (seed_dropout, what a
    replay reads) draw the same masks; the next step's seed draws others,
    and the generators stay the same objects (a graph registered them)."""
    model, feats, lens = _dropout_model()
    a = model(feats, lens, dropout_seed=5)[0]
    gens = [id(g) for g in dropout_generators(model)]
    seed_dropout(model, 5)
    b = model(feats, lens)[0]
    seed_dropout(model, 6)
    c = model(feats, lens)[0]
    model.eval()
    clean = model(feats, lens)[0]
    assert gens and [id(g) for g in dropout_generators(model)] == gens
    assert torch.equal(a, b) and not torch.equal(b, c)
    assert not torch.equal(a, clean) and not torch.equal(c, clean)


def test_remat_recompute_draws_the_forward_masks_under_host_seeding():
    """cfg.remat under the train step's seeding: the backward's recompute
    draws from the site's second generator, seeded with the forward's seed,
    so loss and gradients equal the run without remat bit for bit."""
    results = {}
    for remat in (False, True):
        model, feats, lens = _dropout_model(remat)
        seed_dropout(model, 5)
        lp, _ = model(feats, lens)
        lp[:, :20].sum().backward()
        results[remat] = (lp.detach(), {n: p.grad for n, p in model.named_parameters()})
        in_blocks = sum(m in model._dropouts for m in model.blocks.modules())
        assert len(dropout_generators(model)) == len(model._dropouts) + remat * in_blocks
    assert torch.equal(results[True][0], results[False][0])
    for name, g in results[False][1].items():
        assert torch.equal(results[True][1][name], g), name


# ---------------------------------------------------- resume, checkpoints


def test_exact_resume_through_the_captured_route(tmp_path, monkeypatch):
    """Captured route, dropout and SpecAugment on: 2 steps, checkpoint,
    a fresh model restored (before its steps are captured anew) takes 2
    more; every parameter and loss equals a 4-step captured run."""
    manifest = _corpus(tmp_path)
    captured_steps(monkeypatch)
    model_a, _, _, info_a, _ = _train(_cfg("ctc", tmp_path / "a", manifest), manifest, True)
    cfg_b = _cfg("ctc", tmp_path / "b", manifest)
    state_b = _train(cfg_b, manifest, True, max_steps=2)[2]
    assert state_b.step == 2
    model_c, _, state_c, info_c, _ = _train(cfg_b, manifest, True, resume=True)
    assert state_c.step == STEPS and info_c["graph"]["route"].startswith("captured")
    for (k, a), (_, c) in zip(model_a.state_dict().items(), model_c.state_dict().items()):
        assert torch.equal(a, c), k
    assert info_c["losses"] == info_a["losses"][2:]


def test_a_card_routes_checkpoint_loads_into_the_cpu_optimizer(tmp_path):
    """The captured route's file holds a capturable optimizer (its groups
    capturable, the rate a device scalar): restored into this route's
    optimizer, the groups keep this route's flag and float rate, and the
    next update equals the one from this route's own file bit for bit."""
    manifest = _corpus(tmp_path)
    cfg = _cfg("ctc", tmp_path, manifest, dropout=0.0)
    state = _train(cfg, manifest, False, max_steps=2)[2]
    ck = tckpt.TrainCheckpointer(cfg.train.checkpoint_dir)
    path = ck.dir / "00000002" / "state.pt"
    blob = torch.load(path, weights_only=False)
    for g in blob["optimizer"]["param_groups"]:
        g["capturable"], g["lr"] = True, torch.tensor(0.5)
    torch.save(blob, ck.dir / "card.pt")

    def restored(card: bool):
        model = teng.make_model(cfg, "cpu")
        st = teng.init_state(cfg, model)
        if card:
            path.write_bytes((ck.dir / "card.pt").read_bytes())
        ck.restore(st, 2)
        return st

    own, card = restored(False), restored(True)
    assert all(not g["capturable"] and isinstance(g["lr"], float)
               for g in card.optimizer.param_groups)
    sched = teng.make_schedule(cfg.train.optimizer)
    for st in (own, card):
        for p in st.trainable():
            p.grad = torch.full_like(p, 0.01)
        st.step += 1
        teng.apply_update(st, cfg.train.optimizer, sched)
    for (k, a), (_, b) in zip(own.model.state_dict().items(), card.model.state_dict().items()):
        assert torch.equal(a, b), k
    assert state.step == 2


# ---------------------------------------------------------- process groups


@pytest.fixture
def one_process_group():
    """A gloo process group of one in this process (no network: a hash
    store), torn down after the test."""
    torch.distributed.init_process_group("gloo", store=torch.distributed.HashStore(), rank=0,
                                         world_size=1)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_a_process_group_keeps_the_step_eager_by_rule(tmp_path, one_process_group):
    """Under a process group train_loop wraps the model with FSDP2 and
    steps eagerly by rule, reported in info["graph"], also where a card
    would capture (the rule comes before the device)."""
    manifest = _corpus(tmp_path)
    cfg = _cfg("ctc", tmp_path, manifest, total=2)
    assert mh.is_initialized()
    assert teng.step_route(cfg, torch.device("cuda"), True, True) == (
        False, "eager: under a process group (FSDP2) the step runs eagerly")
    info = _train(cfg, manifest, True)[3]
    assert info["mesh"] is not None and len(info["losses"]) == 2
    assert info["graph"] == {"route": "eager: under a process group (FSDP2) the step runs "
                                      "eagerly", "captured": False}


def test_capturing_an_fsdp2_step_raises_naming_graph_false(tmp_path, one_process_group):
    from jiao_liao_speech_recognition_torch.parallel import mesh as pmesh

    cfg = _cfg("ctc", tmp_path, _corpus(tmp_path))
    cfg.ctc_model = dataclasses.replace(cfg.ctc_model, vocab_size=24)
    model = teng.make_model(cfg, "cpu")
    pmesh.shard_model(pmesh.build_mesh_for_batch(cfg.mesh, cfg.data.batch_size), model)
    state = teng.init_state(cfg, model)
    with pytest.raises(ValueError, match="graph=False"):
        teng.TrainStep(cfg, state, graph=True)
    assert teng.TrainStep(cfg, state, graph=False).graph is False
