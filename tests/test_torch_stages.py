"""The port's multi-dialect transfer against the JAX package's: the
``DialectStage`` / ``stages`` config twin and ``apply_overrides``,
``mix_manifests`` and ``build_stage_manifest`` row for row, the
``dialect_weights`` grouping, ``run_stages`` step for step on a tiny
config, and a schedule killed by SIGTERM and resumed bit for bit."""

import dataclasses
import json
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import manifest as jman  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import schedules as jsched  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.train import schedules as tsched  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
# run_stages, port against JAX: f32 at "highest" precision on both sides,
# SGD, 2 x 3 steps. The features differ by ~1e-6 (two f32 log-mels), and
# each gradient is a sum over every frame in another order; six updates
# carry that forward. Losses within LOSS_REL_BAR; every parameter within
# PARAM_BAR of its largest magnitude.
LOSS_REL_BAR = 1e-5
PARAM_BAR = 1e-5


def _rows(n, tag, seed):
    rng = np.random.RandomState(seed)
    return [tman.ManifestRow(f"{tag}{i}.wav", "".join(chr(0x4E00 + j) for j in
                                                      rng.randint(0, 30, 1 + i % 3)),
                             float(1 + i % 4), tag) for i in range(n)]


def _both(rows):
    return (jman.Manifest([jman.ManifestRow(**dataclasses.asdict(r)) for r in rows]),
            tman.Manifest(rows))


def _dicts(m):
    return [dataclasses.asdict(r) for r in m.rows]


# ---------------------------------------------------------------- config


def test_transfer_yaml_stages_load_as_jax():
    path = str(CONFIGS / "multi_dialect_transfer.yaml")
    got, want = tcfg.load_yaml(path), jcfg.load_yaml(path)
    assert [dataclasses.asdict(s) for s in got.stages] == \
        [dataclasses.asdict(s) for s in want.stages]
    assert got.stages[0].mix_weights == (1.0, 1.0) and got.stages[1].mix_weights is None
    assert dataclasses.asdict(got.ctc_model) == dataclasses.asdict(want.ctc_model)


@pytest.mark.parametrize("overrides", [
    ["train.optimizer.learning_rate=3e-3", "ctc_model.num_layers=6",
     "ctc_model.adapter.kind=att", "--train.seed=4"],
    ["data.bucket_boundaries_seconds=[2.0, 4.0]", "frontend.chunk_seconds=2",
     "data.dialect_weights={jiaoliao: 2.0, default: 1.0}", "train.metrics_path=null"],
    ["stages=[{name: a, manifests: [x.jsonl], steps: 3}, {name: b, train_adapters_only: false}]"],
])
def test_apply_overrides_matches_jax(overrides):
    path = str(CONFIGS / "multi_dialect_transfer.yaml")
    got = tcfg.apply_overrides(tcfg.load_yaml(path), overrides)
    want = jcfg.apply_overrides(jcfg.load_yaml(path), overrides)
    assert tcfg.to_dict(got) == jcfg.to_dict(want)
    assert all(isinstance(s, tcfg.DialectStage) for s in got.stages)


@pytest.mark.parametrize("bad, exc", [("train.seed", ValueError),
                                      ("train.no_such_key=1", KeyError),
                                      ("nosection.seed=1", KeyError)])
def test_apply_overrides_refuses_as_jax(bad, exc):
    with pytest.raises(exc):
        jcfg.apply_overrides(jcfg.ExperimentConfig(), [bad])
    with pytest.raises(exc):
        tcfg.apply_overrides(tcfg.ExperimentConfig(), [bad])


# ------------------------------------------------------------------ mixing


@pytest.mark.parametrize("weights", [None, {"jilu": 3.0, "zhongyuan": 1.0},
                                     {"zhongyuan": 0.2}, {"jilu": 1.0, "x": 5.0}])
@pytest.mark.parametrize("seed", [0, 7])
def test_mix_manifests_row_for_row(weights, seed):
    ja, ta = _both(_rows(5, "jilu", 1))
    jb, tb = _both(_rows(9, "zhongyuan", 2))
    jc, tc = _both(_rows(3, "jiaoliao", 3))
    # insertion order differs from sorted order: the draw is over sorted names
    want = jpipe.mix_manifests({"zhongyuan": jb, "jilu": ja, "jiaoliao": jc}, weights, seed)
    got = tpipe.mix_manifests({"zhongyuan": tb, "jilu": ta, "jiaoliao": tc}, weights, seed)
    assert len(got) == 27 and _dicts(got) == _dicts(want)


@pytest.mark.parametrize("mix_weights", [None, (1.0, 3.0)])
def test_build_stage_manifest_matches_jax(tmp_path, mix_weights):
    paths = []
    for name, n, seed in (("b_zhongyuan", 6, 4), ("a_jilu", 4, 5)):
        p = tmp_path / f"{name}.jsonl"
        tman.write_manifest(_rows(n, name, seed), p)
        paths.append(str(p))
    for manifests in (tuple(paths), (paths[0],)):
        want = jsched.build_stage_manifest(jcfg.DialectStage(
            name="s", manifests=manifests, mix_weights=mix_weights))
        got = tsched.build_stage_manifest(tcfg.DialectStage(
            name="s", manifests=manifests, mix_weights=mix_weights))
        assert _dicts(got) == _dicts(want)


def test_dialect_weights_grouping_matches_jax():
    rows = _rows(7, "jiaoliao", 6) + _rows(5, "", 7) + _rows(4, "jilu", 8)
    np.random.RandomState(9).shuffle(rows)
    jm, tm = _both(rows)
    weights = {"jiaoliao": 3.0, "default": 1.0, "jilu": 0.5}
    groups = {}  # JAX run_experiment's grouping, fed to JAX's mix_manifests
    for row in jm.rows:
        groups.setdefault(row.dialect or "default", []).append(row)
    want = jpipe.mix_manifests({k: jman.Manifest(v) for k, v in groups.items()}, weights)
    assert _dicts(teng.mix_by_dialect(tm, weights)) == _dicts(want)


# ------------------------------------------------------------ run_stages


def _corpus(d, tag, n, seed):
    rng = np.random.RandomState(seed)
    d.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        write_wav(d / f"{tag}{i}.wav", (0.1 * rng.randn(16000)).astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j) for j in rng.randint(0, 16, 2 + i % 3))
        rows.append(tman.ManifestRow(str(d / f"{tag}{i}.wav"), text, 1.0, tag))
    tman.write_manifest(rows, d / f"{tag}.jsonl")
    return str(d / f"{tag}.jsonl")


def _stage_cfg(c, tmp_path, name, paths, dropout=0.0, specaugment=False):
    cfg = c.ExperimentConfig(
        ctc_model=c.CTCModelConfig(
            d_model=64, num_layers=2, num_heads=2, mlp_dim=128, conv_channels=32,
            dtype="float32", dropout=dropout, use_flash_attention=False,
            adapter=c.AdapterConfig(kind="att", att_num_heads=2, att_key_dim=32,
                                    dropout=dropout)),
        specaugment=c.SpecAugmentConfig(enabled=specaugment),
        data=c.DataConfig(batch_size=2, bucket_boundaries_seconds=(1.5,),
                          min_audio_seconds=0.1, max_text_len=8, num_host_workers=1),
        train=c.TrainConfig(
            optimizer=c.OptimizerConfig(name="sgd", learning_rate=0.05, warmup_steps=0,
                                        schedule="constant"),
            checkpoint_dir=str(tmp_path / name / "ckpt"), checkpoint_every_steps=100,
            log_every_steps=1, metrics_path=str(tmp_path / name / "metrics.jsonl")),
    )
    cfg.stages = (
        c.DialectStage(name="neighbor", manifests=(paths[0], paths[1]), steps=3,
                       train_adapters_only=False, mix_weights=(1.0, 2.0)),
        c.DialectStage(name="target", manifests=(paths[2],), steps=3,
                       train_adapters_only=True),
    )
    return cfg


def _three_corpora(tmp_path):
    return [_corpus(tmp_path / "data", tag, 4, seed)
            for tag, seed in (("jilu", 1), ("zhongyuan", 2), ("jiaoliao", 3))]


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_run_stages_matches_jax(tmp_path):
    """Two stages (the whole model on two mixed corpora, then the adapters
    alone), the same initial weights and vocabulary: per-step losses and
    final parameters agree; stage 2 leaves the backbone bitwise as stage 1
    ended; the stage summary lines match."""
    paths = _three_corpora(tmp_path)
    jc = _stage_cfg(jcfg, tmp_path, "jax", paths)
    tc = _stage_cfg(tcfg, tmp_path, "torch", paths)
    texts = [t for s in jc.stages for t in jsched.build_stage_manifest(s).texts()]
    jtok = jsched.CharTokenizer.build(texts)
    jc.ctc_model.vocab_size = len(jtok)
    params = JBundle._init_params(jc, seed=0)
    # Att adapters start as the identity (zero out_proj): perturb them so
    # both stages' adapter gradients are live from the first step
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 0.05 * rng.randn(*v.shape)).astype(np.float32)
        if any("adapter_" in str(getattr(k, "key", "")) for k in path) else np.asarray(v),
        params)
    with jax.default_matmul_precision("highest"):
        jparams, _, jhist = jsched.run_stages(jc, params=params, tokenizer=jtok)

    tc.ctc_model.vocab_size = len(jtok)
    model = CTCEncoderModel(tc.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(params))
    model, ttok, thist = tsched.run_stages(tc, model=model, tokenizer=TTok(jtok.vocab),
                                           device="cpu")
    assert tc.ctc_model.vocab_size == len(ttok)

    jrec, trec = _records(jc.train.metrics_path), _records(tc.train.metrics_path)
    jloss = [r["loss"] for r in jrec if "stage" not in r]
    tloss = [r["loss"] for r in trec if "stage" not in r]
    assert len(tloss) == 6
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_REL_BAR)
    summary = [(r["step"], r["stage"], r["stage_index"]) for r in trec if "stage" in r]
    assert summary == [(r["step"], r["stage"], r["stage_index"]) for r in jrec if "stage" in r]
    assert summary == [(3, "neighbor", 0), (3, "target", 1)]
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]  # the same keys
    assert [h["stage"] for h in thist] == [h["stage"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               rtol=LOSS_REL_BAR)

    want_sd = convert.params_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, want in want_sd.items():
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(got_sd[key].numpy(), want.numpy(), atol=PARAM_BAR * scale,
                                   rtol=0, err_msg=key)

    stage1 = torch.load(Path(tc.train.checkpoint_dir) / "stage_0_neighbor" / "00000003"
                        / "state.pt", weights_only=False)["model"]
    init = convert.params_to_state_dict(params)
    for key, v in model.state_dict().items():
        if param_is_adapter(key):
            assert not torch.equal(v, stage1[key]), key  # stage 2 trained the adapters
        else:
            assert torch.equal(v, stage1[key]), key  # and left the backbone bitwise
            assert not torch.equal(v, init[key].to(v.dtype)), key  # which stage 1 moved


def test_run_stages_killed_and_resumed_is_bitwise(tmp_path, monkeypatch):
    """Dropout and SpecAugment on: a SIGTERM at stage 1's second step ends
    the schedule after that stage's checkpoint; resume=True finishes it with
    parameters bitwise those of an uninterrupted run, and a resume over the
    finished directories takes no step."""
    paths = _three_corpora(tmp_path)

    def run(name, resume=False):
        cfg = _stage_cfg(tcfg, tmp_path, name, paths, dropout=0.1, specaugment=True)
        cfg.train.checkpoint_every_steps = 1
        return tsched.run_stages(cfg, resume=resume, device="cpu")

    full, _, hist = run("full")
    assert [h["stage"] for h in hist] == ["neighbor", "target"]
    assert all(np.isfinite(h["loss"]) for h in hist)

    real = teng.batch_to_device
    calls = {"n": 0}

    def counting(batch, device, **kw):
        calls["n"] += 1
        if calls["n"] == 2 and calls.get("kill"):
            signal.raise_signal(signal.SIGTERM)
        return real(batch, device, **kw)

    monkeypatch.setattr(teng, "batch_to_device", counting)
    calls["kill"] = True
    _, _, hist = run("killed")
    assert [h["stage"] for h in hist] == ["neighbor"] and calls["n"] == 2
    assert (tmp_path / "killed" / "ckpt" / "stage_0_neighbor" / "00000002").is_dir()
    assert not (tmp_path / "killed" / "ckpt" / "stage_1_target").exists()
    events = [r.get("event") for r in _records(tmp_path / "killed" / "metrics.jsonl")]
    assert "sigterm_checkpoint_and_exit" in events and "sigterm_stage_exit" in events

    calls.update(n=0, kill=False)
    resumed, _, hist = run("killed", resume=True)
    assert calls["n"] == 1 + 3  # stage 1's last step, then stage 2
    for (k, a), (_, b) in zip(full.state_dict().items(), resumed.state_dict().items()):
        assert torch.equal(a, b), k

    calls["n"] = 0
    again, _, hist = run("killed", resume=True)
    assert calls["n"] == 0 and hist == [{"stage": "neighbor"}, {"stage": "target"}]
    for (k, a), (_, b) in zip(full.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
