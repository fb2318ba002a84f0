"""The port's mesh and its data split against the JAX package's
``parallel/mesh.py`` and ``data/pipeline.py``: mesh shapes and errors for
the same inputs over conftest's 8 CPU devices, the FSDP placement rule,
``shard_batch``'s rows, each process's ``BatchIterator`` rows, the model
axis's mesh shapes, ``checked(errors=...)`` for each of checkify's sets,
and the one-process training loop against JAX's ``train_loop`` on its
data x fsdp mesh."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import checkify  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import manifest as jman  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.parallel import mesh as jmesh  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import profiling as jprof  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import mesh as tmesh  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import tp_rules  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import profiling as tprof  # noqa: E402

# tests/test_torch_train.py's bar for one step against JAX (f32 at
# "highest"): each gradient a sum over every frame, taken in another order
LOSS_REL_BAR = 1e-5


def _jax_shape(fn):
    """-> ("ok", (data, fsdp, model)) or ("err", message) of a JAX mesh call."""
    try:
        m = fn()
    except ValueError as e:
        return "err", str(e)
    return "ok", tuple(dict(m.shape)[k] for k in ("data", "fsdp", "model"))


def _port_shape(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "err", str(e)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_and_errors_match_jax(n):
    """build_mesh and build_mesh_for_batch over the first n of the 8 CPU
    devices, for fsdp 1-4 (model 1), data_axis -1, 1, 2 and batches 1-9:
    the same (data, fsdp, model) or the same ValueError."""
    devices = jax.devices()[:n]
    cases = 0
    for fsdp in (1, 2, 3, 4):
        for data in (-1, 1, 2):
            j, t = jcfg.MeshConfig(data_axis=data, fsdp_axis=fsdp), \
                tcfg.MeshConfig(data_axis=data, fsdp_axis=fsdp)
            assert _port_shape(lambda: tmesh.mesh_shape(t, n)) == \
                _jax_shape(lambda: jmesh.build_mesh(j, devices))
            for batch in range(1, 10):
                assert _port_shape(lambda: tmesh.mesh_shape(t, n, batch)) == \
                    _jax_shape(lambda: jmesh.build_mesh_for_batch(j, batch, devices)), \
                    (n, fsdp, data, batch)
                cases += 1
    assert cases == 4 * 3 * 9


def test_mesh_refuses_tensor_parallelism_and_idle_ranks():
    """model_axis 2 gives JAX's (data, fsdp, 2) mesh (tensor parallelism
    is ported; tests/test_torch_tp.py runs it), over 2-8 devices and
    batches 1-9; idle ranks are still refused."""
    for n in (2, 4, 6, 8):
        for fsdp in (1, 2):
            j, t = jcfg.MeshConfig(fsdp_axis=fsdp, model_axis=2), \
                tcfg.MeshConfig(fsdp_axis=fsdp, model_axis=2)
            devices = jax.devices()[:n]
            got = _port_shape(lambda: tmesh.mesh_shape(t, n))
            assert got == _jax_shape(lambda: jmesh.build_mesh(j, devices)), (n, fsdp)
            assert got[0] == "err" or got[1][2] == 2
            for batch in range(1, 10):
                assert _port_shape(lambda: tmesh.mesh_shape(t, n, batch)) == \
                    _jax_shape(lambda: jmesh.build_mesh_for_batch(j, batch, devices))
    # JAX takes a 3-device sub-mesh for a batch of 3 on 4 devices: a
    # process group cannot leave its fourth rank idle
    assert tmesh.mesh_shape(tcfg.MeshConfig(), 4, 3) == (3, 1, 1)
    with pytest.raises(ValueError, match=r"batch_size=3 on a world of 4 processes"):
        tmesh.build_mesh_for_batch(tcfg.MeshConfig(), 3, world=4)
    with pytest.raises(ValueError, match="not divisible by fsdp"):
        tmesh.build_mesh(tcfg.MeshConfig(fsdp_axis=3), world=4)


@pytest.mark.parametrize("fsdp", [1, 2, 4])
def test_placement_rule_shards_where_jax_shards(fsdp):
    """The largest axis of a >= 2-D parameter when fsdp divides it (JAX's
    _fsdp_rule, on a 2 x fsdp CPU mesh: tp_rules.fsdp_placement gives its
    spec, the FSDP2 rule of shard_model its dim); where JAX replicates,
    dim 0."""
    mesh = jmesh.build_mesh(jcfg.MeshConfig(fsdp_axis=fsdp), jax.devices()[:2 * fsdp])
    jrule = jmesh._fsdp_rule(mesh)
    model = torch.nn.Module()
    shapes = [(7,), (64,), (64, 4), (4, 64), (30, 64), (3, 5), (80, 512, 3), (6, 6)]
    for i, shape in enumerate(shapes):
        model.register_parameter(f"w{i}", torch.nn.Parameter(torch.zeros(shape)))
    trule = tmesh.model_placement_rule(model, 1, fsdp)
    for shape, p in zip(shapes, model.parameters()):
        spec = tuple(jrule(np.zeros(shape, np.float32)).spec)
        spec += (None,) * (len(shape) - len(spec))
        assert tp_rules.fsdp_placement(shape, fsdp) == spec, (shape, spec)
        axis = spec.index("fsdp") if "fsdp" in spec else 0
        assert trule(p).dim == axis, (shape, spec)


class _Mesh:
    """A (data, fsdp, model) stand-in at one coordinate."""

    def __init__(self, data, fsdp, coord):
        self.sizes, self.coord = (data, fsdp, 1), coord

    def size(self, dim):
        return self.sizes[dim]

    def get_coordinate(self):
        return [*self.coord, 0]


def test_shard_batch_takes_each_ranks_rows_or_the_ragged_whole(monkeypatch):
    batch = {"audio": torch.arange(8.0)[:, None].repeat(1, 3), "labels": torch.arange(8)}
    got = [tmesh.shard_batch(_Mesh(2, 2, (d, f)), batch) for d in (0, 1) for f in (0, 1)]
    for r, g in enumerate(got):
        assert g["labels"].tolist() == [2 * r, 2 * r + 1] and g["rows"] == (2 * r, 8)
        assert g["audio"].shape == (2, 3)
    ragged = {k: v[:6] for k, v in batch.items()}
    g = tmesh.shard_batch(_Mesh(2, 2, (1, 1)), ragged)
    assert g["labels"].tolist() == list(range(6)) and g["rows"] == (0, 6)
    # the loader already collated this process's rows of a global 8
    monkeypatch.setattr(mh, "process_count", lambda: 4)
    local = {k: v[4:6] for k, v in batch.items()}
    g = tmesh.shard_batch(_Mesh(2, 2, (1, 0)), local, global_rows=8)
    assert g["labels"].tolist() == [4, 5] and g["rows"] == (4, 8)


def _corpus(tmp_path, n=12):
    rng = np.random.RandomState(7)
    texts = ["你好世界", "胶辽官话", "语音识别测试", "多机并行"]
    rows = []
    for i in range(n):
        t = np.arange(int(16000 * 1.4)) / 16000.0
        wav = 0.3 * np.sin(2 * np.pi * (250 + 45 * i) * t) + 0.05 * rng.randn(len(t))
        write_wav(tmp_path / f"u{i}.wav", wav.astype(np.float32), 16000)
        rows.append(tman.ManifestRow(str(tmp_path / f"u{i}.wav"), texts[i % 4], 1.4, "jl"))
    tman.write_manifest(rows, tmp_path / "train.jsonl")
    return tmp_path / "train.jsonl"


@pytest.mark.parametrize("count", [1, 2, 4])
def test_batch_iterator_rows_of_each_process_match_jax(tmp_path, count):
    """Each process's rows, global_rows and iterator state are JAX's
    BatchIterator(process_index=p, process_count=n)'s, through an epoch
    boundary; the processes' rows concatenate to the one-process batch."""
    path = _corpus(tmp_path)
    jm, tm = jman.read_manifest(str(path)), tman.read_manifest(str(path))
    kw = dict(batch_size=4, bucket_boundaries_seconds=(2.0,), max_text_len=8)
    jtok = JTok.build(jm.texts())
    jits = [jpipe.BatchIterator(jm, jtok, jcfg.DataConfig(**kw), process_index=p,
                                process_count=count) for p in range(count)]
    tits = [tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw), process_index=p,
                                process_count=count) for p in range(count)]
    whole = tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw))
    for _ in range(5):
        w = next(whole)
        parts = []
        for jit, tit in zip(jits, tits):
            a, b = next(jit), next(tit)
            for f in ("audio", "audio_lengths", "labels", "label_lengths"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            assert b.texts == a.texts and b.global_rows == a.global_rows == 4
            assert len(b.audio) == 4 // count and tit.state_dict() == jit.state_dict()
            parts.append(b)
        np.testing.assert_array_equal(np.concatenate([b.audio for b in parts]), w.audio)
        assert w.global_rows == 4 and whole.state_dict() == tits[0].state_dict()


def test_batch_iterator_ragged_batch_whole_on_every_process_and_bad_count(tmp_path):
    """A tiny corpus's one partial batch (3 rows of 4, drop_last off) is
    collated whole by each of 2 processes, as in JAX; a batch size the
    process count does not divide raises JAX's error."""
    path = _corpus(tmp_path, n=3)
    jm, tm = jman.read_manifest(str(path)), tman.read_manifest(str(path))
    jtok = JTok.build(jm.texts())
    kw = dict(batch_size=4, bucket_boundaries_seconds=(2.0,), max_text_len=8)
    for p in (0, 1):
        a = next(jpipe.BatchIterator(jm, jtok, jcfg.DataConfig(**kw), drop_last=False,
                                     process_index=p, process_count=2))
        b = next(tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw),
                                     drop_last=False, process_index=p, process_count=2))
        np.testing.assert_array_equal(b.audio, a.audio)
        assert len(b.audio) == b.global_rows == a.global_rows == 3
    bad = dict(kw, batch_size=3)
    with pytest.raises(ValueError, match="divide") as want:
        jpipe.BatchIterator(jm, jtok, jcfg.DataConfig(**bad), process_index=0, process_count=2)
    with pytest.raises(ValueError, match="divide") as got:
        tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**bad), process_index=0,
                            process_count=2)
    assert str(got.value) == str(want.value)


_FNS = {  # name -> (jax fn, torch fn) on [1, 2, 3]
    "zero_divisor": (lambda x: x / jnp.zeros_like(x), lambda x: x / torch.zeros_like(x)),
    "nan": (lambda x: jnp.log(x - 10.0), lambda x: torch.log(x - 10.0)),
    "clean": (lambda x: x * 2, lambda x: x * 2),
}


@pytest.mark.parametrize("name", ["float", "div", "nan", "user", None])
def test_checked_error_sets_match_checkify(name):
    """For each of checkify's sets (and None), the port's checked raises
    where JAX's checked raises, on a zero divisor, a NaN and a clean
    function; the sets are JAX's own objects. (torch raises on an integer
    zero divisor by itself, whatever the set.)"""
    errors = None if name is None else getattr(checkify, f"{name}_checks")
    for fn, (jfn, tfn) in _FNS.items():
        try:
            jprof.checked(jfn, errors=errors)(jnp.arange(1.0, 4.0))
            want = False
        except Exception:
            want = True
        try:
            tprof.checked(tfn, errors=errors)(torch.arange(1.0, 4.0))
            got = False
        except FloatingPointError:
            got = True
        assert got == want, (name, fn)
    assert tprof.check_categories(errors) == (
        tprof.FLOAT_CHECKS if name in (None, "float") else
        {"div": tprof.DIV_CHECKS, "nan": tprof.NAN_CHECKS, "user": tprof.USER_CHECKS}[name])


def test_checked_refuses_the_index_set_by_name():
    with pytest.raises(NotImplementedError, match="index set"):
        tprof.checked(lambda x: x, errors=checkify.index_checks)
    with pytest.raises(NotImplementedError, match="out-of-bounds"):
        tprof.checked(lambda x: x, errors=checkify.all_checks)
    with pytest.raises(ValueError, match="unknown check"):
        tprof.checked(lambda x: x, errors={"bounds"})
    # the port's own names; an Inf in the output counts with the float set
    with pytest.raises(FloatingPointError):
        tprof.checked(lambda x: torch.exp(x * 1000.0), errors=tprof.FLOAT_CHECKS)(torch.ones(2))
    for only in (tprof.NAN_CHECKS, tprof.DIV_CHECKS):
        assert tprof.checked(lambda x: torch.exp(x * 1000.0),
                             errors=only)(torch.ones(2)).isinf().all()


def test_one_process_loop_matches_jax_train_loop_on_its_mesh(tmp_path):
    """JAX's train_loop on a 2 x 2 data x fsdp mesh of the CPU devices and
    the port's loop in one process, from the same weights over the same
    batches (f32 at "highest", SpecAugment and dropout off, WF adapters
    trained): every step's loss within tests/test_torch_train.py's bar."""
    from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle
    from jiao_liao_speech_recognition_tpu.train import engine as jeng
    from jiao_liao_speech_recognition_torch.models import convert
    from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel
    from jiao_liao_speech_recognition_torch.train import engine as teng

    path = _corpus(tmp_path, n=8)

    def exp(c, name):
        return c.ExperimentConfig(
            frontend=c.FrontendConfig(chunk_seconds=2.0),
            specaugment=c.SpecAugmentConfig(enabled=False),
            ctc_model=c.CTCModelConfig(d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
                                       conv_channels=32, dtype="float32", dropout=0.0,
                                       use_flash_attention=False,
                                       adapter=c.AdapterConfig(kind="wf", wf_rank=4)),
            mesh=c.MeshConfig(fsdp_axis=2),
            data=c.DataConfig(train_manifest=str(path), batch_size=4,
                              bucket_boundaries_seconds=(2.0,), max_text_len=8),
            train=c.TrainConfig(
                optimizer=c.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                            schedule="constant", total_steps=3),
                train_adapters_only=True, checkpoint_every_steps=100, log_every_steps=1,
                checkpoint_dir=str(tmp_path / name / "ckpt"),
                metrics_path=str(tmp_path / name / "m.jsonl")))

    jc, tc = exp(jcfg, "jax"), exp(tcfg, "torch")
    jm = jman.read_manifest(str(path))
    jtok = jeng.build_tokenizer_for(jc, jm)
    params = jax.tree_util.tree_map(np.asarray, JBundle._init_params(jc, seed=0))
    with jax.default_matmul_precision("highest"):
        jeng.train_loop(jc, jm, jtok, params)
    want = [r["loss"] for r in map(__import__("json").loads,
                                   (tmp_path / "jax" / "m.jsonl").read_text().splitlines())]
    tm = tman.read_manifest(str(path))
    ttok = teng.build_tokenizer_for(tc, tm)
    assert ttok.vocab == jtok.vocab and tc.ctc_model.vocab_size == jc.ctc_model.vocab_size
    model = CTCEncoderModel(tc.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(params))
    _, info = teng.train_loop(tc, tm, ttok, model)
    assert info["mesh"] is None and len(want) == len(info["losses"]) == 3
    np.testing.assert_allclose(info["losses"], want, rtol=LOSS_REL_BAR)
    assert dataclasses.asdict(tc.mesh) == dataclasses.asdict(jc.mesh)
