"""The port's model, weight bridge, greedy decode, tokenizer and bundle
against the JAX package: the same seeded inputs and the same weights go
through ``CTCEncoderModel.apply`` / ``ModelBundle`` on the JAX side (module
path on the CPU) and through their counterparts in the port."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import ctc as jctc  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import features as jf  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import ctc as tctc  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert, layers  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("bench_for_test", ROOT / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)
TINY = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256, conv_channels=64,
            vocab_size=60)
# f32 slice: the same arithmetic in both packages, sums reordered
F32_LOGP_BAR = 1e-4
# bf16 slice: the JAX module path rounds GELU and its inputs in bf16 where the
# port keeps the fused kernels' contract (GELU in f32, then bf16); measured
# max |d log-prob| 0.026 at this size. Ids are compared where the top-2
# margin exceeds this bar.
BF16_MARGIN = 0.1


def _feats(B=2, secs=3.0, seed=0):
    rng = np.random.RandomState(seed)
    wav = (0.1 * rng.randn(B, int(16000 * secs))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        return np.array(jf.log_mel_spectrogram(jnp.asarray(wav)))


def _jax_params(cfg_kw, seed=0):
    model = JModel(jcfg.CTCModelConfig(**cfg_kw))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 80, 64), jnp.float32))
    return model, params["params"]


def _port_model(cfg_kw, params):
    model = CTCEncoderModel(tcfg.CTCModelConfig(**cfg_kw))
    model.load_state_dict(convert.params_to_state_dict(params))
    return model.eval()


def test_sinusoidal_positions_and_length_mask_match_jax():
    got = layers.sinusoidal_positions(75, 128).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlayers.sinusoidal_positions(75, 128)))
    got = layers.sinusoidal_positions(75, 128, torch.bfloat16).float().numpy()
    want = np.asarray(jlayers.sinusoidal_positions(75, 128, jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got, want, atol=2.0 ** -8, rtol=0)  # one bf16 ulp at 1
    lens = np.asarray([5, 0, 9], np.int32)
    np.testing.assert_array_equal(
        layers.length_mask(torch.from_numpy(lens), 9).numpy(),
        np.asarray(jlayers.length_mask(jnp.asarray(lens), 9)),
    )


def _positions_before_the_cache(length, dim):
    """The table as the port built it before it was kept on the device:
    this numpy formula, copied to the device at each call."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_positions_table_is_the_old_table_bitwise(dtype):
    """The kept table grows for a longer length and is sliced for a shorter
    one; every slice is the old per-call table bit for bit, and a length
    seen before reads the kept storage (no host copy). Width 96 is used by
    no other test, so the lengths below come in this order."""
    for n in (40, 250, 7, 750, 250, 1):
        got = layers.sinusoidal_positions(n, 96, dtype)
        assert got.shape == (n, 96) and got.dtype == dtype
        assert torch.equal(got, torch.from_numpy(_positions_before_the_cache(n, 96)).to(dtype))
    kept = layers.sinusoidal_positions(750, 96, dtype).data_ptr()
    assert layers.sinusoidal_positions(250, 96, dtype).data_ptr() == kept
    assert layers.sinusoidal_positions(750, 96, dtype).data_ptr() == kept


def test_weight_bridge_maps_every_jax_param():
    _, params = _jax_params(TINY)
    state = convert.params_to_state_dict(params)
    model = CTCEncoderModel(tcfg.CTCModelConfig(**TINY))
    want = model.state_dict()
    assert set(state) == set(want)
    for k, v in state.items():
        assert v.shape == want[k].shape and v.dtype == torch.float32, k
    # flax Conv [k, in, out] -> torch [out, in, k]; Dense kernels stay [in, out]
    conv = np.asarray(params["subsample"]["conv1"]["kernel"])
    np.testing.assert_array_equal(state["subsample.conv1.weight"].numpy(), conv.transpose(2, 1, 0))
    q = np.asarray(params["block_1"]["self_attn"]["q_proj"]["dense"]["kernel"])
    np.testing.assert_array_equal(state["blocks.1.self_attn.q_proj.kernel"].numpy(), q)
    assert "blocks.0.self_attn.k_proj.bias" not in state  # k is unbiased


def _write_bench_npz(path, params, **extra):
    """bench.py::bench_parity's layout: one "p_a/b/c" key per leaf."""
    np.savez(path, **extra, **{"p_" + "/".join(map(str, k)): np.asarray(v)
                               for k, v in bench._flatten_params(params).items()})


def test_weight_bridge_reads_the_bench_parity_npz(tmp_path):
    _, params = _jax_params(TINY, seed=1)
    path = tmp_path / "parity.npz"
    _write_bench_npz(path, params, wavs=np.zeros((1, 4), np.float32),
                     lengths=np.ones(1, np.int32))
    got = convert.params_to_state_dict(convert.read_npz_params(path))
    want = convert.params_to_state_dict(params)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_whole_slice_f32_matches_jax():
    kw = dict(TINY, dtype="float32")
    jmodel, params = _jax_params(kw, seed=2)
    feats = _feats(seed=2)
    flens = np.asarray([300, 170], np.int32)
    with jax.default_matmul_precision("highest"):
        lp, olens = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens))
        jids, _ = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                               head_mode="argmax_ids")
    lp, olens, jids = np.asarray(lp), np.asarray(olens), np.asarray(jids)
    model = _port_model(kw, params)
    with torch.no_grad():
        tlp, tolens = model(torch.from_numpy(feats), torch.from_numpy(flens))
        tids, _ = model(torch.from_numpy(feats), torch.from_numpy(flens), head_mode="argmax_ids")
    np.testing.assert_array_equal(tolens.numpy(), olens)
    assert tuple(tlp.shape) == lp.shape == (2, 75, 60)
    valid = np.arange(75)[None, :] < olens[:, None]
    np.testing.assert_allclose(tlp.numpy()[valid], lp[valid], atol=F32_LOGP_BAR, rtol=0)
    np.testing.assert_array_equal(tids.numpy()[valid], jids[valid])
    np.testing.assert_array_equal(tlp.argmax(-1).numpy()[valid], lp.argmax(-1)[valid])


def test_whole_slice_bf16_matches_jax_where_the_margin_is_clear():
    jmodel, params = _jax_params(TINY, seed=3)
    feats = _feats(seed=3)
    flens = np.asarray([300, 170], np.int32)
    lp, olens = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens))
    lp, olens = np.asarray(lp), np.asarray(olens)
    model = _port_model(TINY, params)
    with torch.no_grad():
        tids, _ = model(torch.from_numpy(feats), torch.from_numpy(flens), head_mode="argmax_ids")
        plain_ids, _ = model(torch.from_numpy(feats), torch.from_numpy(flens),
                             head_mode="argmax_ids", kernels=False)
    # on the CPU the kernel wrappers are their plain versions, bit for bit
    assert torch.equal(tids, plain_ids)
    top2 = np.sort(lp, -1)[..., -2:]
    clear = (np.arange(75)[None, :] < olens[:, None]) & (top2[..., 1] - top2[..., 0] > BF16_MARGIN)
    assert clear.sum() > 0.5 * olens.sum()
    np.testing.assert_array_equal(tids.numpy()[clear], lp.argmax(-1)[clear])


def test_model_refuses_what_the_slice_does_not_carry():
    model = CTCEncoderModel(tcfg.CTCModelConfig(**dict(TINY, max_frames=100)))
    with pytest.raises(ValueError, match="max_frames"):
        model(torch.zeros(1, 80, 101))
    with pytest.raises(ValueError, match="head_mode"):
        model(torch.zeros(1, 80, 64), head_mode="logits")
    # banded attention is carried since the streaming slice
    # (tests/test_torch_limited_context.py holds it against JAX)
    banded = CTCEncoderModel(tcfg.CTCModelConfig(**dict(TINY, attention_left_context=16))).eval()
    with torch.no_grad():
        lp, lens = banded(torch.zeros(1, 80, 64))
    assert lp.shape == (1, 16, TINY["vocab_size"]) and bool(torch.isfinite(lp).all())


def test_greedy_collapse_and_times_match_jax():
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 5, size=(6, 40)).astype(np.int32)
    tokens[1, :] = 0  # all blank
    tokens[2, :] = 3  # one long run
    lens = np.asarray([40, 40, 40, 17, 1, 0], np.int32)
    jids, jn = jctc.ctc_greedy_collapse(jnp.asarray(tokens), jnp.asarray(lens))
    tids, tn = tctc.ctc_greedy_collapse(torch.from_numpy(tokens), torch.from_numpy(lens))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for b in range(6):
        assert tctc.ctc_collapse_with_times(tokens[b], lens[b]) == \
            jctc.ctc_collapse_with_times(tokens[b], lens[b])
    lp = rng.randn(3, 20, 7).astype(np.float32)
    jd = jctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens[:3]))
    td = tctc.ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens[:3]))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd[0]))
    np.testing.assert_array_equal(td[1].numpy(), np.asarray(jd[1]))


def test_char_tokenizer_twin_round_trips_the_same_vocab_json(tmp_path):
    texts = ["胶辽官话 你好", "海阳话，莱阳", "abc 123"]
    jt = JTok.build(texts)
    jt.save(tmp_path / "vocab.json")
    tt = TTok.load(tmp_path / "vocab.json")
    assert tt.vocab == jt.vocab and len(tt) == len(jt)
    for s in texts + ["未见字"]:
        assert tt.encode(s) == jt.encode(s)
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s))
    tt.save(tmp_path / "again.json")
    assert JTok.load(tmp_path / "again.json").vocab == jt.vocab


def test_bundle_transcribe_matches_jax_with_chunking(tmp_path):
    """A tiny f32 model with 2 s chunks: a 5 s request is decoded as three
    chunks and re-joined; texts and timestamps must equal the JAX bundle's."""
    kw = dict(TINY, dtype="float32")
    _, params = _jax_params(kw, seed=5)
    vocab = [chr(0x4E00 + i) for i in range(kw["vocab_size"] - 2)]
    jexp = jcfg.ExperimentConfig(frontend=jcfg.FrontendConfig(chunk_seconds=2.0),
                                 ctc_model=jcfg.CTCModelConfig(**kw))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    jcfg.save_yaml(jexp, str(ckpt / "config.yaml"))
    _write_bench_npz(ckpt / "params.npz", params)
    JTok(vocab).save(ckpt / "vocab.json")

    rng = np.random.RandomState(6)
    audio = [(0.1 * rng.randn(int(16000 * s))).astype(np.float32) for s in (1.0, 5.0, 0.3)]
    jb = JBundle(config=jexp, params=params, tokenizer=JTok(vocab))
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe(audio)
        want_timed = jb.transcribe_timed(audio)
    tb = api.load(checkpoint=str(ckpt), device="cpu")
    assert isinstance(tb, ModelBundle) and tb.config.frontend.chunk_seconds == 2.0
    got = api.transcribe(tb, audio)
    assert got == want and all(len(s) > 0 for s in got)
    assert api.transcribe(tb, audio, timestamps=True) == want_timed
    # the 5 s request spans chunks: its timestamps run past the first chunk
    assert max(tok["end"] for tok in want_timed[1]) > 4.0

    # the CTC beam (the C++ engine over the top-k posteriors) transcribes,
    # with the JAX bundle's texts
    with jax.default_matmul_precision("highest"):
        want_beam = jb.transcribe(audio, decode_cfg=jcfg.DecodeConfig(strategy="beam"))
    assert tb.transcribe(audio, decode_cfg=tcfg.DecodeConfig(strategy="beam")) == want_beam
    # audio at another rate is resampled on the bundle's device, as JAX's
    with jax.default_matmul_precision("highest"):
        want_8k = jb.transcribe(audio, sample_rate=8000)
    assert tb.transcribe(audio, sample_rate=8000) == want_8k


def test_api_featurize_matches_jax_api():
    from jiao_liao_speech_recognition_tpu import api as japi

    rng = np.random.RandomState(7)
    wavs = [(0.1 * rng.randn(n)).astype(np.float32) for n in (16000, 24000)]
    fe_t = tcfg.FrontendConfig(chunk_seconds=2.0)
    fe_j = jcfg.FrontendConfig(chunk_seconds=2.0)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(japi.featurize(wavs, fe_j))
    got = api.featurize(wavs, fe_t, device="cpu").numpy()
    assert got.shape == want.shape == (2, 80, 200)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
