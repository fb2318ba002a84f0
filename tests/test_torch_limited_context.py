"""Limited-context (banded) attention in the port (CTCModelConfig.
attention_left_context / attention_right_context / position_mode) on the
CPU, against the JAX package's:

* banded_length_mask equals JAX's, band by band;
* the banded encoder's log-probs (f32, with and without positions, with an
  Att adapter whose attention takes the same band) are JAX's within
  F32_BAR, on the JAX params carried over by models/convert.py;
* the output at frame t does not depend on inputs outside its band (plus
  the conv subsampler's slack): what makes early streaming commits safe;
* with position_mode="none" and local features (whisper_norm off),
  sliding-window streaming reproduces the offline text exactly;
* position_mode is validated."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.layers import banded_length_mask  # noqa: E402
from jiao_liao_speech_recognition_torch.serve.streaming import (  # noqa: E402
    StreamingConfig,
    StreamingTranscriber,
)
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

SR = 16000
# f32 log-probs of the same encoder in both packages: sums reordered
F32_BAR = 1e-5
TINY = dict(vocab_size=8, d_model=32, num_layers=2, num_heads=2, mlp_dim=64, conv_channels=16,
            dtype="float32", use_flash_attention=False, dropout=0.0)


def test_banded_length_mask_values():
    m = banded_length_mask(torch.tensor([4, 6]), 6, left=1, right=2).numpy()
    assert m.shape == (2, 1, 6, 6)
    # row q=2 of batch 0 (length 4): keys 1..4 in the band, key 4 on invalid
    assert m[0, 0, 2].tolist() == [False, True, True, True, False, False]
    assert m[1, 0, 2].tolist() == [False, True, True, True, True, False]
    assert banded_length_mask(torch.tensor([6]), 6, -1, -1).all()
    left_only = banded_length_mask(torch.tensor([6]), 6, 2, -1).numpy()
    assert left_only[0, 0, 4].tolist() == [False, False, True, True, True, True]


@pytest.mark.parametrize("left,right", [(0, 0), (1, 2), (3, -1), (-1, 2), (-1, -1), (8, 4)])
def test_banded_length_mask_matches_jax(left, right):
    lens = np.asarray([1, 7, 12, 0], np.int32)
    got = banded_length_mask(torch.from_numpy(lens), 12, left, right).numpy()
    want = np.asarray(jlayers.banded_length_mask(jnp.asarray(lens), 12, left, right))
    np.testing.assert_array_equal(got, want)


def _pair(left, right, position_mode="none", **extra):
    """(JAX model, params, port model) on the same weights."""
    kw = dict(TINY, attention_left_context=left, attention_right_context=right,
              position_mode=position_mode, **extra)
    jm = JModel(jcfg.CTCModelConfig(**{k: v for k, v in kw.items() if k != "adapter"},
                                    **({"adapter": jcfg.AdapterConfig(**extra["adapter"])}
                                       if "adapter" in extra else {})))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 64), jnp.float32))["params"]
    tk = dict(kw)
    if "adapter" in tk:
        tk["adapter"] = tcfg.AdapterConfig(**tk["adapter"])
    tm = CTCEncoderModel(tcfg.CTCModelConfig(**tk))
    tm.load_state_dict(convert.params_to_state_dict(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("left,right,position_mode,adapter", [
    (4, 2, "none", None),
    (8, 0, "sinusoidal", None),
    (-1, 3, "none", None),
    (4, 2, "none", dict(kind="att", att_num_heads=2, att_key_dim=8)),
    (4, 2, "none", dict(kind="bottleneck", bottleneck_dim=8)),
])
def test_banded_encoder_matches_jax(left, right, position_mode, adapter):
    extra = {} if adapter is None else {"adapter": adapter}
    jm, params, tm = _pair(left, right, position_mode, **extra)
    if adapter is not None:  # the slots are zero-initialised: give them weights
        rng = np.random.RandomState(1)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32), params)
        tm.load_state_dict(convert.params_to_state_dict(params))
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 80, 96).astype(np.float32)
    lens = np.asarray([96, 61, 9], np.int32)
    with jax.default_matmul_precision("highest"):
        jlp, jlens = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        tlp, tlens = tm(torch.from_numpy(feats), torch.from_numpy(lens))
        tids, _ = tm(torch.from_numpy(feats), torch.from_numpy(lens), head_mode="argmax_ids")
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    valid = np.arange(tlp.shape[1])[None, :] < tlens.numpy()[:, None]
    diff = np.abs(tlp.numpy() - np.asarray(jlp))[valid]
    assert diff.max() <= F32_BAR, diff.max()
    np.testing.assert_array_equal(tids.numpy(), tlp.argmax(-1).numpy())


def test_limited_context_independence():
    """Log-probs at frame t do not change when features beyond t + right +
    the conv slack change (nor, symmetrically, before t - left)."""
    _, _, model = _pair(4, 2)
    rng = np.random.RandomState(0)
    base = rng.randn(1, 80, 64).astype(np.float32)
    # enc frame 6 sees mel frames <= 4 * (6 + 2) + 3 = 35; perturb from mel 40
    pert = base.copy()
    pert[:, :, 40:] += rng.randn(1, 80, 24).astype(np.float32)
    with torch.no_grad():
        lp0, _ = model(torch.from_numpy(base))
        lp1, _ = model(torch.from_numpy(pert))
    np.testing.assert_array_equal(lp0[0, :6].numpy(), lp1[0, :6].numpy())
    # without the band the same perturbation changes frame 6
    _, _, full = _pair(-1, -1)
    with torch.no_grad():
        f0, _ = full(torch.from_numpy(base))
        f1, _ = full(torch.from_numpy(pert))
    assert (f0[0, :6] - f1[0, :6]).abs().max() > 0
    # left side: enc frame 20 with left 4 ignores mels < 4 * (20 - 4) - 3 = 61
    pert_l = base.copy()
    pert_l[:, :, :48] += rng.randn(1, 80, 48).astype(np.float32)
    with torch.no_grad():
        lp2, _ = model(torch.from_numpy(pert_l))
    np.testing.assert_array_equal(lp0[0, 20:22].numpy(), lp2[0, 20:22].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_matches_offline_exactly_with_band(seed):
    """What limited-context training buys: streamed text equals offline
    text exactly, on any audio (a random-init model, JAX's params)."""
    jc = jcfg.ExperimentConfig(model_family="ctc", ctc_model=jcfg.CTCModelConfig(
        **TINY, attention_left_context=8, attention_right_context=4, position_mode="none"))
    tc = tcfg.ExperimentConfig(model_family="ctc", ctc_model=tcfg.CTCModelConfig(
        **TINY, attention_left_context=8, attention_right_context=4, position_mode="none"))
    for cfg in (jc, tc):
        cfg.frontend.chunk_seconds = 3.2
        cfg.frontend.whisper_norm = False  # a per-window max would break locality
    bundle = api.load(config=tc, device="cpu")
    bundle.model.load_state_dict(convert.params_to_state_dict(JBundle._init_params(jc)))
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(6)])
    audio = (np.random.RandomState(seed).randn(int(3.2 * SR)) * 0.1).astype(np.float32)
    offline = bundle.transcribe(audio)[0]
    st = StreamingTranscriber(bundle, StreamingConfig(1.92, 0.32, 0.32))
    for c in np.split(audio, np.sort(np.random.RandomState(7 + seed).randint(1, len(audio), 5))):
        st.feed(c)
    assert st.finish().text == offline and offline


def test_position_mode_validation():
    with pytest.raises(ValueError, match="position_mode"):
        CTCEncoderModel(tcfg.CTCModelConfig(**TINY, position_mode="bogus"))
