"""Five public names of the JAX package that the port carries under the same
module names, each against the JAX function on the same seeded inputs:
``evals.metrics.edit_ops`` (exact, on random and edge pairs),
``data.manifest.Manifest.dialects`` (exact), ``ops.ctc_loss.ctc_loss_mean``
(within CTC_MEAN_REL relative), ``frontend.features.stft_power`` (within
STFT_BAR of the largest power) and ``ModelBundle.encode`` (the log-probs
within the f32 encoder bar of tests/test_torch_model.py, the lengths
exact), the JAX side at HIGHEST matmul precision."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.manifest import Manifest as JManifest  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.manifest import ManifestRow as JRow  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.evals.metrics import edit_ops as jedit_ops  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend.features import stft_power as jstft  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.joint import JointCTCAttentionModel as JJoint  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops.ctc_loss import ctc_loss_mean as jctc_mean  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.manifest import Manifest, ManifestRow  # noqa: E402
from jiao_liao_speech_recognition_torch.evals.metrics import edit_distance, edit_ops  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.features import stft_power  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.ctc_loss import ctc_loss_mean  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

CTC_MEAN_REL = 1e-5
STFT_BAR = 1e-5  # of the largest power in the batch
F32_LOGP_BAR = 1e-4  # tests/test_torch_model.py's f32 bar on the encoder's log-probs
EDGE_PAIRS = [("", ""), ("", "abc"), ("abc", ""), ("abc", "abc"), ("abc", "xyz"),
              ("aaaa", "a"), ("a", "aaaa"), ("ab", "ba"), ("kitten", "sitting"),
              ("交辽官话", "交辽话"), (["we", "go"], ["we", "went", "go"])]


def test_edit_ops_is_jaxs_on_random_and_edge_pairs():
    """Hits, substitutions, deletions and insertions equal JAX's on every
    pair (its backtrace's tie order), and S + D + I is the distance."""
    rng = np.random.RandomState(0)
    pairs = list(EDGE_PAIRS)
    for _ in range(300):
        n, m, k = rng.randint(0, 14), rng.randint(0, 14), rng.randint(1, 5)
        pairs.append((list(rng.randint(0, k, n)), list(rng.randint(0, k, m))))
    for ref, hyp in pairs:
        got = edit_ops(ref, hyp)
        assert got == jedit_ops(ref, hyp), (ref, hyp)
        hits, subs, dels, ins = got
        assert subs + dels + ins == edit_distance(ref, hyp)
        assert hits + subs + dels == len(ref) and hits + subs + ins == len(hyp)


def test_manifest_dialects_is_jaxs():
    rows = [("a.wav", "交", "jiaoliao"), ("b.wav", "辽", "jilu"), ("c.wav", "话", ""),
            ("d.wav", "官", "jiaoliao"), ("e.wav", "话", "beijing")]
    got = Manifest([ManifestRow(a, t, 1.0, d) for a, t, d in rows]).dialects()
    want = JManifest([JRow(a, t, 1.0, d) for a, t, d in rows]).dialects()
    assert got == want == ["", "beijing", "jiaoliao", "jilu"]
    assert Manifest().dialects() == JManifest().dialects() == []


@pytest.mark.parametrize("case", ["feasible", "empty_label", "infeasible"])
def test_ctc_loss_mean_is_jaxs(case):
    """The label-normalised batch mean within CTC_MEAN_REL: ragged frames
    and labels; a row with no labels (its divisor clamped to 1); a row whose
    labels need more frames than it has (both packages' 1e30 floor)."""
    rng = np.random.RandomState(4)
    B, T, V, S = 4, 20, 7, 6
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rng.randn(B, T, V).astype(np.float32)), -1))
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    frames = np.array([20, 17, 9, 14], np.int32)
    lab_lens = np.array([6, 3, 4, 1], np.int32)
    if case == "empty_label":
        lab_lens[2] = 0
    elif case == "infeasible":
        frames[3], lab_lens[3] = 2, 5
    want = float(jctc_mean(jnp.asarray(lp), jnp.asarray(frames), jnp.asarray(labels),
                           jnp.asarray(lab_lens)))
    got = float(ctc_loss_mean(torch.from_numpy(lp), torch.from_numpy(frames),
                              torch.from_numpy(labels), torch.from_numpy(lab_lens)))
    assert np.isfinite(want) and abs(got - want) <= CTC_MEAN_REL * abs(want), (got, want)


@pytest.mark.parametrize("n_fft, hop, L", [(400, 160, 16000), (512, 128, 3001), (64, 16, 200)])
def test_stft_power_is_jaxs(n_fft, hop, L):
    """The centered, reflect-padded power STFT [B, n_freqs, 1 + L // hop]
    within STFT_BAR of the batch's largest power (Whisper's geometry, an
    even FFT with a ragged tail, a short one)."""
    wav = (0.3 * np.random.RandomState(n_fft).randn(2, L)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jstft(jnp.asarray(wav), n_fft, hop))
    got = stft_power(torch.from_numpy(wav), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + L // hop)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=STFT_BAR * float(want.max()), rtol=0)


CTC_TINY = dict(d_model=128, num_layers=2, num_heads=2, mlp_dim=256, conv_channels=64,
                vocab_size=60, dtype="float32")
JOINT_TINY = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2,
                  mlp_dim=64, conv_channels=16, dropout=0.0, use_flash_attention=False,
                  max_target_positions=32, dtype="float32")


def _bundles(family):
    """A JAX bundle and the port's on the same weights (the weight bridge)."""
    if family == "ctc":
        jexp = jcfg.ExperimentConfig(ctc_model=jcfg.CTCModelConfig(**CTC_TINY))
        texp = tcfg.ExperimentConfig(ctc_model=tcfg.CTCModelConfig(**CTC_TINY))
        params = JModel(jexp.ctc_model).init(jax.random.PRNGKey(2),
                                             jnp.zeros((1, 80, 64), jnp.float32))["params"]
        state, V = convert.params_to_state_dict(params), CTC_TINY["vocab_size"]
    else:
        jexp, texp = (m.ExperimentConfig(model_family="joint",
                                         joint=m.JointModelConfig(**JOINT_TINY))
                      for m in (jcfg, tcfg))
        params = JJoint(jexp.joint).init(jax.random.PRNGKey(2), jnp.zeros((1, 80, 64)),
                                         jnp.full((1,), 64, jnp.int32),
                                         jnp.zeros((1, 4), jnp.int32))["params"]
        state, V = convert.joint_params_to_state_dict(params), JOINT_TINY["vocab_size"]
    jb = JBundle(config=jexp, params=params,
                 tokenizer=JTok([chr(0x4E00 + i) for i in range(V - 2)]))
    tb = api.load(config=texp, device="cpu")
    tb.model.load_state_dict(state)
    return jb, tb


@pytest.mark.parametrize("family", ["ctc", "joint"])
def test_bundle_encode_is_jaxs(family):
    """(log-probs, lengths) of ModelBundle.encode on ragged frames: the
    lengths exact, the log-probs within F32_LOGP_BAR on the valid frames
    (the JAX joint bundle also hands back its absent decoder logits)."""
    jb, tb = _bundles(family)
    rng = np.random.RandomState(5)
    feats = (0.5 * rng.randn(2, 80, 300)).astype(np.float32)
    flens = np.array([300, 170], np.int32)
    with jax.default_matmul_precision("highest"):
        lp, olens = jb.encode(jnp.asarray(feats), jnp.asarray(flens))[:2]
    lp, olens = np.asarray(lp), np.asarray(olens)
    got_lp, got_lens = tb.encode(torch.from_numpy(feats), torch.from_numpy(flens))
    np.testing.assert_array_equal(got_lens.numpy(), olens)
    assert got_lp.dtype == torch.float32 and tuple(got_lp.shape) == lp.shape
    valid = np.arange(lp.shape[1])[None, :] < olens[:, None]
    np.testing.assert_allclose(got_lp.numpy()[valid], lp[valid], atol=F32_LOGP_BAR, rtol=0)


def test_bundle_encode_refuses_a_whisper_bundle():
    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=tcfg.WhisperConfig(
        vocab_size=50, d_model=64, encoder_layers=1, decoder_layers=1, num_heads=4, mlp_dim=128,
        max_target_positions=24, use_flash_attention=False, dtype="float32"))
    tb = api.load(config=cfg, device="cpu")
    with pytest.raises(ValueError, match="model.encode"):
        tb.encode(torch.zeros(1, 80, 100), torch.full((1,), 100))
