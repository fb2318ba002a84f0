"""The port's waveform augmentation against the JAX package's
``frontend/augment.py``: every deterministic core, given the values JAX
draws, lies within 1e-5 of JAX's transform (gain, SNR noise, speed, pitch
and its overlap-add stretch, the three FIR tap designs, the depthwise
filter, time stretch); the draws match JAX's in distribution over many
seeds (the torch generator's bits are not JAX's); one seed gives one
output and another seed another; and train steps of the ctc and joint
families with augmentation on are finite, with a resumed run bitwise an
uninterrupted one. Small seeded numpy inputs, f32."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.frontend import augment as jaug  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import augment as taug  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine as teng  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

CORE_BAR = 1e-5  # f32 on both sides, sums (resampler, filter) reordered
B, L = 3, 4000


@pytest.fixture(scope="module")
def wav():
    return (0.3 * np.random.RandomState(0).randn(B, L)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < CORE_BAR


def _jax(fn, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*args))


# --- the cores, on JAX's drawn values -------------------------------------------------


def test_gain_and_noise_cores_match_jax(wav):
    key = jax.random.PRNGKey(3)
    g_db = jax.random.uniform(key, (B, 1), minval=-6.0, maxval=6.0)
    _close(taug.apply_gain(_t(wav), _t(g_db)), _jax(jaug.random_gain, key, wav, -6.0, 6.0))
    kn, ks = jax.random.split(key)
    snr = jax.random.uniform(ks, (B, 1), minval=10.0, maxval=40.0)
    noise = jax.random.normal(kn, wav.shape)
    _close(taug.apply_noise(_t(wav), _t(snr), _t(noise)),
           _jax(jaug.add_noise_snr, key, wav, 10.0, 40.0))


@pytest.mark.parametrize("rate", [0.9, 1.0, 1.1, 0.95])
def test_speed_core_matches_jax(wav, rate):
    want = _jax(jaug.speed_perturb, jax.random.PRNGKey(0), jnp.asarray(wav), (rate,))
    _close(taug.apply_speed(_t(wav), rate), want)
    _close(taug.speed_perturb(torch.Generator().manual_seed(0), _t(wav), (rate,)), want)


@pytest.mark.parametrize("semitones", [-2, -1, 1, 2])
def test_pitch_core_matches_jax(wav, semitones):
    want = _jax(jaug.pitch_shift, jax.random.PRNGKey(0), jnp.asarray(wav), semitones, semitones)
    _close(taug.apply_pitch(_t(wav), semitones), want)
    _close(taug.pitch_shift(torch.Generator().manual_seed(0), _t(wav), semitones, semitones),
           want)


@pytest.mark.parametrize("m,n", [(4000, 3600), (3600, 4000), (4000, 4444), (300, 700),
                                 (700, 300), (5, 600), (512, 513)])
def test_ola_stretch_matches_jax(m, n):
    y = (0.3 * np.random.RandomState(m + n).randn(2, m)).astype(np.float32)
    _close(taug._ola_stretch_to(_t(y), n), _jax(jaug._ola_stretch_to, jnp.asarray(y), n))


@pytest.mark.parametrize("rate", [0.8, 0.9, 1.0, 1.1, 1.25])
def test_time_stretch_core_matches_jax(wav, rate):
    want = _jax(jaug.time_stretch, jax.random.PRNGKey(0), jnp.asarray(wav), (rate,))
    _close(taug.apply_time_stretch(_t(wav), rate), want)
    _close(taug.time_stretch(torch.Generator().manual_seed(0), _t(wav), (rate,)), want)


@pytest.mark.parametrize("taps", [101, 31])
def test_fir_tap_designs_match_jax(taps):
    rng = np.random.RandomState(taps)
    f_lo = rng.uniform(20 / 16000, 400 / 16000, (B, 1)).astype(np.float32)
    f_hi = rng.uniform(2000 / 16000, 7500 / 16000, (B, 1)).astype(np.float32)
    _close(taug.lowpass_fir_taps(_t(f_hi), taps), jaug.lowpass_fir_taps(jnp.asarray(f_hi), taps))
    _close(taug.highpass_fir_taps(_t(f_lo), taps), jaug.highpass_fir_taps(jnp.asarray(f_lo), taps))
    _close(taug.bandpass_fir_taps(_t(f_lo), _t(f_hi), taps),
           jaug.bandpass_fir_taps(jnp.asarray(f_lo), jnp.asarray(f_hi), taps))


def test_depthwise_filter_and_random_filters_match_jax(wav):
    k = (np.random.RandomState(5).randn(B, 101) * 0.1).astype(np.float32)
    _close(taug.depthwise_filter(_t(wav), _t(k)), _jax(jaug.depthwise_filter, wav, k))
    k_even = k[:, :16]  # the 'same' padding of an even length
    _close(taug.depthwise_filter(_t(wav), _t(k_even)), _jax(jaug.depthwise_filter, wav, k_even))
    key, sr, taps = jax.random.PRNGKey(9), 16000, 101
    lo, hi = (2000.0, 7500.0), (20.0, 400.0)
    fc = jax.random.uniform(key, (B, 1), minval=lo[0] / sr, maxval=lo[1] / sr)
    _close(taug.depthwise_filter(_t(wav), taug.lowpass_fir_taps(_t(fc), taps)),
           _jax(jaug.random_lowpass, key, wav, lo, sr, taps))
    fc = jax.random.uniform(key, (B, 1), minval=hi[0] / sr, maxval=hi[1] / sr)
    _close(taug.depthwise_filter(_t(wav), taug.highpass_fir_taps(_t(fc), taps)),
           _jax(jaug.random_highpass, key, wav, hi, sr, taps))
    klo, khi = jax.random.split(key)
    f_lo = jax.random.uniform(klo, (B, 1), minval=hi[0] / sr, maxval=hi[1] / sr)
    f_hi = jax.random.uniform(khi, (B, 1), minval=lo[0] / sr, maxval=lo[1] / sr)
    _close(taug.depthwise_filter(_t(wav), taug.bandpass_fir_taps(_t(f_lo), _t(f_hi), taps)),
           _jax(jaug.random_bandpass, key, wav, hi, lo, sr, taps))


# --- the draws, in distribution ----------------------------------------------------------


def test_per_row_draws_match_jax_in_distribution():
    """Gain dB and SNR per row: the same range, mean and spread as JAX's
    over 4096 rows."""
    rows = 4096
    ones = np.ones((rows, 64), np.float32)
    got_db = 20 * np.log10(taug.random_gain(torch.Generator().manual_seed(0), _t(ones),
                                            -6.0, 6.0).numpy()[:, 0])
    want_db = 20 * np.log10(np.asarray(jaug.random_gain(jax.random.PRNGKey(0), ones,
                                                        -6.0, 6.0))[:, 0])
    sig = np.tile(np.sign(np.sin(np.arange(4096))).astype(np.float32), (rows // 8, 1))

    def snr(out):
        noise = out - sig
        return 10 * np.log10((sig ** 2).mean(1) / (noise ** 2).mean(1))

    got_snr = snr(taug.add_noise_snr(torch.Generator().manual_seed(1), _t(sig), 10.0, 40.0)
                  .numpy())
    want_snr = snr(np.asarray(jaug.add_noise_snr(jax.random.PRNGKey(1), sig, 10.0, 40.0)))
    for got, want, lo, hi in ((got_db, want_db, -6, 6), (got_snr, want_snr, 9.5, 40.5)):
        assert got.min() >= lo - 1e-3 and got.max() <= hi + 1e-3
        assert abs(got.mean() - want.mean()) < 0.05 * (hi - lo)
        assert abs(got.std() - want.std()) < 0.05 * (hi - lo)


def test_gates_and_rate_picks_match_jax_in_distribution(monkeypatch):
    """Over 400 seeds: each transform runs with its probability (JAX's gate
    frequency measured on a gain-only chain), and the speed, pitch and
    stretch picks are uniform over their sets, as JAX's randint."""
    n = 400
    cfg_kw = dict(enabled=True, probability=0.3, lowpass_probability=0.6,
                  highpass_probability=0.2, bandpass_probability=0.5,
                  time_stretch_rates=(0.9, 1.1))
    counts = {}

    def spy(name):
        core = name.startswith("apply")  # (wav, drawn value); the rest (gen, wav, ...)

        def wrapped(*args, **kw):
            counts.setdefault(name, []).append(args[-1] if core else 1)
            return args[0] if core else args[1]
        return wrapped

    for name in ("random_gain", "add_noise_snr", "apply_speed", "apply_pitch", "random_lowpass",
                 "random_highpass", "random_bandpass", "apply_time_stretch"):
        monkeypatch.setattr(taug, name, spy(name))
    x = torch.zeros(1, 64)
    for seed in range(n):
        taug.augment_waveform(torch.Generator().manual_seed(seed), x,
                              tcfg.AugmentConfig(**cfg_kw))
    p = {"random_gain": 0.3, "add_noise_snr": 0.3, "apply_speed": 0.3, "apply_pitch": 0.3,
         "random_lowpass": 0.6, "random_highpass": 0.2, "random_bandpass": 0.5,
         "apply_time_stretch": 0.3}
    for name, prob in p.items():
        freq = len(counts.get(name, [])) / n
        assert abs(freq - prob) < 4 * np.sqrt(prob * (1 - prob) / n), (name, freq)
    for name, values in (("apply_speed", (0.9, 1.0, 1.1)), ("apply_pitch", (-2, -1, 1, 2)),
                         ("apply_time_stretch", (0.9, 1.1))):
        hist = np.array([counts[name].count(v) for v in values]) / len(counts[name])
        assert np.abs(hist - 1 / len(values)).max() < 0.2, (name, hist)

    # JAX's gate: a +6 dB gain is applied to the whole batch or not
    jcfg_gain = jcfg.AugmentConfig(enabled=True, probability=0.3, gain_db=(6.0, 6.0),
                                   noise_snr_db=(300.0, 300.0), speed_rates=(1.0,),
                                   pitch_semitones=(0.0, 0.0))
    sig = jnp.full((2, 64), 0.25)
    out = jax.jit(jax.vmap(lambda k: jaug.augment_waveform(k, sig, jcfg_gain)))(
        jax.random.split(jax.random.PRNGKey(0), n))
    gained = np.asarray(jnp.all(out > 0.4, axis=(1, 2)))
    assert np.asarray(jnp.all((out > 0.4) | (out == 0.25), axis=(1, 2))).all()
    freq = gained.mean()
    assert abs(freq - 0.3) < 4 * np.sqrt(0.21 / n)
    assert abs(freq - len(counts["random_gain"]) / n) < 0.1
    picks = [taug._pick(torch.Generator().manual_seed(i), 3, "cpu") for i in range(n)]
    assert np.abs(np.bincount(picks, minlength=3) / n - 1 / 3).max() < 0.1
    jax_picks = np.bincount(np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 3))(
        jax.random.split(jax.random.PRNGKey(1), n))), minlength=3) / n
    assert np.abs(jax_picks - 1 / 3).max() < 0.1


def test_same_seed_same_output_and_another_seed_another():
    cfg = tcfg.AugmentConfig(enabled=True, probability=1.0, lowpass_probability=1.0,
                             highpass_probability=1.0, bandpass_probability=1.0,
                             time_stretch_rates=(0.9, 1.1))
    x = _t(0.3 * np.random.RandomState(2).randn(2, 6000))
    a = taug.augment_waveform(torch.Generator().manual_seed(11), x, cfg)
    b = taug.augment_waveform(torch.Generator().manual_seed(11), x, cfg)
    c = taug.augment_waveform(torch.Generator().manual_seed(12), x, cfg)
    assert a.shape == x.shape and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, x)
    off = taug.augment_waveform(torch.Generator().manual_seed(11), x, tcfg.AugmentConfig())
    assert off is x


# --- training with augmentation ----------------------------------------------------------

AUG = tcfg.AugmentConfig(enabled=True, lowpass_probability=0.5, highpass_probability=0.5,
                         bandpass_probability=0.5, time_stretch_rates=(0.9, 1.1))


def test_ctc_training_with_augmentation_is_finite_and_resumes_bitwise(tmp_path):
    from test_torch_train import _corpus, _fresh, _train_cfg

    manifest = _corpus(tmp_path)
    m = tman.read_manifest(manifest)
    cfg_a = dataclasses.replace(_train_cfg(tmp_path / "a", manifest), augment=AUG)
    tok, model_a = _fresh(cfg_a, manifest)
    _, info_a = teng.train_loop(cfg_a, m, tok, model_a, kernels=False)
    assert len(info_a["losses"]) == 4 and all(np.isfinite(info_a["losses"]))

    cfg_b = dataclasses.replace(_train_cfg(tmp_path / "b", manifest), augment=AUG)
    tok, model_b = _fresh(cfg_b, manifest)
    teng.train_loop(cfg_b, m, tok, model_b, max_steps=2)
    tok, model_c = _fresh(cfg_b, manifest)
    _, info_c = teng.train_loop(cfg_b, m, tok, model_c, resume=True)
    assert info_c["losses"] == info_a["losses"][2:]
    for (k, a), (_, c) in zip(model_a.state_dict().items(), model_c.state_dict().items()):
        assert torch.equal(a, c), k
    # the augmentation moves the loss: the same run without it differs
    cfg_off = _train_cfg(tmp_path / "off", manifest)
    tok, model_off = _fresh(cfg_off, manifest)
    _, info_off = teng.train_loop(cfg_off, m, tok, model_off, max_steps=1)
    assert info_off["losses"][0] != info_a["losses"][0]


def test_joint_train_step_with_augmentation_is_finite(tmp_path):
    from test_torch_joint_train import _corpus, _train_cfg

    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=1)
    cfg.augment = AUG
    m = tman.read_manifest(manifest)
    tok = teng.build_tokenizer_for(cfg, m)
    state, info = teng.train_loop(cfg, m, tok, teng.make_model(cfg, "cpu"), kernels=False)
    assert state.step == 1 and np.isfinite(info["losses"][0])
    assert {"loss_ctc", "loss_att"} <= set(info["last_metrics"])
