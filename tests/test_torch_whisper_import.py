"""HF Whisper import into the port, against transformers: a random-init
WhisperForConditionalGeneration built locally (no network) is saved as
safetensors, imported by models/whisper_import.py, and must give the same
logits (within 2e-4 in f32) and the same greedy tokens as transformers'
generate(), with and without suppressed tokens."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from jiao_liao_speech_recognition_tpu.models import whisper_import as jimp  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.whisper_generate import greedy_generate  # noqa: E402
from jiao_liao_speech_recognition_torch.models import whisper_import as timp  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402

LOGIT_BAR = 2e-4  # f32 on both sides, sums reordered (the JAX import test's bar)


@pytest.fixture(scope="module")
def hf_whisper(tmp_path_factory):
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    hf_cfg = HFConfig(
        vocab_size=200, num_mel_bins=80, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
        decoder_ffn_dim=128, max_source_positions=150, max_target_positions=32,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1,
        suppress_tokens=[], begin_suppress_tokens=[],
    )
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    d = tmp_path_factory.mktemp("hfw")
    model.save_pretrained(d, safe_serialization=True)
    return model, d


def _port(ckpt_dir):
    cfg = timp.whisper_config_from_hf(ckpt_dir)
    cfg.dtype = "float32"
    model = WhisperModel(cfg)
    model.load_state_dict(timp.load_hf_whisper(ckpt_dir, cfg))
    return model.eval()


def test_safetensors_reader_and_config_match_jax(hf_whisper):
    _, d = hf_whisper
    f = sorted(d.glob("*.safetensors"))[0]
    got, want = timp.read_safetensors(f), jimp.read_safetensors(f)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert dataclasses.asdict(timp.whisper_config_from_hf(d)) == \
        dataclasses.asdict(jimp.whisper_config_from_hf(d))


def test_bf16_safetensors_upcast(tmp_path):
    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [3], "data_offsets": [0, 6]}}).encode()
    (tmp_path / "x.safetensors").write_bytes(len(header).to_bytes(8, "little") + header + raw)
    np.testing.assert_array_equal(timp.read_safetensors(tmp_path / "x.safetensors")["w"], vals)


def test_import_logits_match_transformers(hf_whisper):
    model_t, d = hf_whisper
    mel = np.random.RandomState(0).randn(1, 80, 300).astype(np.float32) * 0.5
    toks = np.array([[3, 17, 44, 160]], np.int64)
    with torch.no_grad():
        want = model_t(input_features=torch.tensor(mel),
                       decoder_input_ids=torch.tensor(toks)).logits.numpy()
        got = _port(d)(torch.tensor(mel), torch.tensor(toks)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < LOGIT_BAR


@pytest.mark.parametrize("suppress", [False, True])
def test_greedy_tokens_match_transformers_generate(hf_whisper, suppress):
    from transformers.generation import GenerationConfig

    model_t, d = hf_whisper
    model = _port(d)
    mel = np.random.RandomState(1).randn(2, 80, 300).astype(np.float32) * 0.5
    max_new = 12
    sup, bsup = (), ()
    if suppress:  # suppress what plain greedy emits, so the masks must act
        g0, _ = greedy_generate(model, torch.tensor(mel), max_new + 1, (1,), 2)
        first, later = int(g0[0, 0]), int(g0[0, 1])
        sup, bsup = (later,), ((first,) if first != later else ())
    gen_cfg = GenerationConfig(max_new_tokens=max_new, do_sample=False, num_beams=1,
                               suppress_tokens=list(sup), begin_suppress_tokens=list(bsup),
                               decoder_start_token_id=1)
    with torch.no_grad():
        ref_ids = model_t.generate(input_features=torch.tensor(mel),
                                   generation_config=gen_cfg).numpy()
    gen, lengths = greedy_generate(model, torch.tensor(mel), max_new + 1, (1,), 2,
                                   suppress_ids=sup, begin_suppress_ids=bsup)
    for b in range(2):
        ours = [int(t) for t in gen[b, :int(lengths[b])]]
        ref = [int(t) for t in ref_ids[b][1:] if t != 2][:max_new]
        # HF's max_new_tokens accounting can differ by one at the horizon
        n = min(len(ours), len(ref))
        assert n >= max_new - 2, (b, ours, ref)
        assert ours[:n] == ref[:n], (b, ours, ref)
        if suppress:
            assert not set(ours) & set(sup)


def test_import_hf_checkpoint_builds_a_loadable_bundle(hf_whisper, tmp_path):
    model_t, d = hf_whisper
    from test_torch_whisper import _tiny_bpe_files

    src = tmp_path / "src"
    src.mkdir()
    for f in d.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    _tiny_bpe_files(src)
    (src / "generation_config.json").write_text(json.dumps(
        {"suppress_tokens": [5, 6], "begin_suppress_tokens": [7], "alignment_heads": [[1, 2]]}))
    bundle = timp.import_hf_checkpoint(src, tmp_path / "bundle", device="cpu")
    w = bundle.config.whisper
    assert (bundle.config.model_family, w.d_model, w.num_heads, w.vocab_size) == \
        ("whisper", 64, 4, 200)
    # config.yaml keeps the pairs as lists, in both packages
    assert (w.suppress_ids, w.begin_suppress_ids) == ((5, 6), (7,))
    assert [tuple(p) for p in w.alignment_heads] == [(1, 2)]
    for name in ("merges.txt", "vocab.json", "config.yaml", "params.npz"):
        assert (tmp_path / "bundle" / name).exists(), name
    assert type(bundle.tokenizer).__name__ == "ByteLevelBPE"
    loaded = api.load(str(tmp_path / "bundle"), device="cpu")
    sd = _port(d).state_dict()
    for k, v in loaded.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    loaded.config.frontend.chunk_seconds = 3.0  # 300 frames: this model's 150 positions
    loaded.config.whisper.prompt_ids, loaded.config.whisper.eot_id = (1,), 2  # V = 200
    texts = api.transcribe(loaded, [np.zeros(8000, np.float32)])
    assert len(texts) == 1 and isinstance(texts[0], str)
    assert timp.load_hf_generation_constraints(tmp_path) == {
        "suppress_ids": (), "begin_suppress_ids": (), "alignment_heads": ()}
