"""The port's HF export of a Whisper bundle against the JAX package's
``flax_to_hf_state_dict`` / ``export_hf_checkpoint``: a tiny Whisper
carried across from JAX params exports the same state dict key for key
and bit for bit, the same config.json and generation_config.json; the
exported directory loads in ``transformers`` with logits within 2e-4 of
the port's; ``import-whisper`` of the export is the bundle bit for bit;
adapters are left out and an int8 bundle is refused."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.models import whisper_import as jimp  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import cli  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models import whisper_import as timp  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

LOGIT_BAR = 2e-4  # f32 on both sides, sums reordered (the import test's bar)
SMALL = dict(vocab_size=120, d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4,
             mlp_dim=128, max_source_positions=150, max_target_positions=24, dtype="float32",
             use_flash_attention=False, prompt_ids=(100, 101), eot_id=102,
             suppress_ids=(5, 6), begin_suppress_ids=(7,), alignment_heads=((1, 2), (0, 3)))


@pytest.fixture(scope="module")
def carried():
    """JAX params of a tiny Whisper, the JAX bundle, and the port's bundle
    carrying the same weights."""
    jw = jcfg.WhisperConfig(**SMALL)
    params = JWhisper(jw).init(jax.random.PRNGKey(3), jnp.zeros((1, 80, 300)),
                               jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jb = JBundle(config=jcfg.ExperimentConfig(model_family="whisper", whisper=jw), params=params,
                 tokenizer=None)
    tw = tcfg.WhisperConfig(**SMALL)
    model = WhisperModel(tw)
    model.load_state_dict(convert.whisper_params_to_state_dict(params))
    tb = ModelBundle(tcfg.ExperimentConfig(model_family="whisper", whisper=tw), model.eval(), None)
    return params, jb, tb


def test_state_dict_equals_jax_key_for_key(carried):
    params, _, tb = carried
    want = jimp.flax_to_hf_state_dict(params, jcfg.WhisperConfig(**SMALL))
    got = timp.port_to_hf_state_dict(tb.model.state_dict(), tb.config.whisper)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_export_writes_the_jax_packages_files(carried, tmp_path):
    _, jb, tb = carried
    jimp.export_hf_checkpoint(jb, tmp_path / "jax")
    timp.export_hf_checkpoint(tb, tmp_path / "torch")
    for name in ("config.json", "generation_config.json"):
        assert json.loads((tmp_path / "torch" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text()), name
    got = timp.read_safetensors(tmp_path / "torch" / "model.safetensors")
    want = jimp.read_safetensors(tmp_path / "jax" / "model.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the writer is the JAX package's, byte for byte, on the same tensors
    timp.write_safetensors(tmp_path / "t.safetensors", want)
    jimp.write_safetensors(tmp_path / "j.safetensors", want)
    assert (tmp_path / "t.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()


@pytest.fixture(scope="module")
def exported(carried, tmp_path_factory):
    _, _, tb = carried
    d = tmp_path_factory.mktemp("export")
    bundle_dir, hf_dir = d / "bundle", d / "hf"
    tb.save(str(bundle_dir))
    argv = ["export-whisper", "--checkpoint", str(bundle_dir), "--out", str(hf_dir),
            "--device", "cpu"]
    assert cli.main(argv) == 0
    return tb, hf_dir, d


def test_transformers_reads_the_export_with_the_ports_logits(exported):
    from transformers import WhisperForConditionalGeneration

    tb, hf_dir, _ = exported
    hf = WhisperForConditionalGeneration.from_pretrained(hf_dir).eval()
    mel = np.random.RandomState(0).randn(2, 80, 300).astype(np.float32) * 0.5
    toks = np.array([[100, 101, 17, 44], [100, 101, 3, 90]], np.int64)
    with torch.no_grad():
        want = hf(input_features=torch.tensor(mel), decoder_input_ids=torch.tensor(toks)).logits
        got = tb.model(torch.tensor(mel), torch.tensor(toks))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < LOGIT_BAR
    assert hf.generation_config.suppress_tokens == [5, 6]
    assert hf.config.decoder_start_token_id == 100 and hf.config.eos_token_id == 102


def test_import_of_the_export_is_the_bundle_bitwise(exported):
    tb, hf_dir, d = exported
    assert cli.main(["import-whisper", str(hf_dir), "--out", str(d / "back"),
                     "--device", "cpu"]) == 0
    back = ModelBundle.load(str(d / "back"), device="cpu")
    want = tb.model.state_dict()
    got = back.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    w, b = tb.config.whisper, back.config.whisper
    for f in ("vocab_size", "d_model", "encoder_layers", "decoder_layers", "num_heads", "mlp_dim",
              "max_source_positions", "max_target_positions", "suppress_ids",
              "begin_suppress_ids"):
        assert getattr(b, f) == getattr(w, f), f
    assert [tuple(p) for p in b.alignment_heads] == [tuple(p) for p in w.alignment_heads]


def test_export_leaves_adapters_out_and_refuses_int8(carried, tmp_path):
    _, _, tb = carried
    wa = dataclasses.replace(tb.config.whisper, adapter=tcfg.AdapterConfig(kind="wf", wf_rank=4))
    adapted = WhisperModel(wa)
    missing, _ = adapted.load_state_dict(tb.model.state_dict(), strict=False)
    assert missing and all("adapter" in k for k in missing)
    sd = timp.port_to_hf_state_dict(adapted.state_dict(), wa)
    assert sorted(sd) == sorted(timp.port_to_hf_state_dict(tb.model.state_dict(), wa))
    assert not any("adapter" in k for k in sd)
    with pytest.raises(KeyError, match="int8"):
        timp.export_hf_checkpoint(tb.quantize(), tmp_path / "q")


def test_export_whisper_refuses_another_family(tmp_path, capsys):
    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer

    cfg = tcfg.ExperimentConfig(ctc_model=tcfg.CTCModelConfig(
        d_model=64, num_layers=1, num_heads=2, mlp_dim=128, conv_channels=32, vocab_size=12))
    bundle = api.load(config=cfg, device="cpu")
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(10)])
    bundle.save(str(tmp_path / "ctc"))
    rc = cli.main(["export-whisper", "--checkpoint", str(tmp_path / "ctc"), "--out",
                   str(tmp_path / "o"), "--device", "cpu"])
    assert rc == 1 and "whisper-family" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
