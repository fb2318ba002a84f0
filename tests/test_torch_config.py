"""The port's config dataclasses are field-for-field twins of the JAX
package's (names, order and defaults), and a JAX-written config.yaml
loads into them."""

import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")

from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# ExperimentConfig sections the ported slices do not read; their twins come
# with the slices that use them (none left since the mesh section's)
LATER_SECTIONS = set()


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            v = f.default_factory()
            out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize(
    "name", ["FrontendConfig", "AdapterConfig", "CTCModelConfig", "DecodeConfig",
             "SpecAugmentConfig", "AugmentConfig", "DataConfig", "OptimizerConfig", "TrainConfig",
             "WhisperConfig", "JointModelConfig", "MeshConfig", "DialectStage"]
)
def test_config_twin_matches_jax_dataclass(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert _defaults(tc) == _defaults(jc)


def test_experiment_config_twin_holds_the_slice_sections():
    j = {f.name: f for f in dataclasses.fields(jcfg.ExperimentConfig)}
    t = {f.name: f for f in dataclasses.fields(tcfg.ExperimentConfig)}
    assert set(j) - set(t) == LATER_SECTIONS
    assert set(t) <= set(j)
    jd, td = _defaults(jcfg.ExperimentConfig), _defaults(tcfg.ExperimentConfig)
    assert {k: jd[k] for k in t} == td
    assert tcfg.FrontendConfig().num_frames == jcfg.FrontendConfig().num_frames == 3000


def test_jax_written_yaml_loads_into_the_twin(tmp_path):
    cfg = jcfg.ExperimentConfig(
        frontend=jcfg.FrontendConfig(chunk_seconds=2.0, cmvn="utterance"),
        ctc_model=jcfg.CTCModelConfig(d_model=128, num_heads=2, vocab_size=99),
        decode=jcfg.DecodeConfig(ctc_blank_id=0),
    )
    jcfg.save_yaml(cfg, str(tmp_path / "config.yaml"))
    got = tcfg.load_yaml(str(tmp_path / "config.yaml"))
    assert dataclasses.asdict(got.frontend) == dataclasses.asdict(cfg.frontend)
    assert dataclasses.asdict(got.ctc_model) == dataclasses.asdict(cfg.ctc_model)
    assert dataclasses.asdict(got.decode) == dataclasses.asdict(cfg.decode)
    assert got.model_family == "ctc"


def test_jax_written_whisper_yaml_loads_into_the_twin(tmp_path):
    yaml_path = Path(__file__).resolve().parents[1] / "configs" / "whisper_large_v3_adapters.yaml"
    cfg = jcfg.load_yaml(str(yaml_path))
    jcfg.save_yaml(cfg, str(tmp_path / "config.yaml"))
    got = tcfg.load_yaml(str(tmp_path / "config.yaml"))
    assert got.model_family == "whisper"
    assert dataclasses.asdict(got.whisper) == dataclasses.asdict(cfg.whisper)
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(cfg.mesh)
    assert got.mesh.fsdp_axis == 4 and got.mesh.axis_names == ("data", "fsdp", "model")
    large = dataclasses.asdict(tcfg.whisper_preset("large-v3"))
    assert {k: large[k] for k in ("d_model", "encoder_layers", "decoder_layers", "num_heads",
                                  "mlp_dim", "num_mels", "vocab_size")} == \
        {"d_model": 1280, "encoder_layers": 32, "decoder_layers": 32, "num_heads": 20,
         "mlp_dim": 5120, "num_mels": 128, "vocab_size": 51866}


def test_jax_written_joint_yaml_loads_into_the_twin(tmp_path):
    yaml_path = Path(__file__).resolve().parents[1] / "configs" / "joint_ctc_attention.yaml"
    cfg = jcfg.load_yaml(str(yaml_path))
    jcfg.save_yaml(cfg, str(tmp_path / "config.yaml"))
    for path in (yaml_path, tmp_path / "config.yaml"):
        got = tcfg.load_yaml(str(path))
        assert got.model_family == "joint"
        assert dataclasses.asdict(got.joint) == dataclasses.asdict(cfg.joint)
        assert dataclasses.asdict(got.decode) == dataclasses.asdict(cfg.decode)
    assert cfg.joint.adapter.kind == "wf" and cfg.joint.adapter.wf_rank == 8
    over = tcfg.apply_overrides(got, ["joint.ctc_weight=0.5", "joint.adapter.wf_rank=4"])
    assert over.joint.ctc_weight == 0.5 and over.joint.adapter.wf_rank == 4
