"""The port's config dataclasses are field-for-field twins of the JAX
package's (names, order and defaults), and a JAX-written config.yaml
loads into them."""

import dataclasses

import pytest

pytest.importorskip("torch")

from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# ExperimentConfig sections the ported slices do not read; their twins come
# with the slices that use them
LATER_SECTIONS = {"whisper", "joint", "mesh", "stages"}


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
             "SpecAugmentConfig", "AugmentConfig", "DataConfig", "OptimizerConfig", "TrainConfig"]
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
