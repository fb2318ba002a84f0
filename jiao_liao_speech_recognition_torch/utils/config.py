"""Config dataclasses for the PyTorch port: twins of the JAX package's.

The port must import nothing of the JAX package (its modules pull in jax
through their package ``__init__``), so the sections the greedy CTC slice
reads are restated here with the same field names and defaults:
``FrontendConfig``, ``AdapterConfig``, ``CTCModelConfig``, ``DecodeConfig``.
``ExperimentConfig`` holds only those sections plus ``model_family``; the
sections of later slices (specaugment, augment, whisper, joint, mesh, data,
train, stages) are ignored when a JAX-written ``config.yaml`` is read.
``tests/test_torch_config.py`` pins every twin field, name and default, to
``jiao_liao_speech_recognition_tpu.utils.config``.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


@dataclass
class FrontendConfig:
    """Log-mel frontend, Whisper-compatible defaults (n_fft=400, hop=160,
    16 kHz, 80 mels)."""

    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    num_mels: int = 80
    chunk_seconds: float = 30.0
    mel_scale: str = "slaney"
    preemphasis: float = 0.0
    log_floor: float = 1e-10
    whisper_norm: bool = True  # clamp to max-8 then (x+4)/4
    cmvn: str = "none"  # none | utterance | global
    cmvn_stats_path: str = ""
    use_pallas: bool = True  # JAX-side switch; the port takes kernels=False instead

    @property
    def num_frames(self) -> int:
        return int(self.chunk_seconds * self.sample_rate) // self.hop_length


@dataclass
class AdapterConfig:
    kind: str = "none"  # none | bottleneck | wf | att (only "none" is ported)
    bottleneck_dim: int = 64
    wf_rank: int = 8
    att_num_heads: int = 4
    att_key_dim: int = 64
    scale: float = 1.0
    dropout: float = 0.1
    after_attention: bool = True
    after_mlp: bool = True


@dataclass
class CTCModelConfig:
    """Conv-subsampled transformer encoder + CTC head (the flagship)."""

    name: str = "ctc_base"
    vocab_size: int = 4336
    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 4
    mlp_dim: int = 2048
    conv_channels: int = 512
    subsample_factor: int = 4
    dropout: float = 0.1
    num_mels: int = 80
    max_frames: int = 3000
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    flash_train_min_q: int = 512
    remat: bool = False
    gelu_form: str = "tanh"  # MLP GELU; the conv subsampler always uses erf
    attention_left_context: int = -1
    attention_right_context: int = -1
    position_mode: str = "sinusoidal"
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class DecodeConfig:
    strategy: str = "greedy"
    beam_size: int = 8
    beam_topk: int = 16
    beam_prune_logp: float = 0.0
    ctc_blank_id: int = 0
    max_decode_len: int = 224
    length_penalty: float = 1.0
    temperature: float = 0.0
    lm_path: str = ""
    lm_weight: float = 0.0


@dataclass
class ExperimentConfig:
    model_family: str = "ctc"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    ctc_model: CTCModelConfig = field(default_factory=CTCModelConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a dataclass from a nested dict; keys the twin lacks are ignored."""
    hints = typing.get_type_hints(cls)
    kwargs: Dict[str, Any] = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ft = hints.get(f.name)
        if is_dataclass(ft) and isinstance(v, dict):
            kwargs[f.name] = from_dict(ft, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def load_yaml(path: str, cls: Type[T] = ExperimentConfig) -> T:
    """Read a ``config.yaml`` written by either package (needs PyYAML)."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    return from_dict(cls, data)
