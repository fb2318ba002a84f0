"""Config dataclasses for the PyTorch port: twins of the JAX package's.

The port must import nothing of the JAX package (its modules pull in jax
through their package ``__init__``), so the sections the ported slices read
are restated here with the same field names and defaults:
``FrontendConfig``, ``SpecAugmentConfig``, ``AugmentConfig``,
``AdapterConfig``, ``CTCModelConfig``, ``DataConfig``, ``OptimizerConfig``,
``TrainConfig``, ``DecodeConfig``, ``WhisperConfig`` (+ ``whisper_preset``),
``JointModelConfig``, ``MeshConfig`` and ``DialectStage``.
``ExperimentConfig`` holds those sections plus ``model_family`` and the
multi-dialect ``stages`` schedule, in the JAX class's order.
``apply_overrides`` takes the CLI's ``key.subkey=value`` overrides.
``tests/test_torch_config.py`` pins every twin field, name and default, to
``jiao_liao_speech_recognition_tpu.utils.config``.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Type, TypeVar

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
class SpecAugmentConfig:
    """Time/frequency masking on the log-mel features."""

    enabled: bool = True
    num_freq_masks: int = 2
    freq_mask_width: int = 27
    num_time_masks: int = 2
    time_mask_fraction: float = 0.05  # max width as a fraction of frames
    replace_with_zero: bool = True  # else the utterance mean


@dataclass
class AugmentConfig:
    """Waveform augmentation (frontend/augment.py), applied in training by
    the ctc and joint losses when enabled."""

    enabled: bool = False
    gain_db: Tuple[float, float] = (-6.0, 6.0)
    noise_snr_db: Tuple[float, float] = (10.0, 40.0)
    pitch_semitones: Tuple[float, float] = (-2.0, 2.0)
    speed_rates: Tuple[float, ...] = (0.9, 1.0, 1.1)
    probability: float = 0.5
    lowpass_hz: Tuple[float, float] = (2000.0, 7500.0)
    lowpass_probability: float = 0.0
    highpass_hz: Tuple[float, float] = (20.0, 400.0)
    highpass_probability: float = 0.0
    bandpass_probability: float = 0.0
    filter_taps: int = 101
    time_stretch_rates: Tuple[float, ...] = ()


@dataclass
class AdapterConfig:
    kind: str = "none"  # none | bottleneck | wf | att
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
    remat: bool = False  # torch.utils.checkpoint per block in training
    gelu_form: str = "tanh"  # MLP GELU; the conv subsampler always uses erf
    attention_left_context: int = -1
    attention_right_context: int = -1
    position_mode: str = "sinusoidal"
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class WhisperConfig:
    """Whisper encoder-decoder. Defaults = whisper-tiny shape; large-v3 via
    ``whisper_preset('large-v3')``."""

    name: str = "whisper_tiny"
    vocab_size: int = 51865
    num_mels: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    num_heads: int = 6
    mlp_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    dropout: float = 0.0
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    flash_train_min_q: int = 512
    remat: bool = False
    # decode specials: prompt_ids=() -> the zh-transcribe prompt
    # (decode/whisper_generate.default_prompt), eot_id<0 -> the standard EOT
    eot_id: int = -1
    prompt_ids: Tuple[int, ...] = ()
    # HF generate() suppression: every step / the first generated step
    suppress_ids: Tuple[int, ...] = ()
    begin_suppress_ids: Tuple[int, ...] = ()
    # (layer, head) pairs for timestamp alignment (read, not used yet)
    alignment_heads: Tuple[Tuple[int, int], ...] = ()
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class JointModelConfig:
    """Joint CTC/attention transformer (SpeechBrain's TransformerASR recipe
    shape): a conv-subsampled encoder with a CTC head and an attention
    decoder, trained on ctc_weight * CTC + (1 - ctc_weight) * CE."""

    name: str = "joint_base"
    vocab_size: int = 4336
    d_model: int = 512
    num_layers: int = 12
    decoder_layers: int = 6
    num_heads: int = 4
    mlp_dim: int = 2048
    conv_channels: int = 512
    subsample_factor: int = 4
    dropout: float = 0.1
    num_mels: int = 80
    max_frames: int = 3000
    max_target_positions: int = 448
    dtype: str = "bfloat16"
    use_flash_attention: bool = True
    flash_train_min_q: int = 512
    remat: bool = False
    gelu_form: str = "tanh"
    attention_left_context: int = -1
    attention_right_context: int = -1
    position_mode: str = "sinusoidal"
    ctc_weight: float = 0.3  # the hybrid weighting, and joint beam's CTC rescoring weight
    adapter: AdapterConfig = field(default_factory=AdapterConfig)


@dataclass
class DataConfig:
    train_manifest: str = ""
    eval_manifest: str = ""
    batch_size: int = 16
    max_audio_seconds: float = 30.0
    min_audio_seconds: float = 0.3
    bucket_boundaries_seconds: Tuple[float, ...] = (5.0, 10.0, 20.0, 30.0)
    max_text_len: int = 128
    shuffle_seed: int = 0
    num_host_workers: int = 4
    tokenizer_dir: str = ""  # HF byte-level BPE files (vocab.json + merges.txt)
    unigram_vocab: str = ""  # a unigram subword vocab (cli train-unigram)
    dialect_weights: Optional[Dict[str, float]] = None  # mixed by dialect tag
    transfer_dtype: str = "float32"  # "float32" | "int16" host->device audio


@dataclass
class OptimizerConfig:
    name: str = "adamw"  # adamw | adam | sgd
    learning_rate: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant | noam
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.98
    grad_clip_norm: float = 1.0
    grad_accum_steps: int = 1


@dataclass
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train_adapters_only: bool = False  # frozen backbone, adapter params only
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3
    log_every_steps: int = 10
    eval_every_steps: int = 1000
    seed: int = 0
    metrics_path: Optional[str] = None
    use_wandb: bool = False  # a wandb sink beside the jsonl (utils/logging.py)
    fast_dropout_rng: bool = True  # a TPU generator switch: ignored here


# DecodeConfig.strategy's values: the joint family takes all five, Whisper
# the first three, the ctc family greedy and ctc_greedy (its beam is not
# ported)
STRATEGIES = ("greedy", "beam", "beam_device", "ctc_greedy", "spec_greedy")


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
class MeshConfig:
    """The training mesh (parallel/mesh.py): ``data`` replicates the model
    over batch shards, ``fsdp`` shards parameters and optimizer state
    (FSDP2), ``model`` is Megatron tensor parallelism (parallel/tp.py).
    Read only when a process group is up (``cli train --multihost``,
    ``ModelBundle.load`` / ``shard``)."""

    data_axis: int = -1  # -1 = all remaining devices
    fsdp_axis: int = 1
    model_axis: int = 1
    axis_names: Tuple[str, str, str] = ("data", "fsdp", "model")
    remat: bool = False  # read by neither package: each model config has its own


@dataclass
class DialectStage:
    """One stage of the multi-dialect transfer schedule (train/schedules.py)."""

    name: str = ""
    manifests: Tuple[str, ...] = ()
    steps: int = 1000
    train_adapters_only: bool = True
    mix_weights: Optional[Tuple[float, ...]] = None  # of several manifests; None: equal


@dataclass
class ExperimentConfig:
    model_family: str = "ctc"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    specaugment: SpecAugmentConfig = field(default_factory=SpecAugmentConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    ctc_model: CTCModelConfig = field(default_factory=CTCModelConfig)
    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    joint: JointModelConfig = field(default_factory=JointModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    stages: Tuple[DialectStage, ...] = ()  # multi-dialect transfer schedule


WHISPER_PRESETS = {
    "tiny": dict(d_model=384, encoder_layers=4, decoder_layers=4, num_heads=6,
                 mlp_dim=1536, num_mels=80, vocab_size=51865),
    "base": dict(d_model=512, encoder_layers=6, decoder_layers=6, num_heads=8,
                 mlp_dim=2048, num_mels=80, vocab_size=51865),
    "small": dict(d_model=768, encoder_layers=12, decoder_layers=12, num_heads=12,
                  mlp_dim=3072, num_mels=80, vocab_size=51865),
    "medium": dict(d_model=1024, encoder_layers=24, decoder_layers=24, num_heads=16,
                   mlp_dim=4096, num_mels=80, vocab_size=51865),
    "large-v2": dict(d_model=1280, encoder_layers=32, decoder_layers=32, num_heads=20,
                     mlp_dim=5120, num_mels=80, vocab_size=51865),
    "large-v3": dict(d_model=1280, encoder_layers=32, decoder_layers=32, num_heads=20,
                     mlp_dim=5120, num_mels=128, vocab_size=51866),
}


def whisper_preset(name: str) -> WhisperConfig:
    """Shapes of the published Whisper family (HF config.json values)."""
    if name not in WHISPER_PRESETS:
        raise KeyError(f"unknown whisper preset {name!r}; have {sorted(WHISPER_PRESETS)}")
    return WhisperConfig(name=f"whisper_{name}", **WHISPER_PRESETS[name])


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
        elif f.name == "stages" and isinstance(v, (list, tuple)):
            kwargs[f.name] = tuple(
                from_dict(DialectStage, s) if isinstance(s, dict) else s for s in v
            )
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def to_dict(cfg: Any) -> Any:
    """Dataclass -> nested dict of plain values (tuples become lists)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def save_yaml(cfg: Any, path: str) -> None:
    """Write a ``config.yaml`` both packages read (needs PyYAML)."""
    import yaml
    from pathlib import Path

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(to_dict(cfg), fh, sort_keys=False, allow_unicode=True)


def load_yaml(path: str, cls: Type[T] = ExperimentConfig) -> T:
    """Read a ``config.yaml`` written by either package (needs PyYAML)."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    return from_dict(cls, data)


def apply_overrides(cfg: T, overrides: Sequence[str]) -> T:
    """Apply ``key.subkey=value`` CLI overrides, values parsed as YAML (and
    a string such as "3e-3", which YAML 1.1 leaves a string, as a number)."""
    import yaml

    data = to_dict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        node = data
        parts = key.strip().lstrip("-").split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        val = yaml.safe_load(raw)
        if isinstance(val, str):
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
        node[parts[-1]] = val
    return from_dict(type(cfg), data)
