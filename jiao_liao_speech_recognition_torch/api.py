"""Public API of the PyTorch port: ``load`` / ``featurize`` / ``transcribe``
/ ``fine_tune`` / ``stream`` (the JAX package's ``api.py`` for the CTC,
Whisper and joint CTC/attention families)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np
import torch

from .utils.config import ExperimentConfig, FrontendConfig


def load(
    checkpoint: Optional[str] = None,
    config: Optional[Union[str, ExperimentConfig]] = None,
    device="cuda",
):
    """Model bundle (config + model + tokenizer) on `device` for the ctc,
    whisper or joint family (``config.model_family``): random init from seed 0
    without a checkpoint, else a directory with params.npz
    (models/convert.py layout), config.yaml and the tokenizer files
    (vocab.json; merges.txt too for a Whisper BPE tokenizer, as
    models/whisper_import.import_hf_checkpoint writes them)."""
    from .models.bundle import ModelBundle

    return ModelBundle.load(checkpoint=checkpoint, config=config, device=device)


def featurize(
    wav: Union[str, np.ndarray, Sequence[np.ndarray]],
    cfg: Optional[FrontendConfig] = None,
    sample_rate: Optional[int] = None,
    device="cuda",
) -> torch.Tensor:
    """Audio (path, PCM array, or list thereof) -> log-mel features
    [B, num_mels, frames] on `device` (K1 on a card). Audio at another rate
    than cfg.sample_rate (a file's header, or `sample_rate` for arrays) is
    resampled on `device` first."""
    from .frontend import audio_io, features
    from .frontend.resample import resample

    cfg = cfg or FrontendConfig()
    if isinstance(wav, str) or hasattr(wav, "__fspath__"):
        wav, sample_rate = audio_io.read_audio(wav)
    if isinstance(wav, np.ndarray) and wav.ndim == 1:
        wavs = [wav]
    else:
        wavs = [np.asarray(w, dtype=np.float32) for w in wav]
    if sample_rate is not None and sample_rate != cfg.sample_rate:
        wavs = [resample(torch.from_numpy(np.asarray(w, np.float32)).to(device), sample_rate,
                         cfg.sample_rate).cpu().numpy() for w in wavs]
    batch = np.stack([features.pad_or_trim(w, cfg) for w in wavs])
    return features.featurize_batch(torch.from_numpy(batch).to(device), cfg)


def transcribe(
    bundle,
    audio,
    sample_rate: Optional[int] = None,
    decode_cfg=None,
    timestamps: bool = False,
    graph: bool = True,
):
    """Audio -> one transcript per input, by ``decode_cfg.strategy`` (the
    bundle's config when None). CTC: greedy; ``beam``, the C++ prefix beam
    engine over the device's top-k posteriors (``beam_topk``,
    ``beam_prune_logp``), or with ``lm_path`` and ``lm_weight`` > 0 the
    host searcher with the n-gram LM fused; ``beam_device``, the
    fixed-width beam on the device. Whisper greedy or beam; joint
    ctc_greedy, greedy, beam with CTC rescoring or spec_greedy. With
    ``timestamps=True``, one ``[{"token", "start", "end"}, ...]`` list per
    input instead (the CTC frame alignment of the ctc and joint families,
    or Whisper cross-attention DTW). On a card the decode loops replay a
    CUDA graph; ``graph=False`` steps them eagerly."""
    if timestamps:
        return bundle.transcribe_timed(audio, sample_rate=sample_rate, graph=graph)
    return bundle.transcribe(audio, sample_rate=sample_rate, decode_cfg=decode_cfg, graph=graph)


def stream(bundle, chunks: Iterable[np.ndarray], stream_cfg=None):
    """Incremental transcription of a live audio stream (the CTC family, or
    the joint family's CTC branch): yields
    a StreamingResult after every fed chunk (``res.text`` the committed
    text, ``res.preview`` the unstable tail) and a final one
    (``is_final=True``) once `chunks` is exhausted (serve/streaming.py).
    On a split bundle every rank of the model group iterates the same
    chunks (each window step holds the group's all-reduces)."""
    from .serve.streaming import StreamingTranscriber

    st = StreamingTranscriber(bundle, stream_cfg)
    for chunk in chunks:
        yield st.feed(chunk)
    yield st.finish()


def fine_tune(config: Union[str, ExperimentConfig], resume: bool = False, device="cuda",
              max_steps: Optional[int] = None, graph: bool = True):
    """Run the (adapter) fine-tuning loop that `config` describes (the ctc
    family, the joint CTC/attention family on its hybrid loss, or Whisper on
    its teacher-forced CE, e.g. configs/whisper_large_v3_adapters.yaml with
    ``data.tokenizer_dir`` naming HF BPE files) on
    `device` -> (TrainState, ModelBundle); ``max_steps`` stops this call
    early (with a checkpoint) without changing the schedule. The final
    bundle is also saved to ``<train.checkpoint_dir>/final``, which ``load``
    reads back. Under a process group (``parallel.multihost.initialize``)
    the run trains on ``config.mesh``'s mesh and the primary saves. On one
    card each bucket's train step is captured as a CUDA graph and replayed;
    ``graph=False`` runs the same step eagerly."""
    from .train.engine import run_experiment
    from .utils.config import load_yaml

    if isinstance(config, str):
        config = load_yaml(config)
    return run_experiment(config, resume=resume, device=device, max_steps=max_steps, graph=graph)
