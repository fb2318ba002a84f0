"""ModelBundle: config + model + tokenizer, the object behind ``api.load()``
(the ctc branch of the JAX package's ``models/bundle.py``).

Greedy transcription: 30 s chunks on the host -> log-mel (K1) -> encoder
(K2, K3 per block; K7 for a WF-adapted model; K6 in an Att adapter) ->
head + argmax (K4) -> collapse on the device -> text. ``save`` writes the
directory ``load`` reads: params.npz (``p_a/b/c``), config.yaml, vocab.json.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.tokenizer import CharTokenizer
from ..decode.ctc import ctc_collapse_with_times, ctc_greedy_collapse, ids_to_texts
from ..frontend import audio_io, features
from ..utils.config import DecodeConfig, ExperimentConfig, load_yaml, save_yaml
from .convert import params_to_state_dict, read_npz_params, state_dict_to_params, write_npz_params
from .ctc_model import CTCEncoderModel

PARAMS_FILE = "params.npz"  # flat p_a/b/c layout (models/convert.py)


@dataclass
class ModelBundle:
    config: ExperimentConfig
    model: CTCEncoderModel
    tokenizer: CharTokenizer

    @property
    def device(self) -> torch.device:
        return self.model.ctc_head.kernel.device

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        checkpoint: Optional[str] = None,
        config: Optional[Union[str, ExperimentConfig]] = None,
        device="cuda",
    ) -> "ModelBundle":
        """Random init (seed 0), or a checkpoint: a directory holding
        params.npz (+ config.yaml, vocab.json when present) or an .npz file
        with an explicit config. Without a vocab.json the tokenizer knows
        only blank and unk."""
        if isinstance(config, str):
            config = load_yaml(config)
        ckpt = Path(checkpoint) if checkpoint is not None else None
        if ckpt is not None and ckpt.is_dir() and (ckpt / "config.yaml").exists():
            config = load_yaml(str(ckpt / "config.yaml"))
        if config is None:
            if ckpt is not None:
                raise ValueError("checkpoint without config.yaml needs an explicit config")
            config = ExperimentConfig()
        if config.model_family != "ctc":
            raise NotImplementedError(
                f"model family {config.model_family!r}: the port has the ctc family; "
                "whisper and joint come with later slices"
            )
        model = CTCEncoderModel(config.ctc_model, device="cpu")
        tokenizer = CharTokenizer([])
        if ckpt is not None:
            npz = ckpt / PARAMS_FILE if ckpt.is_dir() else ckpt
            model.load_state_dict(params_to_state_dict(read_npz_params(npz)))
            if ckpt.is_dir() and (ckpt / "vocab.json").exists():
                tokenizer = CharTokenizer.load(ckpt / "vocab.json")
        model.to(device).eval()
        return cls(config, model, tokenizer)

    def save(self, path: str) -> None:
        """Write params.npz, config.yaml and vocab.json into `path`."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        save_yaml(self.config, str(p / "config.yaml"))
        self.tokenizer.save(p / "vocab.json")
        write_npz_params(state_dict_to_params(self.model.state_dict()), p / PARAMS_FILE)

    # ------------------------------------------------------------- inference
    def transcribe(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
        decode_cfg: Optional[DecodeConfig] = None,
    ) -> List[str]:
        """Audio -> text (greedy). Recordings longer than chunk_seconds are
        split into consecutive chunks, decoded in one batch and re-joined."""
        decode_cfg = decode_cfg or self.config.decode
        if decode_cfg.strategy not in ("greedy", "ctc_greedy"):
            raise NotImplementedError(
                f"decode strategy {decode_cfg.strategy!r}: beam search comes with "
                "the beam-search slice"
            )
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        ids, lens = self._frame_ids(wavs, alens)
        ids, lens = ctc_greedy_collapse(ids, lens, decode_cfg.ctc_blank_id)
        texts = ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(), self.tokenizer)
        return ["".join(texts[i] for i in group) for group in owners]

    def transcribe_timed(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
    ) -> List[List[dict]]:
        """Greedy transcription with per-token times: per utterance a list
        of {"token", "start", "end"} (seconds) whose tokens concatenate to
        transcribe()'s text. Chunk k's times are offset by k * chunk_seconds."""
        fe = self.config.frontend
        frame_s = fe.hop_length * self.config.ctc_model.subsample_factor / fe.sample_rate
        blank = self.config.decode.ctc_blank_id
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        ids, lens = self._frame_ids(wavs, alens)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        out: List[List[dict]] = []
        for group in owners:
            utt: List[dict] = []
            for j, piece in enumerate(group):
                off = j * fe.chunk_seconds
                for tid, t0, t1 in ctc_collapse_with_times(ids[piece], int(lens[piece]), blank):
                    utt.append({
                        "token": self.tokenizer.decode([tid]),
                        "start": round(off + t0 * frame_s, 3),
                        "end": round(off + t1 * frame_s, 3),
                    })
            out.append(utt)
        return out

    @torch.inference_mode()
    def _frame_ids(self, wavs: np.ndarray, alens: np.ndarray):
        """Padded chunks [N, samples] -> per-frame argmax ids [N, T'] and
        valid encoder frames [N], on the model's device."""
        fe = self.config.frontend
        wav = torch.from_numpy(wavs).to(self.device)
        feats = features.featurize_batch(wav, fe)
        flens = torch.from_numpy(alens // fe.hop_length).to(self.device)
        return self.model(feats, flens, head_mode="argmax_ids")

    def _prepare_audio_chunked(self, audio, sample_rate):
        """-> (chunks [N, chunk_samples] f32, valid samples [N] i32,
        owners: per input, the indices of its chunks)."""
        fe = self.config.frontend
        chunk = int(fe.chunk_seconds * fe.sample_rate)
        pieces: List[np.ndarray] = []
        owners: List[List[int]] = []
        for a in self._collect_audio(audio, sample_rate):
            group = []
            for s in range(0, max(len(a), 1), chunk):
                group.append(len(pieces))
                pieces.append(a[s : s + chunk])
            owners.append(group)
        batch = np.stack([features.pad_or_trim(p, fe) for p in pieces])
        lens = np.asarray([min(len(p), chunk) for p in pieces], np.int32)
        return batch, lens, owners

    def _collect_audio(self, audio, sample_rate) -> List[np.ndarray]:
        """Inputs (path, 1-D array, 2-D array or list of either) -> list of
        mono float32 arrays at fe.sample_rate; other rates raise."""
        fe = self.config.frontend

        def one(a):
            if isinstance(a, (str, Path)):
                pcm, sr = audio_io.read_wav(a)
            else:
                pcm, sr = np.asarray(a, np.float32), (sample_rate or fe.sample_rate)
            if sr != fe.sample_rate:
                raise NotImplementedError(
                    f"{sr} Hz audio: resampling to {fe.sample_rate} Hz comes with the "
                    "auxiliary-modules slice (frontend/resample.py)"
                )
            return np.asarray(pcm, np.float32)

        if isinstance(audio, (str, Path)) or (isinstance(audio, np.ndarray) and audio.ndim == 1):
            return [one(audio)]
        return [one(a) for a in audio]
