"""ModelBundle: config + model + tokenizer, the object behind ``api.load()``
(the JAX package's ``models/bundle.py``: the ctc, whisper and joint
families).

CTC greedy transcription: 30 s chunks on the host -> log-mel (K1) -> encoder
(K2, K3 per block; K7 for a WF-adapted model; K6 in an Att adapter) ->
head + argmax (K4) -> collapse on the device -> text. CTC beam (``beam`` /
``beam_device``): the same encoder -> head + log_softmax -> a prefix beam
search of decode/ctc.py (``_ctc_beam_ids``).

Whisper greedy transcription: 30 s chunks -> log-mel (K1) -> encoder (K5,
K6, the out-projection + residual kernel, K3 per block at d=1280) -> cross K/V cached
once -> AR decode (K9 twice per block per step) -> tied bf16 logits ->
argmax -> text (byte-level BPE from merges.txt when the checkpoint has it).
``quantize()`` gives the int8 serving bundle: the same encoder, a decoder
of int8 Dense layers (K10, 8 a block a step), int8 cross caches (K9's int8
half), int8 self caches at batch >= 16, and int8 tied logits (K11, f32).
Whisper's beam (``decode.beam_size`` > 1) adds the bigram LM's shallow
fusion when ``decode.lm_path`` names one with ``lm_weight`` > 0.

Joint CTC/attention transcription: 30 s chunks -> log-mel (K1) -> encoder
(K7 a block with the config's WF inserts, else K2 and K3) -> by
``decode.strategy``: ``ctc_greedy`` the CTC head's ids (K4) collapsed;
``greedy`` the attention decoder's AR loop (K9 twice a block a step);
``beam`` / ``beam_device`` the AR beam with CTC rescoring
(decode/joint_generate.py); ``spec_greedy`` the CTC draft verified by
teacher-forced passes (decode/speculative.py; K7-mlp at 64 positions).
Timestamps take the CTC frame alignment.

``save`` writes the directory ``load`` reads: params.npz (``p_a/b/c``),
config.yaml, vocab.json.

Several cards (``shard``, or ``load`` of a config whose mesh asks for fsdp
or model > 1 under a process group): the model is split over the mesh's
model axis (parallel/tp.py) and ``transcribe`` takes its (data, fsdp)
rank's share of the batch's chunks, the same share on every rank of a
model group, and returns every chunk's text on every rank. Every path runs
split: CTC greedy and the CTC prefix beams (the head is whole on every
rank, so a model group's ranks search the same log-probs), Whisper's
greedy, ``quantize()`` (before or after the split), AR beam, timestamps
and serving engine, the joint family's strategies, and streaming
(serve/streaming.py).
"""

from __future__ import annotations

import copy
import json
import warnings
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.tokenizer import CharTokenizer
from ..data.unigram import UnigramTokenizer
from ..decode.ctc import ctc_collapse_with_times, ctc_greedy_collapse, ids_to_texts
from ..frontend import audio_io, features
from ..frontend.resample import resample
from ..parallel import multihost as mh
from ..parallel.tp import apply_tp, model_tp, role_dims
from ..utils.config import STRATEGIES, DecodeConfig, ExperimentConfig, load_yaml, save_yaml
from .convert import (
    joint_params_to_state_dict,
    joint_state_dict_to_params,
    params_to_state_dict,
    read_npz_params,
    state_dict_to_params,
    whisper_params_to_state_dict,
    whisper_state_dict_to_params,
    write_npz_params,
)
from .ctc_model import CTCEncoderModel
from .joint import JointCTCAttentionModel
from .layers import cast_for_serving, quantized_copy
from .whisper import WhisperModel

PARAMS_FILE = "params.npz"  # flat p_a/b/c layout (models/convert.py)


def _load_vocab(path: Path):
    """A checkpoint's vocab.json: a char vocab, or a unigram one
    (``"type": "unigram"``, data/unigram.py)."""
    obj = json.loads(path.read_text(encoding="utf-8"))
    if obj.get("type") == "unigram":
        return UnigramTokenizer(obj["pieces"], obj["logprobs"])
    return CharTokenizer(obj["vocab"])


def load_tokenizer(ckpt: Path):
    """A checkpoint directory's tokenizer: ByteLevelBPE when it holds
    merges.txt, else its char or unigram vocab.json, else blank and unk
    only."""
    if ckpt.is_dir() and (ckpt / "merges.txt").exists():
        from ..data.bpe import ByteLevelBPE

        return ByteLevelBPE.from_hf_dir(ckpt)
    if ckpt.is_dir() and (ckpt / "vocab.json").exists():
        return _load_vocab(ckpt / "vocab.json")
    return CharTokenizer([])


@dataclass
class ModelBundle:
    config: ExperimentConfig
    model: Union[CTCEncoderModel, WhisperModel, JointCTCAttentionModel]
    tokenizer: object  # CharTokenizer, UnigramTokenizer, or ByteLevelBPE (Whisper)
    mesh: Any = field(default=None, repr=False)  # the DeviceMesh of ``shard``

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        checkpoint: Optional[str] = None,
        config: Optional[Union[str, ExperimentConfig]] = None,
        device="cuda",
    ) -> "ModelBundle":
        """Random init (seed 0), or a checkpoint: a directory holding
        params.npz (+ config.yaml, merges.txt + vocab.json for a BPE
        tokenizer, or a char vocab.json) or an .npz file with an explicit
        config. Without those files the tokenizer knows only blank and
        unk. A Whisper model is made and initialised on `device`, a CTC or
        joint model on the CPU, then moved. A config whose mesh asks for
        fsdp_axis or model_axis > 1 is sharded (``shard``) when a process
        group tiles its mesh; otherwise it loads unsharded with a warning
        (no process group, as ``train_loop`` warns, or JAX's warning when
        the processes do not tile the mesh)."""
        if isinstance(config, str):
            config = load_yaml(config)
        ckpt = Path(checkpoint) if checkpoint is not None else None
        if ckpt is not None and ckpt.is_dir() and (ckpt / "config.yaml").exists():
            config = load_yaml(str(ckpt / "config.yaml"))
        if config is None:
            if ckpt is not None:
                raise ValueError("checkpoint without config.yaml needs an explicit config")
            config = ExperimentConfig()
        if config.model_family == "whisper":
            if config.frontend.num_mels != config.whisper.num_mels:
                raise ValueError(f"frontend.num_mels {config.frontend.num_mels} != "
                                 f"whisper.num_mels {config.whisper.num_mels}")
            model = WhisperModel(config.whisper, device=device)
            to_state = whisper_params_to_state_dict
        elif config.model_family == "ctc":
            model = CTCEncoderModel(config.ctc_model, device="cpu")
            to_state = params_to_state_dict
        elif config.model_family == "joint":
            if config.frontend.num_mels != config.joint.num_mels:
                raise ValueError(f"frontend.num_mels {config.frontend.num_mels} != "
                                 f"joint.num_mels {config.joint.num_mels}")
            model = JointCTCAttentionModel(config.joint, device="cpu")
            to_state = joint_params_to_state_dict
        else:
            raise ValueError(f"unknown model family {config.model_family!r}")
        tokenizer = CharTokenizer([])
        if ckpt is not None:
            npz = ckpt / PARAMS_FILE if ckpt.is_dir() else ckpt
            model.load_state_dict(to_state(read_npz_params(npz)))
            tokenizer = load_tokenizer(ckpt)
        model.to(device).eval()
        # bf16 copies of every Dense kernel and bias (K2's packed q/k/v and
        # its out-projection, K3's fc1 and fc2) and of K4's head, made once
        if model.cfg.dtype == "bfloat16":
            cast_for_serving(model, torch.bfloat16)
        bundle = cls(config, model, tokenizer)
        m = config.mesh
        if m.fsdp_axis > 1 or m.model_axis > 1:
            if not mh.is_initialized():
                warnings.warn(
                    f"config.mesh asks for fsdp_axis={m.fsdp_axis}, model_axis={m.model_axis}, "
                    "but no process group is up: loading unsharded on one device", stacklevel=2)
            else:
                try:
                    bundle.shard()
                except ValueError as e:
                    warnings.warn(
                        f"config requests mesh fsdp={m.fsdp_axis} model={m.model_axis} but "
                        f"{mh.process_count()} processes don't tile it ({e}); loading unsharded",
                        stacklevel=2)
        return bundle

    # -------------------------------------------------------------- sharding
    def shard(self, mesh=None) -> "ModelBundle":
        """Shard for multi-card INFERENCE: Megatron-style TP over 'model'
        (parallel/tp.py, the rules of parallel/tp_rules.py) on the mesh of
        config.mesh (or `mesh`, a DeviceMesh of the process group's world).
        Subsequent transcribe calls split input batches over the 'data' and
        'fsdp' ranks; each rank of a model group holds its heads and hidden
        columns and the all-reduces are the layers' own. Over 'fsdp' the
        weights stay whole (JAX shards them there too, and XLA gathers each
        layer at use; here a rank holds its model-axis part). The model is
        split in place; returns self. An int8 bundle (``quantize()``)
        splits to the bits of quantizing after the split. Every family
        splits by the same rules (a joint model's encoder and decoder blocks
        as the CTC model's and Whisper's, its tied table by vocab rows, its
        CTC head whole)."""
        from ..parallel import mesh as pmesh

        if mesh is None:
            mesh = pmesh.build_mesh(self.config.mesh)
        apply_tp(self.model, pmesh.tp_group(mesh))
        if self.model.cfg.dtype == "bfloat16":
            cast_for_serving(self.model, torch.bfloat16)
        self.mesh = mesh
        return self

    def _rows(self, n: int) -> Optional[slice]:
        """This rank's chunks of a batch of `n` on the mesh: the (data,
        fsdp) rank's n / ranks of them, or None (all of them: no mesh, or
        a batch the ranks do not divide, JAX's replication fallback)."""
        if self.mesh is None:
            return None
        from ..parallel.mesh import dp_rank

        ranks = self.mesh.size(0) * self.mesh.size(1)
        if ranks == 1 or n % ranks:
            return None
        k = n // ranks
        r = dp_rank(self.mesh)
        return slice(r * k, (r + 1) * k)

    def _gather_texts(self, texts: List[str]) -> List[str]:
        """Every rank's chunk texts (``_rows``) in chunk order on every
        rank: the first rank of each model group speaks for it."""
        parts = [None] * mh.process_count()
        torch.distributed.all_gather_object(parts, texts)
        tp = self.mesh.size(2)
        return [t for r in range(0, len(parts), tp) for t in parts[r]]

    @property
    def is_whisper(self) -> bool:
        return self.config.model_family == "whisper"

    @property
    def is_joint(self) -> bool:
        return self.config.model_family == "joint"

    def save(self, path: str) -> None:
        """Write params.npz, config.yaml and the tokenizer into `path`:
        vocab.json (char or unigram), or a BPE tokenizer's vocab.json and
        merges.txt (``load_tokenizer`` reads either back). A split bundle
        (``shard``) writes the whole weights, joined over the model axis: a
        collective every process calls, after which the primary writes; it
        returns on every process once the files are written."""
        state = self.model.state_dict()
        if getattr(self.model, "tp", None) is None:
            self._write(state, Path(path))
            return
        from ..parallel.mesh import gather_split

        state = gather_split(state, self.model)
        if mh.is_primary():
            self._write(state, Path(path))
        mh.barrier()

    def _write(self, state, p: Path) -> None:
        p.mkdir(parents=True, exist_ok=True)
        save_yaml(self.config, str(p / "config.yaml"))
        if hasattr(self.tokenizer, "save_hf_dir"):
            self.tokenizer.save_hf_dir(p)
        elif hasattr(self.tokenizer, "save"):
            self.tokenizer.save(p / "vocab.json")
        to_params = {"whisper": whisper_state_dict_to_params,
                     "joint": joint_state_dict_to_params}.get(self.config.model_family,
                                                              state_dict_to_params)
        write_npz_params(to_params(state), p / PARAMS_FILE)

    def quantize(self) -> "ModelBundle":
        """Weight-only int8 serving (the JAX package's
        ``ModelBundle.quantize``): a NEW bundle whose decoder's Dense layers
        are int8 per output channel (cross k/v included) and whose tied
        table is int8 per vocab row, made on the bundle's device. The
        encoder is the same module (its tensors shared); this bundle is
        left as it is. Whisper only. A split bundle (``shard``) quantizes
        each rank's part to the bits of the unsplit quantization's part (a
        row layer's scales are its columns' max over the group: a
        collective) and keeps its mesh."""
        if not self.is_whisper:
            raise NotImplementedError(
                "int8 decode serving targets the whisper family; the CTC/joint encoders "
                "are compute-bound, not weight-read-bound")
        model = copy.copy(self.model)
        model._modules = dict(self.model._modules)
        model.decoder = quantized_copy(self.model.decoder)
        if model_tp(model) is not None:  # split: its int8 leaves are split too
            model.tp_dims = role_dims(model)
        return ModelBundle(self.config, model, self.tokenizer, self.mesh)

    # ------------------------------------------------------------- inference
    def transcribe(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
        decode_cfg: Optional[DecodeConfig] = None,
        graph: bool = True,
    ) -> List[str]:
        """Audio -> text by ``decode_cfg.strategy`` (the config's when None).
        Recordings longer than chunk_seconds are split into consecutive
        chunks, decoded in one batch and re-joined. On a card the decode
        loops (greedy, the AR beam, the device CTC beam) replay a CUDA
        graph; graph=False steps them eagerly (a split model whose group
        cannot be captured needs it)."""
        decode_cfg = decode_cfg or self.config.decode
        family = self.config.model_family
        if family == "ctc" and decode_cfg.strategy not in ("greedy", "ctc_greedy", "beam",
                                                           "beam_device"):
            raise ValueError(f"unknown ctc decode strategy {decode_cfg.strategy!r}")
        if self.is_joint and decode_cfg.strategy not in STRATEGIES:
            raise ValueError(f"unknown joint decode strategy {decode_cfg.strategy!r}")
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        rows = self._rows(len(wavs))
        if rows is not None:
            wavs, alens = wavs[rows], alens[rows]
        if self.is_whisper:
            ids, lens = self._whisper_ids(wavs, decode_cfg, graph)
        elif self.is_joint and decode_cfg.strategy != "ctc_greedy":
            ids, lens = self._joint_ids(wavs, alens, decode_cfg, graph)
        elif decode_cfg.strategy in ("beam", "beam_device"):
            ids, lens = self._ctc_beam_ids(wavs, alens, decode_cfg, graph)
        else:
            ids, lens = self._frame_ids(wavs, alens)
            ids, lens = ctc_greedy_collapse(ids, lens, decode_cfg.ctc_blank_id)
        texts = ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(), self.tokenizer)
        if rows is not None:
            texts = self._gather_texts(texts)
        return ["".join(texts[i] for i in group) for group in owners]

    def transcribe_timed(
        self,
        audio: Union[str, np.ndarray, Sequence],
        sample_rate: Optional[int] = None,
        graph: bool = True,
    ) -> List[List[dict]]:
        """Greedy transcription with per-token times: per utterance a list
        of {"token", "start", "end"} (seconds) whose tokens concatenate to
        transcribe()'s text. Chunk k's times are offset by k * chunk_seconds.
        CTC and joint: the frame alignment of the CTC greedy path; Whisper:
        cross-attention DTW over one teacher-forced pass (decode/align.py)."""
        if self.is_whisper:
            return self._transcribe_timed_whisper(audio, sample_rate, graph)
        fe = self.config.frontend
        frame_s = fe.hop_length * self.model.cfg.subsample_factor / fe.sample_rate
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

    def _transcribe_timed_whisper(self, audio, sample_rate, graph: bool) -> List[List[dict]]:
        """Greedy ids of every chunk in one batch (as transcribe), then the
        spans of whisper_token_spans over the same features."""
        from ..decode.align import whisper_token_spans
        from ..decode.whisper_generate import generate, resolve_specials

        fe = self.config.frontend
        wcfg = self.config.whisper
        wavs, alens, owners = self._prepare_audio_chunked(audio, sample_rate)
        with torch.inference_mode():
            feats = features.featurize_batch(torch.from_numpy(wavs).to(self.device), fe)
            ids, lens = generate(self, feats, replace(self.config.decode, strategy="greedy"),
                                 graph=graph)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        prompt, eot = resolve_specials(wcfg)
        # one encoder frame = 2 mel hops (conv2's stride) = 20 ms at 16 kHz
        frame_s = fe.hop_length * 2 / fe.sample_rate
        valid = np.maximum(alens // (fe.hop_length * 2), 1).astype(np.int64)
        spans = whisper_token_spans(self.model, feats, ids, lens, prompt, eot, valid)
        out: List[List[dict]] = []
        for group in owners:
            utt: List[dict] = []
            for j, piece in enumerate(group):
                off = j * fe.chunk_seconds
                n = int(lens[piece])
                for tid, (f0, f1) in zip(ids[piece][:n], spans[piece]):
                    utt.append({
                        "token": self.tokenizer.decode([int(tid)]),
                        "start": round(off + f0 * frame_s, 3),
                        "end": round(off + f1 * frame_s, 3),
                    })
            out.append(utt)
        return out

    @torch.inference_mode()
    def _whisper_ids(self, wavs: np.ndarray, decode_cfg: DecodeConfig, graph: bool = True):
        """Padded chunks [N, samples] -> generated ids [N, L] and lengths [N]
        (decode/whisper_generate.py), on the model's device."""
        from ..decode.whisper_generate import generate

        wav = torch.from_numpy(wavs).to(self.device)
        return generate(self, features.featurize_batch(wav, self.config.frontend), decode_cfg,
                        graph=graph)

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor, feat_lengths: torch.Tensor):
        """Features [B, mels, T] and valid frames [B] -> (CTC log-probs
        [B, T', V] f32, valid encoder frames [B]) on the bundle's device:
        the encoder and CTC head as ``transcribe`` runs them before a beam
        (the JAX bundle's ``encode``). A Whisper bundle has no CTC head:
        its encoder is ``model.encode``."""
        if self.is_whisper:
            raise ValueError("ModelBundle.encode: a Whisper bundle has no CTC log-probs; "
                             "call bundle.model.encode(mel) for its encoder output")
        feats, feat_lengths = feats.to(self.device), feat_lengths.to(self.device)
        if self.is_joint:
            log_probs, lengths, _ = self.model(feats, feat_lengths)
            return log_probs, lengths
        return self.model(feats, feat_lengths, head_mode="log_probs")

    def _features(self, wavs: np.ndarray, alens: np.ndarray):
        """Padded chunks [N, samples] -> (log-mel [N, mels, T], valid mel
        frames [N]) on the model's device."""
        fe = self.config.frontend
        wav = torch.from_numpy(wavs).to(self.device)
        return (features.featurize_batch(wav, fe),
                torch.from_numpy(alens // fe.hop_length).to(self.device))

    @torch.inference_mode()
    def _frame_ids(self, wavs: np.ndarray, alens: np.ndarray):
        """Padded chunks [N, samples] -> per-frame CTC argmax ids [N, T'] and
        valid encoder frames [N], on the model's device (ctc and joint)."""
        return self.model.frame_ids(*self._features(wavs, alens))

    @torch.inference_mode()
    def _joint_ids(self, wavs: np.ndarray, alens: np.ndarray, decode_cfg: DecodeConfig,
                   graph: bool = True):
        """Padded chunks -> the attention branch's ids [N, max_len - 1] and
        lengths [N] by decode_cfg.strategy: greedy, beam / beam_device (CTC
        rescoring at the config's ctc_weight) or spec_greedy."""
        from ..decode.joint_generate import joint_beam, joint_greedy
        from ..decode.speculative import joint_spec_greedy

        feats, flens = self._features(wavs, alens)
        L = decode_cfg.max_decode_len
        if decode_cfg.strategy == "greedy":
            return joint_greedy(self.model, feats, flens, max_len=L, graph=graph)
        if decode_cfg.strategy == "spec_greedy":
            return joint_spec_greedy(self.model, feats, flens, max_len=L, graph=graph)
        return joint_beam(self.model, feats, flens, beam_size=decode_cfg.beam_size, max_len=L,
                          length_penalty=decode_cfg.length_penalty, graph=graph)

    @torch.inference_mode()
    def _ctc_beam_ids(self, wavs: np.ndarray, alens: np.ndarray, decode_cfg: DecodeConfig,
                      graph: bool = True):
        """Padded chunks -> CTC prefix beam ids [N, T'] and lengths [N] (the
        JAX bundle's dispatch) over the log-probs of K1, the blocks (K2, K3)
        and the head with log_softmax: ``beam_device`` the device beam
        (top-k at most 16); ``beam`` with ``lm_path`` and ``lm_weight`` > 0
        the host searcher with the n-gram LM fused; ``beam`` without the C++
        engine over the device's top-k (``beam_topk``, ``beam_prune_logp``).
        The JAX bundle falls back to the host searcher when the engine's
        library is missing; here it is built at first use and a failed
        build raises (the same results either way). On a split model every
        rank of a model group searches its (data, fsdp) rank's rows
        (``transcribe``'s ``_rows``) over the same whole log-probs."""
        from ..decode.ctc import (ctc_prefix_beam_search, ctc_prefix_beam_search_host,
                                  ctc_prefix_beam_search_native)

        dc = decode_cfg
        log_probs, out_lens = self.encode(*self._features(wavs, alens))
        if dc.strategy == "beam_device":
            return ctc_prefix_beam_search(log_probs, out_lens, dc.beam_size, dc.ctc_blank_id,
                                          topk_tokens=min(dc.beam_topk, 16), graph=graph)
        if dc.lm_path and dc.lm_weight > 0.0:
            from ..decode.lm import NGramCharLM

            ids, lens = ctc_prefix_beam_search_host(
                log_probs.cpu().numpy(), out_lens.cpu().numpy(), dc.beam_size, dc.ctc_blank_id,
                topk_tokens=dc.beam_topk, lm=NGramCharLM.load(dc.lm_path),
                lm_weight=dc.lm_weight)
        else:
            ids, lens = ctc_prefix_beam_search_native(
                log_probs, out_lens, dc.beam_size, dc.ctc_blank_id, topk_tokens=dc.beam_topk,
                prune_logp=dc.beam_prune_logp)
        return torch.from_numpy(ids), torch.from_numpy(lens)

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
        mono float32 arrays at fe.sample_rate. Every item keeps its own
        rate (a file its header's, an array `sample_rate`, None meaning
        fe.sample_rate already) and is resampled alone on the bundle's
        device, so mixed-rate lists and mixes of files and arrays work."""
        fe = self.config.frontend

        def one(a):
            if isinstance(a, (str, Path)):
                pcm, sr = audio_io.read_audio(a)
            else:
                pcm, sr = np.asarray(a, np.float32), (sample_rate or fe.sample_rate)
            pcm = np.asarray(pcm, np.float32)
            if sr != fe.sample_rate:
                pcm = resample(torch.from_numpy(pcm).to(self.device), sr,
                               fe.sample_rate).cpu().numpy()
            return pcm

        if isinstance(audio, (str, Path)) or (isinstance(audio, np.ndarray) and audio.ndim == 1):
            return [one(audio)]
        return [one(a) for a in audio]
