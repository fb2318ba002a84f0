"""HF Whisper checkpoints (safetensors) in and out of the port, the JAX
package's ``models/whisper_import.py``.

``read_safetensors`` / ``write_safetensors`` are numpy-only (8-byte
little-endian header length, a JSON index {name: {dtype, shape,
data_offsets}}, raw row-major buffers). ``hf_state_dict_to_port`` maps a
transformers ``WhisperForConditionalGeneration`` state dict onto the
port's ``WhisperModel`` state dict: torch Linear weights [out, in]
transpose to Dense kernels [in, out]; Conv1d weights keep their [out, in,
k] layout. ``import_hf_checkpoint`` writes a bundle directory
``api.load`` reads; ``port_to_hf_state_dict`` / ``export_hf_checkpoint``
go the other way, to a directory ``from_pretrained`` reads.
"""

from __future__ import annotations

import json
import shutil
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}
TOKENIZER_FILES = ("vocab.json", "merges.txt", "added_tokens.json", "tokenizer.json")


def read_safetensors(path: str | Path) -> Dict[str, np.ndarray]:
    """A .safetensors file -> {name: numpy array}; bf16 upcast to f32."""
    raw = Path(path).read_bytes()
    (hlen,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + hlen].decode("utf-8"))
    base = 8 + hlen
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = raw[base + start:base + end]
        if meta["dtype"] == "BF16":
            arr = (np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(buf, dtype=_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def write_safetensors(path: str | Path, tensors: Dict[str, np.ndarray]) -> None:
    """{name: numpy array} -> a .safetensors file (the header padded with
    spaces to a multiple of 8 bytes, as the JAX package writes it)."""
    dtypes = {np.dtype(v): k for k, v in _DTYPES.items()}
    header, bufs, offset = {}, [], 0
    for name, arr in tensors.items():
        b = np.ascontiguousarray(arr).tobytes()
        header[name] = {"dtype": dtypes[np.dtype(arr.dtype)], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(b)]}
        bufs.append(b)
        offset += len(b)
    hjson = json.dumps(header).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(hjson)))
        fh.write(hjson)
        for b in bufs:
            fh.write(b)


def _hf_key_map(cfg) -> Dict[str, str]:
    """port state_dict key -> HF key (without the "model." prefix)."""
    m = {
        "encoder.conv1.weight": "encoder.conv1.weight",
        "encoder.conv1.bias": "encoder.conv1.bias",
        "encoder.conv2.weight": "encoder.conv2.weight",
        "encoder.conv2.bias": "encoder.conv2.bias",
        "encoder.ln_post.scale": "encoder.layer_norm.weight",
        "encoder.ln_post.bias": "encoder.layer_norm.bias",
        "decoder.embed_tokens.embedding": "decoder.embed_tokens.weight",
        "decoder.embed_positions": "decoder.embed_positions.weight",
        "decoder.ln.scale": "decoder.layer_norm.weight",
        "decoder.ln.bias": "decoder.layer_norm.bias",
    }

    def attn(port, hf):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{port}.{p}.kernel"] = f"{hf}.{p}.weight"
            if p != "k_proj":
                m[f"{port}.{p}.bias"] = f"{hf}.{p}.bias"

    def ln(port, hf):
        m[f"{port}.scale"], m[f"{port}.bias"] = f"{hf}.weight", f"{hf}.bias"

    for side, n, cross in (("encoder", cfg.encoder_layers, False),
                           ("decoder", cfg.decoder_layers, True)):
        for i in range(n):
            port, hf = f"{side}.blocks.{i}", f"{side}.layers.{i}"
            attn(f"{port}.self_attn", f"{hf}.self_attn")
            ln(f"{port}.self_attn_ln", f"{hf}.self_attn_layer_norm")
            for fc in ("fc1", "fc2"):
                m[f"{port}.mlp.{fc}.kernel"] = f"{hf}.{fc}.weight"
                m[f"{port}.mlp.{fc}.bias"] = f"{hf}.{fc}.bias"
            ln(f"{port}.mlp_ln", f"{hf}.final_layer_norm")
            if cross:
                attn(f"{port}.cross_attn", f"{hf}.encoder_attn")
                ln(f"{port}.cross_attn_ln", f"{hf}.encoder_attn_layer_norm")
    return m


def hf_state_dict_to_port(sd: Dict[str, np.ndarray], cfg) -> Dict[str, torch.Tensor]:
    """transformers Whisper state dict (``model.*`` or bare keys) -> the
    port's WhisperModel state_dict (f32)."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    state = {}
    for port, hf in _hf_key_map(cfg).items():
        arr = np.asarray(sd[hf], dtype=np.float32)
        if port.endswith(".kernel"):
            arr = arr.T  # Linear [out, in] -> Dense [in, out]
        state[port] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def port_to_hf_state_dict(state: Dict[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """The port's WhisperModel state_dict -> a transformers
    WhisperForConditionalGeneration state dict (``model.*`` keys, f32
    numpy), the inverse of ``hf_state_dict_to_port``. As the JAX package's
    ``flax_to_hf_state_dict``, it exports no ``adapter_*`` tensor (HF has
    no slot for them), no ``proj_out`` (tied to the embedding) and no
    sinusoidal encoder positions (not persistent in transformers)."""
    sd = {}
    for port, hf in _hf_key_map(cfg).items():
        if port not in state:
            raise KeyError(f"{port}: not in the state dict (an int8 bundle exports its "
                           "bf16 original)")
        arr = state[port].detach().to("cpu", torch.float32).numpy()
        sd[f"model.{hf}"] = np.ascontiguousarray(arr.T if port.endswith(".kernel") else arr)
    return sd


def export_hf_checkpoint(bundle, out: str | Path) -> Path:
    """A whisper-family ModelBundle -> an HF checkpoint directory that
    transformers ``from_pretrained`` reads: model.safetensors (f32, torch
    layout), config.json and generation_config.json, with the JAX
    package's fields."""
    from ..decode.whisper_generate import resolve_specials

    cfg = bundle.config.whisper
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(out / "model.safetensors",
                      port_to_hf_state_dict(bundle.model.state_dict(), cfg))
    config = {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": cfg.vocab_size,
        "num_mel_bins": cfg.num_mels,
        "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.mlp_dim,
        "decoder_ffn_dim": cfg.mlp_dim,
        "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
        "activation_function": "gelu",
        "is_encoder_decoder": True,
        "tie_word_embeddings": True,
    }
    # the special ids must lie inside a (possibly small) vocab, or torch's
    # Embedding(padding_idx=...) asserts: bos = pad = eos = EOT, the decoder
    # starts at the prompt's first token, both clamped into the vocab
    prompt, eot = resolve_specials(cfg)
    eot = int(eot) if eot < cfg.vocab_size else cfg.vocab_size - 1
    start = int(prompt[0]) if prompt and prompt[0] < cfg.vocab_size else eot
    config.update(eos_token_id=eot, pad_token_id=eot, bos_token_id=eot,
                  decoder_start_token_id=start)
    (out / "config.json").write_text(json.dumps(config, indent=2), encoding="utf-8")
    gc = {"suppress_tokens": list(cfg.suppress_ids),
          "begin_suppress_tokens": list(cfg.begin_suppress_ids)}
    if cfg.alignment_heads:
        gc["alignment_heads"] = [list(lh) for lh in cfg.alignment_heads]
    (out / "generation_config.json").write_text(json.dumps(gc, indent=2), encoding="utf-8")
    return out


def load_hf_generation_constraints(path: str | Path) -> Dict[str, tuple]:
    """generation_config.json's suppress_tokens (every step),
    begin_suppress_tokens (first generated step) and alignment_heads;
    empty entries when absent."""
    p = Path(path)
    gc = p / "generation_config.json" if p.is_dir() else None
    out = {"suppress_ids": (), "begin_suppress_ids": (), "alignment_heads": ()}
    if gc is not None and gc.exists():
        data = json.loads(gc.read_text(encoding="utf-8"))
        out["suppress_ids"] = tuple(int(t) for t in data.get("suppress_tokens") or ())
        out["begin_suppress_ids"] = tuple(int(t) for t in data.get("begin_suppress_tokens") or ())
        out["alignment_heads"] = tuple(
            (int(l), int(h)) for l, h in data.get("alignment_heads") or ())
    return out


def whisper_config_from_hf(path: str | Path):
    """WhisperConfig from an HF checkpoint directory's config.json (+ the
    generation constraints)."""
    from ..utils.config import WhisperConfig

    p = Path(path)
    data = json.loads((p / "config.json").read_text(encoding="utf-8"))
    heads = data.get("encoder_attention_heads", 6)
    if data.get("decoder_attention_heads", heads) != heads:
        raise ValueError("asymmetric encoder/decoder head counts unsupported")
    ffn = data.get("encoder_ffn_dim", 4 * data.get("d_model", 384))
    if data.get("decoder_ffn_dim", ffn) != ffn:
        raise ValueError("asymmetric encoder/decoder ffn dims unsupported")
    gc = load_hf_generation_constraints(p)
    return WhisperConfig(
        name=Path(data.get("_name_or_path", "") or "whisper_imported").name or "whisper_imported",
        vocab_size=data.get("vocab_size", 51865),
        num_mels=data.get("num_mel_bins", 80),
        d_model=data.get("d_model", 384),
        encoder_layers=data.get("encoder_layers", 4),
        decoder_layers=data.get("decoder_layers", 4),
        num_heads=heads,
        mlp_dim=ffn,
        max_source_positions=data.get("max_source_positions", 1500),
        max_target_positions=data.get("max_target_positions", 448),
        suppress_ids=gc["suppress_ids"],
        begin_suppress_ids=gc["begin_suppress_ids"],
        alignment_heads=gc["alignment_heads"],
    )


def load_hf_whisper(path: str | Path, cfg) -> Dict[str, torch.Tensor]:
    """HF checkpoint directory or .safetensors file -> port state_dict."""
    p = Path(path)
    files = sorted(p.glob("*.safetensors")) if p.is_dir() else [p]
    if not files:
        raise FileNotFoundError(f"no .safetensors under {p}")
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return hf_state_dict_to_port(sd, cfg)


def import_hf_checkpoint(src: str | Path, out: str | Path, device="cuda"):
    """HF Whisper checkpoint directory -> a bundle directory (config.yaml,
    params.npz, and the BPE tokenizer files copied beside them) -> the
    ModelBundle loaded from it on `device`."""
    from ..utils.config import ExperimentConfig, FrontendConfig, save_yaml
    from .bundle import PARAMS_FILE, ModelBundle
    from .convert import whisper_state_dict_to_params, write_npz_params

    src, out = Path(src), Path(out)
    wcfg = whisper_config_from_hf(src)
    config = ExperimentConfig(model_family="whisper", whisper=wcfg,
                              frontend=FrontendConfig(num_mels=wcfg.num_mels))
    state = load_hf_whisper(src, wcfg)
    out.mkdir(parents=True, exist_ok=True)
    save_yaml(config, str(out / "config.yaml"))
    write_npz_params(whisper_state_dict_to_params(state), out / PARAMS_FILE)
    for name in TOKENIZER_FILES:
        if (src / name).exists():
            shutil.copy(src / name, out / name)
    return ModelBundle.load(str(out), device=device)
