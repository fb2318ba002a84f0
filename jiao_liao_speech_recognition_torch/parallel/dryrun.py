"""Multi-process dry run of the production training loop: a seeded
on-disk corpus, then ``train_loop`` (mesh, FSDP2 wrap, per-process batch
rows, checkpoint) on a data x fsdp (x model) mesh of the world this
process was launched in. The counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: its data x fsdp half and its
tensor-parallel half.

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m jiao_liao_speech_recognition_torch.parallel.dryrun --workdir d --case ctc:2
    python -m jiao_liao_speech_recognition_torch.parallel.dryrun --workdir d --device cpu

A case is ``family:fsdp`` or ``family:fsdpxmodel`` (``ctc:2x2``: fsdp 2
x model 2, the data axis taking the rest of the world; ``ctc`` with
SpecAugment and every waveform
augmentation on, adapters trained; ``whisper`` with texts of different
lengths, every parameter trained), f32 at a tiny width (d 64, 2 blocks a
stack, the corpus's 30 characters), 4 rows a batch;
``family:fsdp:accum`` averages the gradients of ``accum`` micro-steps
(``grad_accum_steps``), so a checkpoint can fall between two updates;
``...@dir`` resumes from the newest checkpoint in ``dir`` (written on any
topology) and takes the steps from there. Without a process
group's variables (``torch.distributed.run``'s or ``JL_*``) it runs the
same loop in one process: the reference the multi-process runs are held
to. Each process prints one ``DRYRUN {json}`` line a case: the mesh, the
global batch's losses and pre-clip gradient norms a step, the checkpoint
steps on disk, and the share of the >= 2-D parameters and of Adam's
moments this process holds.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from . import multihost as mh

ALPHABET = [chr(0x4E00 + i) for i in range(30)]
BATCH = 4


def write_corpus(workdir: Path, n: int = 8, seed: int = 0) -> Path:
    """n seeded utterances (0.5-1.0 s of tone and noise, 1-12 characters
    of a 30-character alphabet) and their manifest, written by the primary."""
    from ..data.manifest import ManifestRow, write_manifest
    from ..frontend.audio_io import write_wav

    manifest = workdir / "train.jsonl"
    if mh.is_primary() and not manifest.exists():
        workdir.mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(seed)
        rows = []
        for i in range(n):
            secs = rng.uniform(0.5, 1.0)
            t = np.arange(int(16000 * secs)) / 16000.0
            wav = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 1500) * t)
                   + 0.05 * rng.randn(len(t))).astype(np.float32)
            write_wav(workdir / f"u{i}.wav", wav, 16000)
            text = "".join(rng.choice(ALPHABET, size=1 + (5 * i + 3) % 12))
            rows.append(ManifestRow(str(workdir / f"u{i}.wav"), text, float(secs), "dryrun"))
        # every character once, so the vocabulary is the whole alphabet
        rows[0].text = "".join(ALPHABET[:12])
        rows[1].text = "".join(ALPHABET[12:24])
        rows[2].text = "".join(ALPHABET[24:])
        write_manifest(rows, manifest)
    mh.barrier("dryrun_corpus")
    return manifest


def experiment(family: str, fsdp: int, case_dir: Path, manifest: Path, total_steps: int,
               accum: int = 1, model: int = 1):
    """The tiny config of a case (see the module docstring)."""
    from ..utils import config as c

    data = c.DataConfig(train_manifest=str(manifest), batch_size=BATCH,
                        bucket_boundaries_seconds=(1.0,), max_audio_seconds=1.0,
                        min_audio_seconds=0.1, max_text_len=16, num_host_workers=1)
    train = c.TrainConfig(
        optimizer=c.OptimizerConfig(learning_rate=1e-2 if family == "ctc" else 1e-3,
                                    warmup_steps=0, schedule="constant",
                                    total_steps=total_steps, grad_accum_steps=accum),
        train_adapters_only=family == "ctc", checkpoint_dir=str(case_dir / "ckpt"),
        checkpoint_every_steps=2, log_every_steps=1,
        metrics_path=str(case_dir / "metrics.jsonl"))
    wf = c.AdapterConfig(kind="wf", wf_rank=4)
    cfg = c.ExperimentConfig(model_family=family, frontend=c.FrontendConfig(chunk_seconds=1.0),
                             mesh=c.MeshConfig(fsdp_axis=fsdp, model_axis=model), data=data,
                             train=train)
    if family == "ctc":
        cfg.ctc_model = c.CTCModelConfig(d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
                                         conv_channels=32, dtype="float32", dropout=0.0,
                                         adapter=wf)
        cfg.specaugment = c.SpecAugmentConfig(enabled=True)
        cfg.augment = c.AugmentConfig(enabled=True, probability=1.0, lowpass_probability=1.0,
                                      highpass_probability=1.0, bandpass_probability=1.0,
                                      filter_taps=31, time_stretch_rates=(0.9, 1.1))
    elif family == "whisper":
        cfg.whisper = c.WhisperConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                                      num_heads=4, mlp_dim=128, max_source_positions=50,
                                      max_target_positions=32, dtype="float32", adapter=wf)
        cfg.specaugment = c.SpecAugmentConfig(enabled=False)
    else:
        raise ValueError(f"unknown dry-run family {family!r}")
    return cfg


def _shares(model, optimizer) -> dict:
    """This process's share of the whole model's >= 2-D parameters'
    elements and of Adam's moments (1.0 without sharding): a split
    parameter's whole is its part times the model axis."""
    def local(t):
        return t.to_local().numel() if hasattr(t, "to_local") else t.numel()

    tp = getattr(model, "tp", None)
    dims = getattr(model, "tp_dims", {})
    whole = {id(p): p.numel() * (tp.size if n in dims else 1)
             for n, p in model.named_parameters()}
    params = [p for p in model.parameters() if p.ndim >= 2]
    moments = [(v, whole[id(p)]) for p, st in optimizer.state.items() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq") and v.ndim >= 2]
    return {"param_share": sum(local(p) for p in params) / sum(whole[id(p)] for p in params),
            "adam_share": (sum(local(v) for v, _ in moments) / sum(n for _, n in moments)
                           if moments else None)}


def run_case(family: str, fsdp: int, workdir: Path, steps: int = 2, device="cpu",
             resume_from: Optional[Path] = None, tag: str = "", accum: int = 1,
             model: int = 1) -> dict:
    """One case under the current process group (or none): `steps` steps,
    or with `resume_from` (a checkpoint directory, copied first) `steps`
    more from its newest checkpoint; `model` the model axis."""
    from ..data.manifest import read_manifest
    from ..train.checkpoints import TrainCheckpointer
    from ..train.engine import build_tokenizer_for, make_model, train_loop

    manifest = write_corpus(workdir)
    if accum > 1:
        tag = f"_a{accum}{tag}"
    axes, m_tag = (f"{fsdp}x{model}", f"_m{model}") if model > 1 else (f"{fsdp}", "")
    case_dir = workdir / f"{family}_w{mh.process_count()}_f{fsdp}{m_tag}{tag}"
    first = 0
    if resume_from is not None:
        first = TrainCheckpointer(str(resume_from)).latest_step()
        if mh.is_primary():
            shutil.rmtree(case_dir / "ckpt", ignore_errors=True)
            shutil.copytree(resume_from, case_dir / "ckpt")
        mh.barrier("dryrun_copy")
    cfg = experiment(family, fsdp, case_dir, manifest, first + steps, accum, model)
    rows = read_manifest(cfg.data.train_manifest)
    tokenizer = build_tokenizer_for(cfg, rows)
    model = make_model(cfg, device)
    state, info = train_loop(cfg, rows, tokenizer, model, resume=resume_from is not None)
    out = {"case": f"{family}:{axes}{tag}", "rank": mh.process_index(),
           "world": mh.process_count(), "losses": info["losses"],
           "final_step": state.step, "mesh": info["mesh"] or [1, 1, 1],
           **_shares(state.model, state.optimizer)}
    if mh.is_primary():
        recs = [json.loads(line) for line in Path(cfg.train.metrics_path).read_text().splitlines()]
        out["grad_norms"] = [r["grad_norm"] for r in recs if "grad_norm" in r]
        out["logged_losses"] = [r["loss"] for r in recs if "loss" in r]
        out["checkpoints"] = sorted(p.name for p in (case_dir / "ckpt").iterdir())
    assert all(math.isfinite(x) for x in info["losses"]), info["losses"]
    mh.barrier("dryrun_case")
    return out


def main(argv=None) -> int:
    import os

    p = argparse.ArgumentParser(prog="dryrun", description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--case", action="append", default=None,
                   help="family:fsdp[xmodel][:accum][@checkpoint_dir] (repeatable; default "
                   "ctc:F with F 2 on an even world)")
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    if os.environ.get("JL_COORDINATOR") or os.environ.get("MASTER_ADDR"):
        mh.initialize(device=args.device)
    try:
        cases = args.case or [f"ctc:{2 if mh.process_count() % 2 == 0 else 1}"]
        for case in cases:
            case, _, resume = case.partition("@")
            family, axes, *accum = case.split(":")
            fsdp, _, model = axes.partition("x")
            out = run_case(family, int(fsdp), Path(args.workdir), args.steps, args.device,
                           resume_from=Path(resume) if resume else None,
                           tag="_resumed" if resume else "", accum=int(accum[0]) if accum else 1,
                           model=int(model or 1))
            print("DRYRUN " + json.dumps(out), flush=True)
    finally:
        mh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
