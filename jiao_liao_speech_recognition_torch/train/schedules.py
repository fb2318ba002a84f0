"""Multi-dialect transfer schedules, the twin of the JAX package's
``train/schedules.py`` (BASELINE configs[3], the paper's method): adapt on
the larger neighbouring-dialect corpora, then fine-tune the adapters on
low-resource Jiao-Liao with the backbone frozen.

Each ``DialectStage`` is one ``engine.train_loop`` run over its own
manifests (mixed by weight when it names several) with its own trainable
set and a fresh optimizer, checkpointed under
``<checkpoint_dir>/stage_<i>_<name>``; the model carries from stage to
stage. On one card a stage's steps are captured anew (its own graphs over
its trainable set); the previous stage's graphs and their pool are
released when its ``train_loop`` returns. With ``resume=True`` a finished stage restores its last checkpoint
and takes no step, and the stage in progress continues exactly. Under a
process group every stage runs on the mesh (the model is wrapped once,
by the first stage), and the metrics are the primary process's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Optional

from ..data.manifest import Manifest, read_manifest
from ..data.pipeline import mix_manifests
from ..data.tokenizer import CharTokenizer
from ..parallel import multihost as mh
from ..parallel.mesh import full_model
from ..utils.config import DialectStage, ExperimentConfig
from ..utils.logging import MetricsLogger
from .engine import make_model, size_vocab, train_loop


def build_stage_manifest(stage: DialectStage) -> Manifest:
    """A stage's manifest: its one manifest as it is, or the mixture of
    several, keyed (and weighted) by manifest path."""
    manifests = {p: read_manifest(p) for p in stage.manifests}
    if len(manifests) == 1:
        return next(iter(manifests.values()))
    weights = None
    if stage.mix_weights is not None:
        weights = {p: w for p, w in zip(stage.manifests, stage.mix_weights)}
    return mix_manifests(manifests, weights)


def run_stages(config: ExperimentConfig, model=None, tokenizer: Optional[CharTokenizer] = None,
               resume: bool = False, device="cuda", kernels: bool = True, graph: bool = True):
    """Run ``config.stages`` in order on `device`, carrying the model.

    The char vocabulary is built over the union of all stages' texts and
    sizes the model's (``engine.size_vocab``: the ctc, joint or whisper family);
    without `model` the family's model is made from ``train.seed``. Each stage runs with
    ``train.train_adapters_only`` and ``optimizer.total_steps`` (= its
    steps; warmup as configured) replaced, and appends a summary line
    {"step", "ts", "stage", "stage_index", **last metrics} to
    ``train.metrics_path`` through the one ``MetricsLogger`` its stages'
    records go to. A SIGTERM ends the schedule after that stage's
    checkpoint. -> (model, tokenizer, history), history holding
    {"stage": name, **last metrics} per stage run; under a process group
    the model returned is a plain one with the trained weights, on every
    process (``parallel.mesh.full_model``).
    """
    if not config.stages:
        raise ValueError("run_stages needs config.stages")
    stage_manifests = [build_stage_manifest(s) for s in config.stages]
    if tokenizer is None:
        tokenizer = CharTokenizer.build([t for m in stage_manifests for t in m.texts()])
    size_vocab(config, len(tokenizer))
    if model is None:
        model = make_model(config, device)

    base_dir = Path(config.train.checkpoint_dir)
    history = []
    logger_cm = (MetricsLogger(config.train.metrics_path, use_wandb=config.train.use_wandb)
                 if mh.is_primary() else contextlib.nullcontext())
    with logger_cm as logger:
        for si, (stage, manifest) in enumerate(zip(config.stages, stage_manifests)):
            train = dataclasses.replace(
                config.train, train_adapters_only=stage.train_adapters_only,
                optimizer=dataclasses.replace(config.train.optimizer, total_steps=stage.steps))
            stage_cfg = dataclasses.replace(config, train=train)
            stage_dir = str(base_dir / f"stage_{si}_{stage.name or 'stage'}")
            _, info = train_loop(stage_cfg, manifest, tokenizer, model, resume=resume,
                                 checkpoint_dir=stage_dir, logger=logger, kernels=kernels,
                                 graph=graph)
            history.append({"stage": stage.name, **info["last_metrics"]})
            if logger is not None:
                logger.log(stage.steps, stage=stage.name, stage_index=si,
                           **info["last_metrics"])
                if info["terminated"]:
                    logger.log(stage.steps, event="sigterm_stage_exit", stage=stage.name)
            if info["terminated"]:
                break
    return full_model(model, lambda: make_model(config, device)), tokenizer, history
