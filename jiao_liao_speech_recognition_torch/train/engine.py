"""Fine-tuning engine, the twin of the JAX package's ``train/engine.py``.

* ``make_schedule``: optax's warmup + cosine / linear, constant and noam,
  as a function of the optimizer's update count.
* ``make_optimizer``: optax's ``chain(clip_by_global_norm, adamw | adam |
  sgd)`` inside ``multi_transform``. torch.optim's AdamW takes the same
  decoupled step (p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)); the
  global-norm clip runs over the trainable parameters only, as it sits in
  the "train" branch; frozen parameters get ``requires_grad=False`` (the
  JAX step's ``stop_gradient``), so no backbone weight gradient is formed.
* ``grad_accum_steps`` (optax ``MultiSteps``): gradients of k micro-steps
  are averaged before the clip and the update.
* ``make_ctc_loss_fn``: K1 featurizes under ``no_grad`` (no gradient flows
  into it), then SpecAugment, the model in train mode, and the mean of the
  per-example CTC NLL over label lengths. ``make_joint_loss_fn`` (the joint
  CTC/attention family): one encoder pass feeds the CTC head and the
  teacher-forced decoder; ctc_weight * CTC + (1 - ctc_weight) * CE, the CE
  over the targets that ``batch_to_device(..., family="joint")`` builds
  (sos/eos = the blank, id 0). ``make_whisper_loss_fn``: the teacher-forced
  CE of Whisper over the prompt-prefixed tokens and shifted targets of
  ``batch_to_device(..., family="whisper")``. ``make_loss_fn`` /
  ``make_model`` / ``size_vocab`` choose by ``config.model_family``;
  ``build_tokenizer_for`` gives a byte-level BPE (``data.tokenizer_dir``),
  a unigram (``data.unigram_vocab``) or a char vocabulary.
* ``train_loop`` (one run, or one stage of ``train/schedules.py``: its own
  checkpoint directory, a fresh optimizer over the stage's trainable set)
  / ``run_experiment`` / ``evaluate_manifest``.

Randomness: one CPU ``torch.Generator`` seeded from ``TrainConfig.seed``
draws three seeds per step, for SpecAugment, the dropout masks and the
waveform augmentation (``augment.enabled``: the ctc and joint losses, as
in JAX; Whisper's takes none); its state is checkpointed, so resume is
exact. The data order is
the JAX package's seeded epoch plan (``data/pipeline.py``).

One process on a card trains through ``TrainStep``, the JAX package's
jitted step: each bucket's step (one (audio samples, label length)
shape) is captured once as a CUDA graph and replayed, the host doing only
what ``TrainStep`` lists between replays; ``graph=False`` runs the same
operations eagerly, bit for bit. ``step_route`` keeps the plain path, sgd
and a process group eager by rule.

Several processes (one per card, ``cli train --multihost``): under a
process group ``train_loop`` builds the mesh of ``config.mesh``, splits
the model over its model axis and wraps it with FSDP2 (parallel/mesh.py);
each (data, fsdp) rank collates and runs its rows of every global batch,
the ranks of a model group the same rows. What keeps N processes equal to
one: the clip takes the norm over every gradient shard, summing a split
parameter's squares over its model group and counting a replicated one
once; the CTC loss's per-row mean and the Whisper / joint CE's masked mean
are scaled so that the (data, fsdp) ranks' averaged gradient is the
global mean's, the sums running over those ranks (``batch["dp"]``), and
every process logs the global batch's loss; SpecAugment and the waveform
augmentation draw each row's values for the global batch
(``batch["rows"]``), so a row is augmented alike on any topology. Dropout
is not: the dropout seed has the (data, fsdp) rank folded in, so those
ranks draw independent masks, and the ranks of a model group, which hold
the same activations, equal ones. Host IO (metrics, the final bundle,
checkpoint files) is the primary process's, mid-train evaluation runs only
with one process, and a SIGTERM on any process stops all of them at one
checkpoint.
"""

from __future__ import annotations

import math
import signal
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..frontend.augment import augment_waveform
from ..frontend.features import dequantize_pcm, featurize_batch
from ..frontend.specaugment import apply_masks, draw_masks, spec_augment
from ..models.adapters import param_is_adapter
from ..models.layers import seed_dropout
from ..ops.ctc_loss import ctc_loss
from ..parallel import multihost as mh
from ..utils.config import ExperimentConfig, OptimizerConfig
from ..utils.logging import MetricsLogger


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int, count: float) -> float:
    """optax.linear_schedule (a constant `init` when steps <= 0)."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0.0), steps) / steps
    return (init - end) * frac + end


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate as a function of the update count (0 for the first
    update), as optax evaluates its schedules."""
    lr, warm = cfg.learning_rate, cfg.warmup_steps
    if cfg.schedule == "constant":
        return lambda step: lr
    if cfg.schedule == "noam":
        return lambda step: lr * min((step + 1.0) ** -0.5, (step + 1.0) * warm ** -1.5) * warm ** 0.5
    if cfg.schedule not in ("cosine", "linear"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    rest = max(cfg.total_steps - warm, 1)

    def decay(count: float) -> float:
        if cfg.schedule == "cosine":
            count = min(count, rest)
            return lr * 0.5 * (1.0 + math.cos(math.pi * count / rest))
        return _linear(lr, 0.0, rest, count)

    def schedule(step: int) -> float:
        return _linear(0.0, lr, warm, step) if step < warm else decay(step - warm)

    return schedule


def adapter_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """state_dict key -> True for trainable (adapter) parameters."""
    return {name: param_is_adapter(name) for name, _ in model.named_parameters()}


def make_optimizer(cfg: OptimizerConfig, params) -> torch.optim.Optimizer:
    """The base optimizer over the trainable parameters; the learning rate
    is set from the schedule before each update (``apply_update``, or
    ``TrainStep``). On a card adamw and adam are capturable: the step count
    lives on the device and the learning rate is a device scalar the host
    writes, so the update can be captured in a CUDA graph (eager steps,
    also under a process group, take the same arithmetic)."""
    params = list(params)
    if cfg.name in ("adamw", "adam") and params[0].device.type == "cuda":
        lr = torch.zeros((), dtype=torch.float32, device=params[0].device)
        kw = dict(lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8, capturable=True, foreach=True)
        if cfg.name == "adamw":
            return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
        return torch.optim.Adam(params, **kw)
    if cfg.name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=cfg.beta1)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         split: Optional[List[bool]] = None, tp_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place -> the norm before clipping.
    FSDP2's gradients (DTensors) are clipped by the norm over all their
    shards: each process's shard norms, combined over the fsdp group. On a
    model axis (`tp_group`), the squares of the gradients that `split`
    marks (a rank's part of a split parameter) are also summed over the
    model group; the others are whole on every rank of it and count once."""
    shards, group = _local_shards(grads)
    fsdp = group is not None and torch.distributed.get_world_size(group) > 1
    if tp_group is not None:
        sq = [torch.linalg.vector_norm(g).square() for g in shards]
        zero = shards[0].new_zeros((), dtype=torch.float32)
        parts = torch.stack([sum((q for q, s in zip(sq, split) if s), zero),
                             sum((q for q, s in zip(sq, split) if not s), zero)])
        if fsdp:
            torch.distributed.all_reduce(parts, group=group)
        torch.distributed.all_reduce(parts[0], group=tp_group)
        norm = parts.sum().sqrt()
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in shards]))
        if fsdp:
            sq = norm * norm
            torch.distributed.all_reduce(sq, group=group)
            norm = sq.sqrt()
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(shards, factor)
    return norm


def _local_shards(grads: List[torch.Tensor]):
    """-> (this process's part of each gradient, views that write through,
    and the process group over which a DTensor's shards lie, or None)."""
    from torch.distributed.tensor import DTensor

    if not grads or not isinstance(grads[0], DTensor):
        return grads, None
    mesh, placements = grads[0].device_mesh, grads[0].placements
    dim = next((i for i, pl in enumerate(placements) if pl.is_shard()), None)
    return [g.to_local() for g in grads], None if dim is None else mesh.get_group(dim)


def set_trainable(model: torch.nn.Module, adapters_only: bool) -> List[torch.nn.Parameter]:
    """requires_grad per the frozen-backbone mask -> the trainable params."""
    mask = adapter_mask(model)
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name] or not adapters_only)
        if p.requires_grad:
            out.append(p)
    if not out:
        raise ValueError("no trainable parameters: train_adapters_only with adapter kind 'none'")
    return out


@dataclass
class TrainState:
    """What a checkpoint holds: micro-step count, model, optimizer and the
    generator that draws each step's seeds."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    info: Dict[str, Any] = field(default_factory=dict)
    # on a model axis: the ids of the split parameters and the model group
    tp_split: frozenset = frozenset()
    tp_group: Any = None
    # micro-steps an update (grad_accum_steps): between updates the
    # gradients hold a partial sum a checkpoint keeps
    accum: int = 1

    def trainable(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def init_state(config: ExperimentConfig, model: torch.nn.Module) -> TrainState:
    params = set_trainable(model, config.train.train_adapters_only)
    opt = make_optimizer(config.train.optimizer, params)
    gen = torch.Generator().manual_seed(config.train.seed)
    state = TrainState(0, model, opt, gen, accum=max(config.train.optimizer.grad_accum_steps, 1))
    tp = getattr(model, "tp", None)  # split over a model axis (parallel/tp.py)
    if tp is not None and tp.size > 1:
        state.tp_group = tp.group
        state.tp_split = frozenset(id(p) for n, p in model.named_parameters()
                                   if n in model.tp_dims)
    return state


def clip_and_step(state: TrainState, cfg: OptimizerConfig) -> torch.Tensor:
    """Average the gradients of grad_accum_steps micro-steps, clip them,
    take the optimizer step -> the norm before clipping. Device work only
    (the learning rate is set before)."""
    params = [p for p in state.trainable() if p.grad is not None]
    k = max(cfg.grad_accum_steps, 1)
    grads = [p.grad for p in params]
    if k > 1:
        torch._foreach_mul_(grads, 1.0 / k)
    norm = clip_by_global_norm_(grads, cfg.grad_clip_norm,
                                [id(p) in state.tp_split for p in params], state.tp_group)
    state.optimizer.step()
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write the scheduled rate: into the device scalar of a capturable
    optimizer (in place: a captured update reads it), else into the groups."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def apply_update(state: TrainState, cfg: OptimizerConfig, schedule) -> Dict[str, float]:
    """Clip the trainable gradients (summed over grad_accum_steps
    micro-steps), set the scheduled learning rate, take the optimizer step
    and clear the gradients -> {"grad_norm": the norm before clipping}, the
    metric the JAX step adds to its loss's."""
    k = max(cfg.grad_accum_steps, 1)
    set_learning_rate(state.optimizer, schedule(state.step // k - 1))  # updates taken before
    norm = clip_and_step(state, cfg)
    state.optimizer.zero_grad(set_to_none=True)
    return {"grad_norm": norm}


# ---------------------------------------------------------------------------
# loss and step
# ---------------------------------------------------------------------------


def augmented_audio(config: ExperimentConfig, batch, seeds, train: bool) -> torch.Tensor:
    """The batch's float audio, waveform-augmented in training when
    ``augment.enabled`` (a generator on the audio's device seeded with
    ``seeds[2]``), as the JAX CTC and joint losses do before featurizing."""
    audio = dequantize_pcm(batch["audio"])
    if train and config.augment.enabled:
        gen = torch.Generator(device=audio.device).manual_seed(seeds[2])
        audio = augment_waveform(gen, audio, config.augment, config.frontend.sample_rate,
                                 batch.get("rows"))
    return audio


def _features(config: ExperimentConfig, batch, seeds, train: bool, kernels: bool,
              augment: bool = True):
    """K1 under ``no_grad`` (after the waveform augmentation where
    `augment`), then SpecAugment -> (features, valid frames). With
    ``seeds=None`` the batch is a train step's prepared one
    (``step_inputs``): the augmented audio in ``audio_aug`` and the
    SpecAugment draws in ``spec:*``."""
    fe = config.frontend
    with torch.no_grad():
        if seeds is None:
            audio = batch.get("audio_aug", batch["audio"])
        elif augment:
            audio = augmented_audio(config, batch, seeds, train)
        else:
            audio = dequantize_pcm(batch["audio"])
        feats = featurize_batch(audio, fe, kernels=kernels)
    sa = config.specaugment
    if train and sa.enabled and seeds is None:
        feats = apply_masks(feats, {k[5:]: v for k, v in batch.items() if k.startswith("spec:")},
                            sa)
    elif train and sa.enabled:
        feats = spec_augment(torch.Generator().manual_seed(seeds[0]), feats, sa,
                             batch.get("rows"))
    return feats, batch["audio_lengths"] // fe.hop_length


def _dropout_seed(seeds, train: bool):
    """The model's dropout_seed: the step's, or None where a train step
    seeded the sites on the host (prepared batch) or outside training."""
    return seeds[1] if train and seeds is not None else None


def data_parallel_world(batch) -> int:
    """The (data, fsdp) rank count when `batch` holds this rank's rows of
    a larger global batch (``batch["rows"]`` and ``batch["dp"]``,
    parallel/mesh.shard_batch), else 1 (one process, or a ragged batch
    every process holds whole)."""
    rows = batch.get("rows")
    if rows is None or rows[1] == batch["audio"].shape[0]:
        return 1
    return batch["dp"][0]


def _dp_sum(x: torch.Tensor, batch) -> torch.Tensor:
    """x summed over the (data, fsdp) ranks that hold the global batch's
    rows (every process, unless a model axis groups them)."""
    return mh.all_sum(x, batch["dp"][1])


def ctc_mean_loss(nll: torch.Tensor, label_lengths: torch.Tensor, batch):
    """The mean over the batch of each row's NLL over its label length ->
    (the loss to differentiate, {"loss", "nll_sum"} of the global batch).
    With this process's rows of a global batch of G rows, the loss is its
    rows' sum over G times the process count: the processes' averaged
    gradient is the global mean's."""
    per_row = nll / label_lengths.clamp_min(1).float()
    world = data_parallel_world(batch)
    if world == 1:
        loss = per_row.mean()
        return loss, {"loss": loss.detach(), "nll_sum": nll.detach().sum()}
    G = batch["rows"][1]
    return per_row.sum() * (world / G), {"loss": _dp_sum(per_row.detach().sum(), batch) / G,
                                         "nll_sum": _dp_sum(nll.detach().sum(), batch)}


def make_ctc_loss_fn(config: ExperimentConfig, model) -> Callable:
    """loss_fn(batch, seeds, train, kernels) -> (loss, metrics); batch is
    a dict of tensors on the model's device, seeds = (specaugment, dropout,
    waveform augmentation), or None for a train step's prepared batch
    (``step_inputs``: the sites seeded, the draws made on the host)."""

    def loss_fn(batch, seeds, train: bool, kernels: bool = True):
        feats, feat_lengths = _features(config, batch, seeds, train, kernels)
        model.train(train)
        log_probs, out_lens = model(feats, feat_lengths, kernels=kernels,
                                    dropout_seed=_dropout_seed(seeds, train))
        nll = ctc_loss(log_probs, out_lens, batch["labels"], batch["label_lengths"],
                       kernels=kernels)
        return ctc_mean_loss(nll, batch["label_lengths"], batch)

    return loss_fn


def cross_entropy_like_optax(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels per position.
    optax does not upcast: logsumexp(logits) - logits[target] in the
    logits' own dtype (bf16 for a bf16 decoder), each elementwise op
    rounded to it, and only the sum of exp inside jax.nn.logsumexp
    accumulated in f32 (jnp's reductions upcast bf16) and rounded back."""
    amax = logits.amax(dim=-1, keepdim=True).detach()  # stop_gradient, as jax.nn.logsumexp
    sumexp = torch.exp(logits - amax).float().sum(dim=-1).to(logits.dtype)
    lse = torch.log(sumexp) + amax[..., 0]
    return lse - logits.gather(-1, targets[..., None].long())[..., 0]


def make_joint_loss_fn(config: ExperimentConfig, model) -> Callable:
    """The joint family's hybrid loss, loss_fn(batch, seeds, train, kernels)
    -> (loss, {"loss", "loss_ctc", "loss_att"}): ctc_weight x the CTC loss
    of make_ctc_loss_fn + (1 - ctc_weight) x the decoder's CE averaged over
    the positions whose target is not -100, both off one encoder pass. The
    CE is in the decoder logits' dtype (``cross_entropy_like_optax``), so
    with a bf16 decoder loss_att is a bf16 number, as in the JAX step."""
    w = config.joint.ctc_weight

    def loss_fn(batch, seeds, train: bool, kernels: bool = True):
        feats, feat_lengths = _features(config, batch, seeds, train, kernels)
        model.train(train)
        ctc_lp, out_lens, dec_logits = model(feats, feat_lengths, batch["tokens"],
                                             kernels=kernels,
                                             dropout_seed=_dropout_seed(seeds, train))
        nll = ctc_loss(ctc_lp, out_lens, batch["labels"], batch["label_lengths"],
                       kernels=kernels)
        loss_ctc, ctc_m = ctc_mean_loss(nll, batch["label_lengths"], batch)
        loss_att, att_value = global_masked_mean_ce(dec_logits, batch["targets"], batch)
        loss = w * loss_ctc + (1.0 - w) * loss_att
        return loss, {"loss": w * ctc_m["loss"] + (1.0 - w) * att_value,
                      "loss_ctc": ctc_m["loss"], "loss_att": att_value}

    return loss_fn


def masked_mean_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The CE (``cross_entropy_like_optax``) averaged over the positions
    whose target is not -100, as the JAX steps sum it: in the logits'
    dtype, the sum accumulated in f32 and rounded back."""
    valid = targets >= 0
    ce = cross_entropy_like_optax(logits, targets.clamp_min(0))
    return (ce * valid).float().sum().to(ce.dtype) / valid.sum().clamp_min(1)


def global_masked_mean_ce(logits: torch.Tensor, targets: torch.Tensor, batch):
    """``masked_mean_ce`` of the global batch -> (the loss to
    differentiate, its value). With this process's rows of a global batch
    (``data_parallel_world``), the loss is this process's f32 sum over the
    all-reduced count of valid targets times the process count, so the
    processes' averaged gradient is the global masked mean's however the
    targets fall across them; the value is ``masked_mean_ce``'s expression
    on the all-reduced sum and count."""
    world = data_parallel_world(batch)
    if world == 1:
        loss = masked_mean_ce(logits, targets)
        return loss, loss.detach()
    valid = targets >= 0
    ce = cross_entropy_like_optax(logits, targets.clamp_min(0))
    local = (ce * valid).float().sum()
    count = _dp_sum(valid.sum(), batch).clamp_min(1)
    return local * (world / count), _dp_sum(local.detach(), batch).to(ce.dtype) / count


def make_whisper_loss_fn(config: ExperimentConfig, model) -> Callable:
    """Whisper's teacher-forced loss, loss_fn(batch, seeds, train, kernels)
    -> (loss, {"loss"}): K1 featurizes under ``no_grad``, SpecAugment in
    training, then the model over batch["tokens"] (prompt, labels, EOT
    padding) and the mean CE over batch["targets"] (``masked_mean_ce``;
    bf16 for a bf16 decoder). Like the JAX loss it applies no waveform
    augmentation."""

    def loss_fn(batch, seeds, train: bool, kernels: bool = True):
        feats, _ = _features(config, batch, seeds, train, kernels, augment=False)
        model.train(train)
        logits = model(feats, batch["tokens"], kernels=kernels,
                       dropout_seed=_dropout_seed(seeds, train))
        loss, value = global_masked_mean_ce(logits, batch["targets"], batch)
        return loss, {"loss": value}

    return loss_fn


def make_loss_fn(config: ExperimentConfig, model) -> Callable:
    """The family's loss (the JAX package's build_train_setup)."""
    makers = {"ctc": make_ctc_loss_fn, "joint": make_joint_loss_fn,
              "whisper": make_whisper_loss_fn}
    if config.model_family not in makers:
        raise ValueError(f"unknown model family {config.model_family!r}")
    return makers[config.model_family](config, model)


def make_model(config: ExperimentConfig, device="cuda"):
    """A fresh model of the family, initialised from ``train.seed`` (a
    Whisper model on `device` itself, as ``ModelBundle.load`` makes it)."""
    from ..models.ctc_model import CTCEncoderModel
    from ..models.joint import JointCTCAttentionModel
    from ..models.whisper import WhisperModel

    seed = config.train.seed
    if config.model_family == "ctc":
        return CTCEncoderModel(config.ctc_model, device=device, seed=seed)
    if config.model_family == "joint":
        return JointCTCAttentionModel(config.joint, device=device, seed=seed)
    if config.model_family == "whisper":
        return WhisperModel(config.whisper, device=device, seed=seed)
    raise ValueError(f"unknown model family {config.model_family!r}")


def step_seeds(state: TrainState, batch) -> List[int]:
    """The step's three seeds (SpecAugment, dropout, waveform
    augmentation) from the checkpointed CPU generator; the dropout seed has
    the (data, fsdp) rank folded in: independent masks on each such rank,
    equal ones within a model group."""
    seeds = torch.randint(0, 2**62, (3,), generator=state.generator).tolist()
    rank = batch["dp"][2] if "dp" in batch else mh.process_index()
    if rank:
        seeds[1] = (seeds[1] + rank * 0x9E3779B97F4A7C15) % 2**62
    return seeds


def make_train_step(loss_fn: Callable, cfg: OptimizerConfig) -> Callable:
    """train_step(state, batch, kernels=True) -> metrics (tensors and
    floats): one micro-step, eagerly, on a batch of device tensors; every
    grad_accum_steps-th applies the update. The step under a process group
    (FSDP2) and of the callers that time single steps; one process on one
    card trains through ``TrainStep``."""
    schedule = make_schedule(cfg)
    k = max(cfg.grad_accum_steps, 1)

    def train_step(state: TrainState, batch, kernels: bool = True):
        loss, metrics = loss_fn(batch, step_seeds(state, batch), True, kernels)
        loss.backward()  # summed over the micro-steps; the update averages
        state.step += 1
        if state.step % k == 0:
            metrics.update(apply_update(state, cfg, schedule))
        return metrics

    return train_step


def step_inputs(config: ExperimentConfig, model, batch, seeds) -> Dict[str, torch.Tensor]:
    """The host's part of a train step: seed every dropout site of `model`
    with seeds[1], and draw SpecAugment's masks from seeds[0] for the
    batch's shape -> the draws as CPU tensors under ``spec:*`` (empty with
    SpecAugment off), which the loss reads with ``seeds=None``."""
    seed_dropout(model, seeds[1])
    sa = config.specaugment
    if not sa.enabled:
        return {}
    B, samples = batch["audio"].shape
    draws = draw_masks(torch.Generator().manual_seed(seeds[0]), B, config.frontend.num_mels,
                       samples // config.frontend.hop_length, sa, batch.get("rows"))
    return {f"spec:{k}": v for k, v in draws.items()}


class _Bucket:
    """One batch shape's static device buffers, the pinned staging they are
    filled from (on a card) and the step's graph once captured."""

    def __init__(self, inputs: Dict[str, torch.Tensor], device: torch.device, augment: bool):
        self.static = {k: torch.empty_like(v, device=device) for k, v in inputs.items()}
        if augment:
            self.static["audio_aug"] = torch.empty(inputs["audio"].shape, dtype=torch.float32,
                                                   device=device)
        self.staging = self.copied = None
        if device.type == "cuda":
            self.staging = {k: torch.empty_like(v).pin_memory() for k, v in inputs.items()}
            self.copied = torch.cuda.Event()
        self.captured = None

    def fill(self, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy the host tensors in: through the pinned staging, once the
        previous copy out of it has run (a wait, no read back)."""
        if self.staging is None:
            for k, v in inputs.items():
                self.static[k].copy_(v)
            return
        self.copied.synchronize()
        for k, v in inputs.items():
            self.staging[k].copy_(v)
            self.static[k].copy_(self.staging[k], non_blocking=True)
        self.copied.record()


class TrainStep:
    """The JAX package's jitted train step on one process: ``step(host)``
    takes a batch of host tensors (``batch_to_device(..., "cpu")``) and
    returns its metrics, cloned. Between steps the host only copies the
    batch into its shape's static buffers, draws the seeds and SpecAugment's
    masks (``step_inputs``), seeds the dropout generators, writes the
    scheduled learning rate into the optimizer's device scalar, runs the
    waveform augmentation's eager head (``augment.enabled``: it reads its
    draws back) and clones the metrics out.

    With ``graph`` (``utils/graphs.capturing``: a card) each bucket's step
    is captured once as a CUDA graph and replayed: the bucket's first step
    runs eagerly on the warm-up stream (a real step), the cache is emptied,
    and the step is captured into a pool that every bucket's graph shares
    (they never run at once; what a replay leaves there is cloned out before
    the next). With grad_accum_steps k > 1 a micro-step graph a bucket
    accumulates into the persistent gradients and an update graph (average,
    clip, optimizer step, zero) replays every k-th micro-step; with k = 1
    the update is inside the bucket's graph. Without ``graph`` the same
    operations run eagerly, so the two routes agree bit for bit. The
    gradients are allocated once, before any capture, and zeroed in place
    by the update; a restore after a capture needs ``release`` (the graphs
    hold the optimizer's tensors)."""

    def __init__(self, config: ExperimentConfig, state: TrainState, kernels: bool = True,
                 graph: bool = False):
        from ..parallel.mesh import is_sharded

        if graph and is_sharded(state.model):
            raise ValueError("TrainStep: an FSDP2-wrapped model's hooks and collectives are not "
                             "captured; graph=False runs the step eagerly")
        self.config, self.state, self.kernels, self.graph = config, state, kernels, graph
        self.opt_cfg = config.train.optimizer
        self.k = max(self.opt_cfg.grad_accum_steps, 1)
        self.schedule = make_schedule(self.opt_cfg)
        self.loss_fn = make_loss_fn(config, state.model)
        self.device = next(state.model.parameters()).device
        self.augment = config.augment.enabled and config.model_family != "whisper"
        for p in state.trainable():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.buckets: Dict[tuple, _Bucket] = {}
        self.update_graph = None
        self.pool = torch.cuda.graph_pool_handle() if graph and self.device.type == "cuda" else None
        self.capture_s: List[float] = []
        self.replays = 0
        self.replay_launches: Dict[str, int] = {}

    def release(self) -> None:
        """Drop the captured graphs and their pool."""
        self.buckets.clear()
        self.update_graph = None
        if self.pool is not None:
            self.pool = torch.cuda.graph_pool_handle()

    def __call__(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state = self.state
        seeds = step_seeds(state, host)
        inputs = {**host, **step_inputs(self.config, state.model, host, seeds)}
        key = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = self.buckets[key] = _Bucket(inputs, self.device, self.augment)
        bucket.fill(inputs)
        if self.augment:
            bucket.static["audio_aug"].copy_(
                augmented_audio(self.config, bucket.static, seeds, True))
        update = (state.step + 1) % self.k == 0
        if update:  # the updates taken before this one
            set_learning_rate(state.optimizer, self.schedule((state.step + 1) // self.k - 1))
        if self.k == 1:
            metrics = self._run(bucket, "captured", lambda: self._micro(bucket) | self._update())
        else:
            metrics = dict(self._run(bucket, "captured", lambda: self._micro(bucket)))
            if update:
                metrics.update(self._run(self, "update_graph", self._update))
        state.step += 1
        return {k: v.detach().clone() for k, v in metrics.items()}

    def _micro(self, bucket: _Bucket) -> Dict[str, torch.Tensor]:
        loss, metrics = self.loss_fn(bucket.static, None, True, self.kernels)
        loss.backward()  # accumulates into the persistent gradients
        return metrics

    def _update(self) -> Dict[str, torch.Tensor]:
        norm = clip_and_step(self.state, self.opt_cfg)
        torch._foreach_zero_([p.grad for p in self.state.trainable()])
        return {"grad_norm": norm}

    def _run(self, owner, attr: str, body: Callable) -> Dict[str, torch.Tensor]:
        """body() eagerly, or its graph (``owner.<attr>``): captured after
        an eager warm-up the first time, replayed after that."""
        if not self.graph:
            return body()
        from ..models.layers import dropout_generators
        from ..utils import graphs

        cap = getattr(owner, attr)
        if cap is None:
            t0 = time.perf_counter()
            out = graphs.warm(body)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()  # the warm-up's blocks back for the pool
            cap = graphs.CapturedStep(body, tally=True, warmed=True,
                                      generators=dropout_generators(self.state.model),
                                      pool=self.pool)
            setattr(owner, attr, cap)
            self.capture_s.append(time.perf_counter() - t0)
            return out
        cap.replay()
        self.replays += 1
        for name, n in cap.launches.items():
            self.replay_launches[name] = self.replay_launches.get(name, 0) + n
        return cap.out

    def info(self) -> Dict[str, Any]:
        return {"captured": self.graph, "graphs": len(self.capture_s), "replays": self.replays,
                "capture_s": list(self.capture_s), "replay_launches": dict(self.replay_launches)}


def batch_to_device(batch, device, family: str = "ctc", whisper_prompt=None,
                    eot_id: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Host Batch -> dict of tensors on `device` (int16 audio stays int16:
    the step dequantizes on the card). For the whisper and joint families
    also the teacher-forcing ``tokens`` [B, P + S + 1] (the prompt, the
    labels, then EOT to the end) and ``targets`` (each position's next
    token: the labels, then EOT; -100 where ignored). Whisper's prompt and
    EOT default to the standard multilingual ones (``default_prompt()``,
    EOT 50257; small vocabularies pass their own, as train_loop does from
    ``resolve_specials``); the joint family's prompt is (eot,) and its EOT
    the blank, id 0, which never occurs inside a label sequence."""
    from ..decode.whisper_generate import EOT, default_prompt

    if family not in ("ctc", "joint", "whisper"):
        raise ValueError(f"unknown model family {family!r}")
    out = {
        "audio": torch.from_numpy(batch.audio).to(device),
        "audio_lengths": torch.from_numpy(batch.audio_lengths).to(device),
        "labels": torch.from_numpy(batch.labels).to(device),
        "label_lengths": torch.from_numpy(batch.label_lengths).to(device),
    }
    if family == "ctc":
        return out
    if family == "joint":
        eot = 0 if eot_id is None else eot_id
        prompt = list(whisper_prompt if whisper_prompt is not None else (eot,))
    else:
        eot = EOT if eot_id is None else eot_id
        prompt = list(whisper_prompt if whisper_prompt is not None else default_prompt())
    B, S = batch.labels.shape
    P = len(prompt)
    toks = np.full((B, P + S + 1), eot, np.int32)
    tgts = np.full((B, P + S + 1), -100, np.int32)
    toks[:, :P] = prompt
    for i in range(B):
        n = batch.label_lengths[i]
        toks[i, P:P + n] = batch.labels[i, :n]
        tgts[i, P - 1:P + n - 1] = batch.labels[i, :n]
        tgts[i, P + n - 1] = eot
    out["tokens"] = torch.from_numpy(toks).to(device)
    out["targets"] = torch.from_numpy(tgts).to(device)
    return out


def size_vocab(config: ExperimentConfig, n: int) -> None:
    """Size the family's vocabulary to a tokenizer of `n` ids: the CTC head;
    the joint family's two heads (one vocabulary; the blank doubles as
    sos/eos); Whisper's with room for its specials past the tokenizer's ids
    (vocab max(n + 8, 16), prompt (n,), EOT n + 1), as the JAX package
    sizes it."""
    if config.model_family == "ctc":
        config.ctc_model.vocab_size = n
    elif config.model_family == "joint":
        config.joint.vocab_size = n
    elif config.model_family == "whisper":
        config.whisper.vocab_size = max(n + 8, 16)
        config.whisper.prompt_ids = (n,)
        config.whisper.eot_id = n + 1
    else:
        raise ValueError(f"unknown model family {config.model_family!r}")


def build_tokenizer_for(config: ExperimentConfig, manifest):
    """The config's tokenizer: the byte-level BPE of ``data.tokenizer_dir``
    (HF vocab.json + merges.txt; the model's vocabulary and specials stay
    the config's), else the unigram vocab of ``data.unigram_vocab`` or a
    char vocab over the manifest texts, either of which sizes the model's
    vocabulary (``size_vocab``)."""
    from ..data.tokenizer import CharTokenizer

    if config.data.tokenizer_dir:
        from ..data.bpe import ByteLevelBPE

        return ByteLevelBPE.from_hf_dir(config.data.tokenizer_dir)
    if config.data.unigram_vocab:
        from ..data.unigram import UnigramTokenizer

        tokenizer = UnigramTokenizer.load(config.data.unigram_vocab)
    else:
        tokenizer = CharTokenizer.build(manifest.texts())
    size_vocab(config, len(tokenizer))
    return tokenizer


# ---------------------------------------------------------------------------
# loop
# ---------------------------------------------------------------------------


def step_route(config: ExperimentConfig, device, graph: bool, kernels: bool) -> tuple:
    """-> (capture, why): whether ``train_loop`` captures its steps, by
    rule. Under a process group the step is eager (FSDP2's hooks and
    collectives are not captured); so is the plain path (kernels=False:
    its frontend builds host tables each call), sgd (its update reads the
    learning rate on the host) and graph=False. Otherwise
    ``utils/graphs.capturing``: on a card."""
    from ..utils import graphs

    if mh.is_initialized():
        return False, "eager: under a process group (FSDP2) the step runs eagerly"
    if not graph:
        return False, "eager: graph=False"
    if not kernels:
        return False, "eager: the plain path (kernels=False)"
    if config.train.optimizer.name == "sgd":
        return False, "eager: sgd keeps its learning rate on the host"
    if graphs.capturing(device, True):
        return True, "captured: one CUDA graph a bucket"
    return False, f"eager: no card ({torch.device(device).type})"


def train_loop(config: ExperimentConfig, manifest, tokenizer, model, resume: bool = False,
               checkpoint_dir: Optional[str] = None, logger: Optional[MetricsLogger] = None,
               eval_manifest=None, kernels: bool = True, max_steps: Optional[int] = None,
               graph: bool = True):
    """Train until ``optimizer.total_steps`` micro-steps (or ``max_steps``
    more in this call): host batches from a prefetch thread, per-step
    losses, steps/s every ``log_every_steps``, a checkpoint every
    ``checkpoint_every_steps`` and where the call stops, and on SIGTERM a
    checkpoint and a clean exit. With ``resume``, the newest checkpoint in
    ``checkpoint_dir`` (default ``train.checkpoint_dir``) is restored first,
    so a run whose checkpoint is at ``total_steps`` takes no step. Records
    go to `logger`, or to a ``MetricsLogger`` of ``train.metrics_path`` (and
    ``train.use_wandb``) that this call opens and closes.

    Under a process group the model is split and wrapped in place over the
    mesh of ``config.mesh`` (parallel/mesh.py) and each (data, fsdp) rank
    runs its rows of every batch; without one, a mesh section that asks for ``fsdp_axis`` or
    ``model_axis`` > 1 is noted in one warning and the loop runs on this
    card alone. One process on a card captures each bucket's step as a CUDA
    graph (``TrainStep``) unless ``graph=False`` or a rule of
    ``step_route`` keeps it eager; the primary logs the route in one line
    on stderr. Returns (state, info) with info =
    {"terminated", "last_metrics", "losses", "steps_per_sec", "mesh",
    "graph"}; losses are the global batch's on every process, mesh the
    (data, fsdp, model) shape (None without a process group), graph
    {"route", "captured", "graphs", "replays", "capture_s",
    "replay_launches"}."""
    from ..data.pipeline import BatchIterator, PrefetchIterator
    from ..parallel import mesh as pmesh
    from .checkpoints import TrainCheckpointer

    tc = config.train
    device = next(model.parameters()).device
    mesh = None
    rows_of = {}  # the loader's (data, fsdp) rank and count
    if mh.is_initialized():
        mesh = pmesh.build_mesh_for_batch(config.mesh, config.data.batch_size)
        pmesh.shard_model(mesh, model)
        rows_of = {"process_index": pmesh.dp_rank(mesh),
                   "process_count": mesh.size(0) * mesh.size(1)}
    elif config.mesh.fsdp_axis > 1 or config.mesh.model_axis > 1:
        warnings.warn(
            f"config.mesh asks for fsdp_axis={config.mesh.fsdp_axis}, "
            f"model_axis={config.mesh.model_axis}, but no process group is up: training on one "
            "device; launch `cli train --multihost` under python -m torch.distributed.run "
            "for the mesh", stacklevel=2)
    batch_kw = {"family": config.model_family}
    if config.model_family == "whisper":
        from ..decode.whisper_generate import resolve_specials

        batch_kw["whisper_prompt"], batch_kw["eot_id"] = resolve_specials(config.whisper)
    capture, route = step_route(config, device, graph, kernels)
    state = init_state(config, model)
    it = PrefetchIterator(BatchIterator(manifest, tokenizer, config.data,
                                        sample_rate=config.frontend.sample_rate, **rows_of),
                          depth=max(config.data.num_host_workers, 1))
    ckpt = TrainCheckpointer(checkpoint_dir or tc.checkpoint_dir, tc.keep_checkpoints)
    if resume:
        extra = ckpt.restore(state)
        if extra is not None:
            it.load_state_dict(extra.get("data_iter", it.state_dict()))
    if mesh is None:  # after the restore: the graphs read the restored tensors
        runner = TrainStep(config, state, kernels, graph=capture)
    else:
        step_fn = make_train_step(make_loss_fn(config, model), tc.optimizer)

    own_logger = logger is None and mh.is_primary()
    if not mh.is_primary():
        logger = None
    if own_logger:
        logger = MetricsLogger(tc.metrics_path, use_wandb=tc.use_wandb)
    if mh.is_primary():
        print(f"train_loop: train step {route}", file=sys.stderr, flush=True)
    terminated = {"flag": False}
    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(signal.SIGTERM, lambda *_: terminated.update(flag=True))
    first_step = state.step
    total = tc.optimizer.total_steps
    if max_steps is not None:
        total = min(total, first_step + max_steps)
    losses: List[torch.Tensor] = []
    metrics: Dict[str, Any] = {}
    stop = False
    t_first = t0 = None
    try:
        while state.step < total:
            host = next(it)
            if mesh is None:
                metrics = runner(batch_to_device(host, "cpu", **batch_kw))
            else:
                batch = pmesh.shard_batch(mesh, batch_to_device(host, device, **batch_kw),
                                          host.global_rows)
                metrics = step_fn(state, batch, kernels)
            losses.append(metrics["loss"])
            if t_first is None:  # steps/s counts from the end of the first step
                if device.type == "cuda":
                    torch.cuda.synchronize()
                t_first = t0 = time.perf_counter()
            if state.step % tc.log_every_steps == 0 and logger is not None:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = tc.log_every_steps / max(time.perf_counter() - t0, 1e-9)
                t0 = time.perf_counter()
                logger.log(state.step, **m)
            if (eval_manifest is not None and mh.process_count() == 1
                    and state.step % tc.eval_every_steps == 0):
                scored = pmesh.full_model(model, lambda: make_model(config, device))
                em = evaluate_manifest(config, scored, tokenizer, eval_manifest)
                if logger is not None:
                    logger.log(state.step, **em)
                model.train()
            stop = mh.any_process(terminated["flag"])  # every process stops at one step
            if state.step % tc.checkpoint_every_steps == 0 or state.step == total or stop:
                ckpt.save(state.step, state, {"data_iter": it.state_dict()})
            if stop:
                if logger is not None:
                    logger.log(state.step, event="sigterm_checkpoint_and_exit")
                break
    finally:
        it.close()
        if own_logger:
            logger.close()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
    if mesh is None:
        runner.release()
        if state.step % state.accum == 0:  # no partial sum pending: drop the gradients
            for p in state.trainable():
                p.grad = None
    if device.type == "cuda":
        torch.cuda.synchronize()
    steps = state.step - first_step
    info = {
        "terminated": stop,
        "last_metrics": {k: float(v) for k, v in metrics.items()},
        "losses": [float(x) for x in losses],
        "steps_per_sec": (steps - 1) / (time.perf_counter() - t_first) if steps > 1 else None,
        "mesh": None if mesh is None else list(mesh.shape),
        "graph": {"route": route, **(runner.info() if mesh is None else {"captured": False})},
    }
    state.info = info
    model.eval()
    return state, info


def mix_by_dialect(manifest, dialect_weights):
    """One run's weighted mixture: rows grouped by their dialect tag
    ("default" where it is empty), then ``mix_manifests`` over the groups."""
    from ..data.manifest import Manifest
    from ..data.pipeline import mix_manifests

    groups: Dict[str, list] = {}
    for row in manifest.rows:
        groups.setdefault(row.dialect or "default", []).append(row)
    return mix_manifests({k: Manifest(v) for k, v in groups.items()}, dict(dialect_weights))


def run_experiment(config: ExperimentConfig, resume: bool = False, device="cuda",
                   kernels: bool = True, max_steps: Optional[int] = None, graph: bool = True):
    """The fine-tune run (ctc, joint or whisper family): read the manifest
    (mixed by ``data.dialect_weights`` when set), build the tokenizer
    (``build_tokenizer_for``), init the model from ``train.seed``,
    train (``graph``: train_loop's), and save the bundle (params.npz,
    config.yaml, vocab.json) to
    ``<checkpoint_dir>/final``. ``config.stages`` is not read here: the
    schedule is ``train/schedules.run_stages``. Under a process group the
    bundle holds a plain model with the trained weights on every process
    (``parallel.mesh.full_model``), and the primary saves and evaluates it.
    -> (state, bundle)."""
    from ..data.manifest import read_manifest
    from ..models.bundle import ModelBundle
    from ..parallel.mesh import full_model

    manifest = read_manifest(config.data.train_manifest)
    if config.data.dialect_weights:
        manifest = mix_by_dialect(manifest, config.data.dialect_weights)
    tokenizer = build_tokenizer_for(config, manifest)
    model = make_model(config, device)
    eval_manifest = None
    if config.data.eval_manifest and Path(config.data.eval_manifest).exists():
        eval_manifest = read_manifest(config.data.eval_manifest)
    state, _ = train_loop(config, manifest, tokenizer, model, resume=resume,
                          eval_manifest=eval_manifest, kernels=kernels, max_steps=max_steps,
                          graph=graph)
    model = full_model(model, lambda: make_model(config, device))
    for p in model.parameters():
        p.requires_grad_(False)
    bundle = ModelBundle(config, model, tokenizer)
    if mh.is_primary():
        bundle.save(str(Path(config.train.checkpoint_dir) / "final"))
        if eval_manifest is not None:
            with MetricsLogger(config.train.metrics_path) as logger:
                logger.log(state.step,
                           **evaluate_manifest(config, model, tokenizer, eval_manifest))
    mh.barrier("final_bundle")
    return state, bundle


def evaluate_manifest(config, model, tokenizer, manifest, batch_size: int = 16):
    """Transcribe a manifest with the config's decode strategy -> corpus
    CER / WER."""
    from ..evals.metrics import corpus_cer, corpus_wer
    from ..models.bundle import ModelBundle

    model.eval()
    bundle = ModelBundle(config, model, tokenizer)
    refs, hyps = [], []
    rows = manifest.rows
    for i in range(0, len(rows), batch_size):
        chunk = rows[i : i + batch_size]
        hyps.extend(bundle.transcribe([r.audio for r in chunk]))
        refs.extend(r.text for r in chunk)
    return {"eval_cer": corpus_cer(refs, hyps), "eval_wer": corpus_wer(refs, hyps),
            "eval_utts": len(refs)}
