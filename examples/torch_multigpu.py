#!/usr/bin/env python3
"""The port's training mesh on four cards, held to one card.

    python3 -m torch.distributed.run --nproc-per-node 4 examples/torch_multigpu.py \\
        [--steps 3] [--rate-steps 4] [--out multigpu.json]

Under the process group (``parallel/multihost.initialize``, NCCL), each
case runs ``train_loop`` for ``--steps`` steps of B=16 x 30 s from seeded
corpora (chip_smoke.write_corpus; the large-v3 cases read chip_smoke's BPE
stand-in, random weights from the seed):

1. configs/adapter_finetune.yaml (the flagship: d 512, 12 blocks, WF rank
   8, backbone frozen) at data 4 and at data 2 x fsdp 2, dropout off
   (dropout masks are drawn per process, so they are not
   topology-invariant);
2. configs/whisper_large_v3_adapters.yaml as published (fsdp_axis 4: one
   data shard, parameters and Adam's moments in quarters): each card's
   peak memory, steps/s over ``--rate-steps`` more steps, and the device
   idle share of one profiled step (chip_smoke.device_profile).

Then the group ends and rank 0 alone runs each config in one process on
the same global batches: the flagship's losses must lie within
FLAGSHIP_REL_BAR and large-v3's within WHISPER_REL_BAR (bf16 sums in
another order) of the one-card run's, and large-v3's four-process step
checkpoint, restored in this process without a group, must hold the step,
the backbone bitwise and the adapters' updates within ADAPTER_REL_BAR of
the one-card run's (relative L2 over the set), and take one more step.
The one-card large-v3 run is also timed and profiled as the four-card
one is. One JSON line a case, then a summary; exits 1 when a bar
fails. Needs CUDA cards, one per process.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from jiao_liao_speech_recognition_torch.data.manifest import read_manifest  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import mesh as pmesh  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine  # noqa: E402
from jiao_liao_speech_recognition_torch.train.checkpoints import TrainCheckpointer  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import apply_overrides, load_yaml  # noqa: E402

FLAGSHIP = "configs/adapter_finetune.yaml"
LARGE_V3 = "configs/whisper_large_v3_adapters.yaml"
FLAGSHIP_REL_BAR = 1e-3
WHISPER_REL_BAR = 2e-3
# the adapters' updates after 3 steps on 4 x 4 rows against 16 rows,
# relative L2 over the whole set: Adam's first updates are about lr x the
# sign of each gradient element, and the elements whose bf16 gradient is
# near zero take either sign on either topology (a zero-init B insert's
# worst tensor reads 5-22% on four H100s against one)
ADAPTER_REL_BAR = 0.05


def emit(obj) -> None:
    if mh.is_primary():
        print(json.dumps(obj), flush=True)


def config(path: str, work: Path, name: str, steps: int, *extra):
    cfg = apply_overrides(load_yaml(str(ROOT / path)), [
        f"train.checkpoint_dir={work / name / 'ckpt'}",
        f"train.metrics_path={work / name / 'metrics.jsonl'}",
        f"train.optimizer.total_steps={steps}", "train.log_every_steps=1",
        'data.eval_manifest=""', *extra])
    return cfg


def cases(work: Path, steps: int):
    """name -> (config, manifest path)."""
    flag = [f"data.train_manifest={work / 'flag' / 'train.jsonl'}", "ctc_model.dropout=0.0",
            "ctc_model.adapter.dropout=0.0"]
    large = [f"data.train_manifest={work / 'large' / 'train.jsonl'}",
             f"data.tokenizer_dir={work / 'large' / 'bpe'}"]
    return {
        "flagship_data4": config(FLAGSHIP, work, "flagship_data4", steps, *flag,
                                 "mesh.fsdp_axis=1"),
        "flagship_data2_fsdp2": config(FLAGSHIP, work, "flagship_data2_fsdp2", steps, *flag,
                                       "mesh.fsdp_axis=2"),
        "large_v3_fsdp4": config(LARGE_V3, work, "large_v3_fsdp4", steps, *large),
        "flagship_one_card": config(FLAGSHIP, work, "flagship_one_card", steps, *flag,
                                    "mesh.fsdp_axis=1"),
        "large_v3_one_card": config(LARGE_V3, work, "large_v3_one_card", steps, *large,
                                    "mesh.fsdp_axis=1"),
    }


def train(cfg):
    """train_loop from the seeded init -> (state, info, tokenizer, manifest)."""
    manifest = read_manifest(cfg.data.train_manifest)
    tokenizer = engine.build_tokenizer_for(cfg, manifest)
    model = engine.make_model(cfg, "cuda")
    state, info = engine.train_loop(cfg, manifest, tokenizer, model)
    return state, info, tokenizer, manifest


def host_profile(fn, top: int = 12) -> dict:
    """fn() once under torch.profiler (host side): its wall, the host ops
    with the most self CPU time, and the CPU time inside FSDP's ranges
    ("FSDP::...") and the optimizer's step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    ranges = {}
    for e in ev:
        for tag in ("FSDP::", "Optimizer.step"):
            if e.key.startswith(tag):
                ranges[tag] = ranges.get(tag, 0.0) + e.cpu_time_total / 1e6
    ops = sorted(((e.self_cpu_time_total / 1e6, e.count, e.key[:70]) for e in ev), reverse=True)
    return {"wall_s": wall, "range_cpu_s": ranges, "top_self_cpu_s": ops[:top]}


def rate_and_idle(cfg, state, tokenizer, manifest, rate_steps: int) -> dict:
    """Steps/s over `rate_steps` more steps of `state` (wrapped under a
    process group, plain without one), then on rank 0 one step under
    chip_smoke.device_profile (the idle share) and one under host_profile;
    every rank takes the same steps."""
    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.decode.whisper_generate import resolve_specials

    mesh = (pmesh.build_mesh_for_batch(cfg.mesh, cfg.data.batch_size)
            if mh.is_initialized() else None)
    kw = {"family": cfg.model_family}
    if cfg.model_family == "whisper":
        kw["whisper_prompt"], kw["eot_id"] = resolve_specials(cfg.whisper)
    it = BatchIterator(manifest, tokenizer, cfg.data, sample_rate=cfg.frontend.sample_rate)
    batches = []
    for _ in range(2):
        host = next(it)
        batch = engine.batch_to_device(host, "cuda", **kw)
        batches.append(batch if mesh is None else pmesh.shard_batch(mesh, batch,
                                                                      host.global_rows))
    step = engine.make_train_step(engine.make_loss_fn(cfg, state.model), cfg.train.optimizer)
    step(state, batches[0])
    torch.cuda.synchronize()
    mh.barrier()
    t0 = time.perf_counter()
    for i in range(rate_steps):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prof = hprof = None
    if mh.is_primary():
        prof = chip_smoke.device_profile(lambda i: step(state, batches[i % 2]), 1, "multigpu")
        hprof = host_profile(lambda: step(state, batches[1]))
    else:
        for i in range(2):
            step(state, batches[i])
        torch.cuda.synchronize()
    return {"steps_per_sec": rate_steps / secs, "step_s": secs / rate_steps,
            "profile": prof, "host_profile": hprof}


def free() -> None:
    """Return what the last case left to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def group_runs(work: Path, steps: int, rate_steps: int) -> dict:
    """The three cases under the process group -> {case: record} (rank 0's
    view; per-card peaks gathered from every rank)."""
    out = {}
    for name in ("flagship_data4", "flagship_data2_fsdp2", "large_v3_fsdp4"):
        cfg = cases(work, steps)[name]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, info, tok, manifest = train(cfg)
        rec = {"case": name, "mesh": info["mesh"], "losses": info["losses"],
               "loop_steps_per_sec": info["steps_per_sec"],
               "seconds_incl_init_and_checkpoint": time.perf_counter() - t0}
        if name.startswith("large"):
            rec.update(rate_and_idle(cfg, state, tok, manifest, rate_steps))
        peaks = [None] * mh.process_count()
        torch.distributed.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 1e9)
        rec["peak_gb_per_card"] = peaks
        emit(rec)
        out[name] = rec
        del state, tok, manifest
        free()
    return out


def rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def restore_check(work: Path, steps: int, group_cfg=None, one_cfg=None,
                  device: str = "cuda") -> dict:
    """large-v3's four-process checkpoint (of `group_cfg`'s run, default
    the fsdp 4 case) restored in this process (no group): its step and
    data position, the backbone bitwise the one-card run's (`one_cfg`'s),
    the adapters' updates (trained minus the seeded init) against the
    one-card run's, over the whole set and the worst tensor; then one more
    step from it, whose loss must be finite."""
    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.decode.whisper_generate import resolve_specials
    from jiao_liao_speech_recognition_torch.models.adapters import param_is_adapter

    c = cases(work, steps)
    cfg = one_cfg or c["large_v3_one_card"]
    model = engine.make_model(cfg, device)
    init = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
            if param_is_adapter(k)}
    state = engine.init_state(cfg, model)
    extra = TrainCheckpointer((group_cfg or c["large_v3_fsdp4"]).train.checkpoint_dir).restore(
        state)
    restored = state.step
    ref = torch.load(Path(cfg.train.checkpoint_dir) / f"{steps:08d}" / "state.pt",
                     map_location="cpu", weights_only=False)["model"]
    frozen_same = n_frozen = 0
    diff2 = upd2 = worst = 0.0
    for k, v in model.state_dict().items():
        if param_is_adapter(k):
            mine, theirs = v.cpu() - init[k], ref[k] - init[k]
            d, u = float((mine - theirs).norm()) ** 2, float(theirs.norm()) ** 2
            diff2, upd2 = diff2 + d, upd2 + u
            worst = max(worst, math.sqrt(d / max(u, 1e-30)))
        else:
            n_frozen += 1
            frozen_same += torch.equal(v.cpu(), ref[k])
    del ref, init
    update_rel = math.sqrt(diff2 / max(upd2, 1e-30))
    manifest = read_manifest(cfg.data.train_manifest)
    tok = engine.build_tokenizer_for(cfg, manifest)
    it = BatchIterator(manifest, tok, cfg.data, sample_rate=cfg.frontend.sample_rate)
    it.load_state_dict(extra["data_iter"])
    prompt, eot = resolve_specials(cfg.whisper)
    batch = engine.batch_to_device(next(it), device, family="whisper", whisper_prompt=prompt,
                                   eot_id=eot)
    step = engine.make_train_step(engine.make_loss_fn(cfg, model), cfg.train.optimizer)
    loss = float(step(state, batch)["loss"])
    return {"restored_step": restored,
            "data_iter": extra["data_iter"], "backbone_bitwise": f"{frozen_same}/{n_frozen}",
            "adapter_update_rel_l2": update_rel, "adapter_update_rel_l2_worst_tensor": worst,
            "bar": ADAPTER_REL_BAR, "resumed_step_loss": loss,
            "ok": (restored == steps and frozen_same == n_frozen
                   and update_rel <= ADAPTER_REL_BAR and math.isfinite(loss))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rate-steps", type=int, default=4)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "jl_multigpu"))
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs CUDA cards, one per process", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(args.workdir)
    mh.initialize()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    if mh.is_primary():
        for d, (seed, bpe) in {"flag": (0, None), "large": (51, 52)}.items():
            (work / d).mkdir(parents=True, exist_ok=True)
            manifest = chip_smoke.write_corpus(work / d, n=16, seed=seed)
            if bpe is not None:
                chip_smoke.write_bpe_standin(work / d / "bpe", read_manifest(manifest).texts(),
                                             seed=bpe)
    mh.barrier()
    emit({"world": mh.process_count(), "cards": cards, "torch": torch.__version__})
    t0 = time.perf_counter()
    grouped = group_runs(work, args.steps, args.rate_steps)
    group_s = time.perf_counter() - t0
    primary = mh.is_primary()
    mh.shutdown()
    if not primary:
        return 0

    summary = {"cards": cards, "group_s": group_s, "cases": grouped, "checks": {}}
    ok = True
    for ref_name, group_names, bar in (
            ("flagship_one_card", ("flagship_data4", "flagship_data2_fsdp2"), FLAGSHIP_REL_BAR),
            ("large_v3_one_card", ("large_v3_fsdp4",), WHISPER_REL_BAR)):
        cfg = cases(work, args.steps)[ref_name]
        torch.cuda.reset_peak_memory_stats()
        state, info, tok, manifest = train(cfg)
        ref = {"case": ref_name, "losses": info["losses"],
               "loop_steps_per_sec": info["steps_per_sec"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if ref_name.startswith("large"):
            ref.update(rate_and_idle(cfg, state, tok, manifest, args.rate_steps))
        print(json.dumps(ref), flush=True)
        summary["cases"][ref_name] = ref
        del state, tok, manifest
        free()
        for name in group_names:
            err = rel(grouped[name]["losses"], ref["losses"])
            good = err <= bar and all(math.isfinite(x) for x in grouped[name]["losses"])
            summary["checks"][name] = {"loss_rel_err": err, "bar": bar, "ok": good}
            ok &= good
    rc = restore_check(work, args.steps)
    summary["checks"]["large_v3_fsdp4_restored_in_one_process"] = rc
    ok &= rc["ok"]
    summary["ok"] = ok
    print(json.dumps(summary["checks"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
