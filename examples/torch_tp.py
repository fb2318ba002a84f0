#!/usr/bin/env python3
"""Tensor parallelism on four cards, held to one card.

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 examples/torch_tp.py \\
        [--part serve|train|ctc|loops|all] [--steps 3] [--rate-steps 4] [--out tp.json]

Under the process group (``parallel/multihost.initialize``, NCCL):

1. serving Whisper large-v3 (random init, seed 0, bf16) through the
   normal entry points: ``api.load`` of a config whose mesh asks for data
   2 x model 2, then model 4 (``ModelBundle.load`` shards it,
   ``ModelBundle.shard``), and ``api.transcribe`` of chip_smoke's six
   requests and of B=16 seeded 30 s chunks (each data rank its 8 at data
   2); the encoder seconds of the B=16 batch, decode ms a step over
   TIMED_STEPS greedy steps and tokens/s, each card's peak memory, and on
   rank 0 one profiled encoder call and decode step (the all-reduce's share
   of the device time: NCCL's kernels); then ``ServingEngine`` on the split
   bundle, bf16 and ``quantize()``d (ENGINE_SLOTS lanes, the B=16 chunks in
   one wave, ENGINE_STEPS steps a dispatch, ENGINE_MAX_LEN tokens): its
   decode step captured with the NCCL all-reduces and the vocab all-gather
   inside (a capture that fails raises: the run exits 1, nothing replays
   eagerly in its place), one dispatch replayed against the same dispatch
   stepped eagerly from the same state (every rank: tokens, positions,
   done flags and caches bitwise), ms a step of each, tokens/s over the
   whole drain, each card's peak and on rank 0 a profiled replay (NCCL's
   share of its device time);
2. training: configs/whisper_large_v3_adapters.yaml at fsdp 2 x model 2
   and configs/adapter_finetune.yaml (the flagship, dropout off) at data 2
   x model 2, ``--steps`` steps of B=16 x 30 s from chip_smoke's seeded
   corpora, each card's peak, and large-v3's steps/s over ``--rate-steps``
   more steps with a profiled step's idle share (examples/torch_multigpu.py);
3. the offline decode loops (``--part loops``, not in ``all``): on the
   split bundles of both meshes, Whisper large-v3 greedy, temperature
   sampling and the beam, the joint config's greedy, beam and spec_greedy,
   and the flagship's device CTC beam, each captured (its collectives in
   the graph) against the same call with graph=False on every rank,
   bitwise, with both routes' ms a step (``loops_measure``);
4. the CTC and joint paths (``--part ctc``, not in ``all``): the flagship
   (CTCModelConfig's widths and depth) and configs/joint_ctc_attention.yaml
   (random init, seed 0) loaded split by ``api.load`` at data 2 x model 2,
   then model 4: a StreamingPool of POOL_SLOTS slots (10 s windows, 0.4 s
   hops, 0.64 s lookahead) whose ring step is captured with the NCCL
   all-reduces inside, driven in lockstep with a pool stepping eagerly
   over chip_smoke's staggered streams (every step's ring and output
   bitwise the eager pool's on every rank; a capture that fails raises and
   the run exits 1), the ring step's ms replayed and eager and NCCL's share
   of a replay (rank 0 profiled); the BEAM_B x 30 s beam-8 batch through
   ``transcribe`` (the device beam and the native engine, seconds, each
   data rank its rows); the joint greedy's ms a decode step on B=16 30 s
   chunks (each data rank its rows); then the joint config trained at fsdp
   2 x model 2 (dropout off: its masks are drawn per data rank), ``--steps``
   steps, its steps/s and idle share over ``--rate-steps`` more, each
   card's peak.

Then the group ends and rank 0 alone runs everything on one card: the
one-card bundle's encoder output on the same B=16 batch (each sharded
run's within ENC_REL_BAR, relative L2) and its decoder's logits over each
sharded run's tokens (the margin rule: no clear argmax may differ), the
same timings, and its own engines (bf16 and int8, captured) timed the same
way, the split engines' tokens held to its decoders by the margin rule; both training configs in one process on the same batches
(losses within FLAGSHIP_REL_BAR / WHISPER_REL_BAR), and large-v3's
four-process checkpoint restored in this process (torch_multigpu's
restore check); with ``--part ctc`` the same CTC and joint readings on one
card (its own pool captured against eager), and the joint config trained in
one process on the same batches (losses within FLAGSHIP_REL_BAR). One JSON
line a case, then a summary; exits 1 when a bar
fails. Needs CUDA cards, one per process; ``--tiny --device cpu`` runs the
same flow at tiny widths on gloo (a rehearsal, no bars on timing).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

import chip_smoke  # noqa: E402
import torch_multigpu as mg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.manifest import read_manifest  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.serve.engine import ServingEngine  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import MeshConfig  # noqa: E402

SERVE_MESHES = {"data2_model2": dict(data_axis=2, model_axis=2), "model4": dict(model_axis=4)}
BATCH = 16
TIMED_STEPS = chip_smoke.WHISPER_TIMED_LEN
ENC_ITERS = 3
# the engine as chip_smoke's phase 12 serves large-v3 on one card
ENGINE_SLOTS, ENGINE_STEPS, ENGINE_MAX_LEN = 16, 32, chip_smoke.WHISPER_MAX_LEN
TINY_WHISPER = dict(d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4, mlp_dim=128,
                    vocab_size=64, max_source_positions=50, max_target_positions=40,
                    dtype="float32", prompt_ids=(1, 2), eot_id=0, suppress_ids=(),
                    begin_suppress_ids=())
TINY_FLAG = ["ctc_model.d_model=64", "ctc_model.num_layers=2", "ctc_model.num_heads=4",
             "ctc_model.mlp_dim=128", "ctc_model.conv_channels=32", "ctc_model.dtype=float32",
             "frontend.chunk_seconds=1.0", "data.batch_size=8", "data.max_audio_seconds=1.0",
             "data.min_audio_seconds=0.1", "data.bucket_boundaries_seconds=[1.0]",
             "data.num_host_workers=1", "data.max_text_len=8"]
TINY_LARGE = ["whisper.d_model=64", "whisper.encoder_layers=2", "whisper.decoder_layers=2",
              "whisper.num_heads=4", "whisper.mlp_dim=128", "whisper.max_target_positions=24",
              "whisper.vocab_size=272", "whisper.prompt_ids=[260,261]", "whisper.eot_id=259",
              "whisper.dtype=float32", "frontend.chunk_seconds=1.0", "data.batch_size=8",
              "data.max_audio_seconds=1.0", "data.min_audio_seconds=0.1",
              "data.bucket_boundaries_seconds=[1.0]", "data.num_host_workers=1",
              "data.max_text_len=8", "whisper.max_source_positions=50"]


def emit(obj) -> None:
    if mh.is_primary():
        print(json.dumps(obj), flush=True)


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def peak_gb(device: str):
    return torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None


def serve_config(args, mesh=None):
    cfg = chip_smoke.whisper_config()
    if args.tiny:
        cfg.whisper = dataclasses.replace(cfg.whisper, **TINY_WHISPER)
        cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=1.0)
        cfg.decode.max_decode_len = 12
    cfg.mesh = MeshConfig(**(mesh or {}))
    return cfg


def batch_wavs(args):
    """B=16 seeded chunks of tone and noise, a chunk's length each."""
    rng = np.random.RandomState(16)
    secs = 1.0 if args.tiny else 30.0
    t = np.arange(int(secs * chip_smoke.SAMPLE_RATE)) / chip_smoke.SAMPLE_RATE
    return [(0.2 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)
             + 0.05 * rng.randn(len(t))).astype(np.float32) for _ in range(BATCH)]


def all_reduce_share(prof) -> dict:
    """Device ms of NCCL's kernels and of every kernel in a profile."""
    total = nccl = 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total and \
                not getattr(e, "is_user_annotation", False):
            total += e.device_time_total / 1e3
            nccl += e.device_time_total / 1e3 if "nccl" in e.key.lower() else 0.0
    return {"device_ms": total, "nccl_ms": nccl, "nccl_share": nccl / total if total else None}


def gathered(obj):
    """Every process's `obj`, in rank order (a list of one without a group)."""
    if mh.process_count() == 1:
        return [obj]
    out = [None] * mh.process_count()
    torch.distributed.all_gather_object(out, obj)
    return out


def serve_measure(bundle, args, tag: str, work: Path) -> dict:
    """transcribe of the six requests and of the B=16 batch; this data
    rank's encoder output and ids of the batch written to `work`; encoder
    seconds, decode ms a step, tokens/s, peak memory and on rank 0 the
    profiled encoder call and decode step. Every rank runs the same calls."""
    dev = args.device
    if dev == "cuda":  # the serving peak, apart from load's
        torch.cuda.reset_peak_memory_stats()
    w = bundle.config.whisper
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(w.vocab_size - 2)])
    wavs = batch_wavs(args)
    texts6 = api.transcribe(bundle, chip_smoke.make_requests())
    texts16, (ids, lens) = chip_smoke.with_generated_ids(lambda: api.transcribe(bundle, wavs))
    rows = bundle._rows(BATCH) or slice(0, BATCH)
    model = bundle.model
    with torch.inference_mode():
        feats = featurize_batch(torch.from_numpy(np.stack(wavs)).to(dev), bundle.config.frontend)
        feats = feats[rows]
        enc = model.encode(feats)
        sync(dev)
        mh.barrier()
        t0 = time.perf_counter()
        for _ in range(ENC_ITERS):
            enc = model.encode(feats)
        sync(dev)
        enc_s = (time.perf_counter() - t0) / ENC_ITERS
        prompt, _ = wg.resolve_specials(w)
        tok = torch.full((enc.shape[0], 1), prompt[0], dtype=torch.long, device=dev)
        caches = model.init_cache(enc.shape[0], enc, TIMED_STEPS + 1)
        logits, caches = model.decode_step(tok, 0, enc, caches)
        sync(dev)
        mh.barrier()
        t0 = time.perf_counter()
        for pos in range(1, TIMED_STEPS + 1):
            tok = logits.argmax(-1, keepdim=True)
            logits, caches = model.decode_step(tok, pos, enc, caches)
        sync(dev)
        step_s = (time.perf_counter() - t0) / TIMED_STEPS
        del caches
        prof = None
        if dev == "cuda":
            from torch.profiler import ProfilerActivity, profile

            caches = model.init_cache(enc.shape[0], enc, 2)
            if mh.is_primary():
                with profile(activities=[ProfilerActivity.CUDA]) as p_enc:
                    model.encode(feats)
                    sync(dev)
                with profile(activities=[ProfilerActivity.CUDA]) as p_dec:
                    model.decode_step(tok, 0, enc, caches)
                    sync(dev)
                prof = {"encoder": all_reduce_share(p_enc), "decode_step": all_reduce_share(p_dec)}
            else:
                model.encode(feats)
                model.decode_step(tok, 0, enc, caches)
                sync(dev)
            del caches
    if bundle.mesh is None or bundle.mesh.get_coordinate()[2] == 0:
        r = rows.start // max(rows.stop - rows.start, 1)
        torch.save({"enc": enc.cpu(), "ids": ids.cpu(), "lens": lens.cpu()},
                   work / f"serve_{tag}_{r}.pt")
    peaks = gathered(peak_gb(dev))
    mh.barrier()
    return {"case": f"serve_{tag}",
            "mesh": None if bundle.mesh is None else list(bundle.mesh.shape),
            "texts6": texts6, "texts16": texts16, "encoder_s_per_batch": enc_s,
            "decode_ms_per_step": step_s * 1e3, "rows_per_rank": enc.shape[0],
            "tokens_per_s": BATCH / step_s, "peak_gb_per_card": peaks, "profile": prof}


def engine_measure(bundle, args, tag: str, work: Path) -> dict:
    """ServingEngine on `bundle`, bf16 then int8: the B=16 chunks in one
    wave; one dispatch replayed from the captured step against the same
    dispatch stepped eagerly (on the card: bitwise on every rank), ms a
    step of each; the drain's tokens/s; each card's peak; on rank 0 a
    profiled replay; each request's ids written to `work` by the primary."""
    from torch.profiler import ProfilerActivity, profile

    dev = args.device
    counters = chip_smoke.load_counters()
    wavs = batch_wavs(args)
    out = {}
    for dtype in ("bf16", "int8"):
        mg.free()
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        b = bundle if dtype == "bf16" else bundle.quantize()
        max_len = 12 if args.tiny else ENGINE_MAX_LEN
        t0 = time.perf_counter()
        eng = ServingEngine(b, slots=ENGINE_SLOTS, steps_per_dispatch=ENGINE_STEPS,
                            max_len=max_len)
        build_s = time.perf_counter() - t0
        rids = [eng.submit(w, admit=False) for w in wavs]
        eng._fill_free_slots()  # one admission wave: every lane
        rec = {"capture_s": eng.capture_s, "engine_build_s": build_s,
               "graph": eng._graph is not None, "max_len": max_len}
        if eng._graph is not None:
            cmp, graph_s, eager_s = chip_smoke.graph_against_eager(eng, counters)
            rec.update(graph_ms_per_step=graph_s * 1e3 / ENGINE_STEPS,
                       eager_ms_per_step=eager_s * 1e3 / ENGINE_STEPS,
                       bitwise=cmp["bitwise"], cache_max_ulps=cmp["cache_max_ulps"])
            if mh.is_primary():  # one replay, profiled (the lanes are mid-flight)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    eng._graph.replay()
                    torch.cuda.synchronize()
                rec["replay_profile"] = all_reduce_share(prof)
            else:
                eng._graph.replay()
                torch.cuda.synchronize()
        sync(dev)
        mh.barrier()
        t0 = time.perf_counter()
        steps0 = eng.stats.decode_steps
        done = {}
        while eng.in_flight:
            done.update((r.rid, r) for r in eng.step())
        sync(dev)
        drain_s = time.perf_counter() - t0
        steps = eng.stats.decode_steps - steps0
        ids = [done[r].ids for r in rids]
        rec.update(drain_steps=steps, drain_s=drain_s, ms_per_step_drain=drain_s * 1e3 / steps,
                   tokens_per_s=ENGINE_SLOTS * steps / drain_s, replays=eng.replays,
                   step_launches=sum(eng.step_launches.values()),
                   generated_tokens=sum(len(x) for x in ids),
                   peak_gb_per_card=gathered(peak_gb(dev)))
        bitwise = gathered(rec.get("bitwise"))
        rec["bitwise_every_rank"] = bitwise
        if mh.is_primary():
            torch.save({"ids": ids}, work / f"engine_{tag}_{dtype}.pt")
        out[dtype] = rec
        del eng, b
        mh.barrier()
    return out


def group_serve(args, work: Path) -> dict:
    out = {}
    for tag, mesh in SERVE_MESHES.items():
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bundle = api.load(config=serve_config(args, mesh), device=args.device)
        load_s, load_peak = time.perf_counter() - t0, peak_gb(args.device)
        tp = bundle.model.tp
        assert bundle.mesh is not None and tp.size == mesh["model_axis"], (bundle.mesh, tp)
        rec = serve_measure(bundle, args, tag, work)
        rec.update(load_s=load_s, load_peak_gb_rank0=load_peak,
                   heads_a_rank=bundle.model.encoder.blocks[0].self_attn.num_heads)
        rec["engine"] = engine_measure(bundle, args, tag, work)
        emit(rec)
        out[tag] = rec
        del bundle
        mg.free()
    return out


def train_cases(work: Path, args) -> dict:
    flag = [f"data.train_manifest={work / 'flag' / 'train.jsonl'}", "ctc_model.dropout=0.0",
            "ctc_model.adapter.dropout=0.0", *(TINY_FLAG if args.tiny else [])]
    large = [f"data.train_manifest={work / 'large' / 'train.jsonl'}",
             f"data.tokenizer_dir={work / 'large' / 'bpe'}", *(TINY_LARGE if args.tiny else [])]
    s = args.steps
    return {
        "large_v3_fsdp2_model2": mg.config(mg.LARGE_V3, work, "large_v3_fsdp2_model2", s, *large,
                                           "mesh.fsdp_axis=2", "mesh.model_axis=2"),
        "flagship_data2_model2": mg.config(mg.FLAGSHIP, work, "flagship_data2_model2", s, *flag,
                                           "mesh.fsdp_axis=1", "mesh.model_axis=2"),
        "large_v3_one_card": mg.config(mg.LARGE_V3, work, "large_v3_one_card", s, *large,
                                       "mesh.fsdp_axis=1"),
        "flagship_one_card": mg.config(mg.FLAGSHIP, work, "flagship_one_card", s, *flag,
                                       "mesh.fsdp_axis=1"),
    }


def train(cfg, device: str):
    manifest = read_manifest(cfg.data.train_manifest)
    tokenizer = engine.build_tokenizer_for(cfg, manifest)
    model = engine.make_model(cfg, device)
    state, info = engine.train_loop(cfg, manifest, tokenizer, model)
    return state, info, tokenizer, manifest


def train_case(cfg, name: str, args) -> dict:
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, info, tok, manifest = train(cfg, args.device)
    rec = {"case": name, "mesh": info["mesh"], "losses": info["losses"],
           "loop_steps_per_sec": info["steps_per_sec"],
           "seconds_incl_init_and_checkpoint": time.perf_counter() - t0}
    if name.startswith("large") and args.device == "cuda":
        rec.update(mg.rate_and_idle(cfg, state, tok, manifest, args.rate_steps))
    rec["peak_gb_per_card"] = gathered(peak_gb(args.device))
    del state, tok, manifest
    mg.free()
    return rec


def write_corpora(work: Path, args) -> None:
    if not mh.is_primary():
        return
    secs, chars = (1.0, 30) if args.tiny else (30.0, 4334)
    for d, (seed, bpe) in {"flag": (0, None), "large": (51, 52)}.items():
        (work / d).mkdir(parents=True, exist_ok=True)
        manifest = chip_smoke.write_corpus(work / d, n=16, secs=secs, chars=chars, seed=seed)
        if bpe is not None:
            if args.tiny:
                tiny_bpe(work / d / "bpe")
            else:
                chip_smoke.write_bpe_standin(work / d / "bpe", read_manifest(manifest).texts(),
                                             seed=bpe)


def tiny_bpe(d: Path) -> None:
    """A byte-level BPE whose specials sit inside TINY_LARGE's vocabulary:
    the 256 byte symbols, three merges, then <|endoftext|> (259) and the
    prompt (260, 261)."""
    from jiao_liao_speech_recognition_torch.data.bpe import bytes_to_unicode

    d.mkdir(parents=True, exist_ok=True)
    vocab = {s: i for i, s in enumerate(bytes_to_unicode().values())}
    merges = [("ä", "¸"), ("Ġ", "a"), ("e", "r")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    for name in ("<|endoftext|>", "<|startoftranscript|>", "<|zh|>"):
        vocab[name] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
                                  encoding="utf-8")


def one_card_serve(args, work: Path, grouped: dict) -> dict:
    """The one-card bundle: its own measurements, then each sharded run's
    encoder output against its own and its tokens through its decoder."""
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bundle = api.load(config=serve_config(args), device=args.device)
    load_peak = peak_gb(args.device)
    rec = serve_measure(bundle, args, "one_card", work)
    rec["load_peak_gb_rank0"] = load_peak
    rec["engine"] = engine_measure(bundle, args, "one_card", work)
    ref = torch.load(work / "serve_one_card_0.pt")
    model, dev = bundle.model, args.device
    quantized = bundle.quantize()
    prompt, _ = wg.resolve_specials(bundle.config.whisper)
    P = len(prompt)
    checks = {}
    for tag in grouped:
        parts = sorted(work.glob(f"serve_{tag}_*.pt"))
        blobs = [torch.load(p) for p in parts]
        enc = torch.cat([b["enc"] for b in blobs])
        ids = torch.cat([b["ids"] for b in blobs]).to(dev)
        lens = torch.cat([b["lens"] for b in blobs]).to(dev)
        enc_rel = float((enc.float() - ref["enc"].float()).norm() / ref["enc"].float().norm())
        with torch.inference_mode():
            toks = torch.cat([torch.tensor(prompt, device=dev).expand(ids.shape[0], P), ids], 1)
            logits = chip_smoke.forced_logits(model, toks, ref["enc"].to(dev), True)
        coverage, mismatch, scored, agree = chip_smoke.margin_check(logits, toks, lens, P)
        ok = (enc_rel <= chip_smoke.ENC_REL_BAR and mismatch == 0
              and (args.tiny or coverage >= chip_smoke.MIN_COVERAGE))
        checks[f"serve_{tag}"] = {
            "encoder_rel_l2": enc_rel, "encoder_bar": chip_smoke.ENC_REL_BAR,
            "coverage": coverage, "mismatched_positions": mismatch, "positions": scored,
            "agree_all_positions": agree, "texts16_equal": sum(
                a == b for a, b in zip(grouped[tag]["texts16"], rec["texts16"])),
            "texts6_equal": sum(a == b for a, b in zip(grouped[tag]["texts6"], rec["texts6"])),
            "ok": ok}
        for dtype in ("bf16", "int8"):
            checks[f"engine_{tag}_{dtype}"] = engine_check(
                bundle if dtype == "bf16" else quantized, work, tag, dtype, ref["enc"].to(dev),
                grouped[tag]["engine"][dtype], args)
    del bundle
    mg.free()
    return rec, checks


def engine_check(bundle, work: Path, tag: str, dtype: str, enc, rec: dict, args) -> dict:
    """A split engine's tokens through this one card's decoder (the margin
    rule), and its captured dispatch bitwise its eager one on every rank."""
    dev = args.device
    ids = torch.load(work / f"engine_{tag}_{dtype}.pt")["ids"]
    prompt, eot = wg.resolve_specials(bundle.config.whisper)
    P = len(prompt)
    L = rec["max_len"]  # a lane cut at the length holds no EOT to score
    toks = torch.full((len(ids), L), eot, dtype=torch.long, device=dev)
    toks[:, :P] = torch.tensor(prompt, device=dev)
    for i, x in enumerate(ids):
        toks[i, P:P + len(x)] = torch.tensor(x, dtype=torch.long, device=dev)
    lens = torch.tensor([len(x) for x in ids], device=dev)
    with torch.inference_mode():
        logits = chip_smoke.forced_logits(bundle.model, toks, enc, True)
    coverage, mismatch, scored, agree = chip_smoke.margin_check(logits, toks, lens, P)
    bitwise = rec["bitwise_every_rank"]
    ok = mismatch == 0 and (args.tiny or coverage >= chip_smoke.MIN_COVERAGE)
    if dev == "cuda":
        ok = ok and all(b is True for b in bitwise)
    return {"coverage": coverage, "mismatched_positions": mismatch, "positions": scored,
            "agree_all_positions": agree, "bitwise_every_rank": bitwise, "ok": ok}


# --part ctc: the pool's slots and geometry (chip_smoke phase 13's), the
# beam batch (chip_smoke phase 15's B at 30 s, beam 8, top-k 16), the joint
# greedy's batch and timed steps
JOINT = "configs/joint_ctc_attention.yaml"
POOL_SLOTS, POOL_GEOMETRY = chip_smoke.STREAM_SLOTS, chip_smoke.STREAM_GEOMETRY
BEAM_B = chip_smoke.CTC_BEAM_B
TINY_CTC = dict(d_model=64, num_layers=2, num_heads=4, mlp_dim=128, conv_channels=32,
                vocab_size=36, dtype="float32")
TINY_JOINT = dict(d_model=64, num_layers=2, decoder_layers=2, num_heads=4, mlp_dim=128,
                  conv_channels=32, vocab_size=36, dtype="float32", max_target_positions=40)
TINY_JOINT_FLAG = ["joint.d_model=64", "joint.num_layers=2", "joint.decoder_layers=2",
                   "joint.num_heads=4", "joint.mlp_dim=128", "joint.conv_channels=32",
                   "joint.dtype=float32", "frontend.chunk_seconds=1.0", "data.batch_size=8",
                   "data.max_audio_seconds=1.0", "data.min_audio_seconds=0.1",
                   "data.bucket_boundaries_seconds=[1.0]", "data.num_host_workers=1",
                   "data.max_text_len=8"]


def ctc_configs(args, mesh=None):
    """(flagship config, joint config) of --part ctc on `mesh`."""
    from jiao_liao_speech_recognition_torch.utils.config import (CTCModelConfig,
                                                                 ExperimentConfig, load_yaml)

    flag = ExperimentConfig(ctc_model=CTCModelConfig(**(TINY_CTC if args.tiny else {})))
    joint = load_yaml(str(ROOT / JOINT))
    if args.tiny:
        joint.joint = dataclasses.replace(joint.joint, **TINY_JOINT)
    for cfg in (flag, joint):
        cfg.mesh = MeshConfig(**(mesh or {}))
        if args.tiny:
            cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=1.0)
    return flag, joint


def ctc_load(args, mesh=None):
    """The flagship and joint bundles (split when `mesh` asks and a group is
    up), a character a non-special id."""
    out = []
    for cfg in ctc_configs(args, mesh):
        b = api.load(config=cfg, device=args.device)
        V = (cfg.ctc_model if cfg.model_family == "ctc" else cfg.joint).vocab_size
        b.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(V - 2)])
        out.append(b)
    return out


def ctc_measure(flag, joint, args, tag: str) -> dict:
    """--part ctc's readings on one mesh (or one card): the captured pool
    against the eager one in lockstep, the ring step's ms replayed and
    eager with NCCL's share of a replay, the beam batch's seconds by route,
    the joint greedy's ms a decode step. Every rank runs the same calls."""
    from torch.profiler import ProfilerActivity, profile

    from jiao_liao_speech_recognition_torch.serve import StreamingConfig, StreamingPool
    from jiao_liao_speech_recognition_torch.utils.config import DecodeConfig

    dev, fe = args.device, flag.config.frontend
    secs = 1.0 if args.tiny else 30.0
    if args.tiny:
        geometry, count, slots, beam_b = (1.28, 0.32, 0.16), 6, 4, 8
    else:
        geometry, count, slots, beam_b = POOL_GEOMETRY, chip_smoke.STREAM_COUNT, POOL_SLOTS, BEAM_B
    sc = StreamingConfig(*geometry)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    audios = chip_smoke.stream_audio(count, seed=16, secs=(2.0 if args.tiny else None))
    rep, eager = chip_smoke.replay_vs_eager(flag, sc, audios, slots)
    rec = {"case": f"ctc_{tag}", "pool": rep,
           "mesh": None if flag.mesh is None else list(flag.mesh.shape),
           "heads_a_rank": flag.model.blocks[0].self_attn.num_heads}
    rec["pool_bitwise_every_rank"] = gathered(not rep["differ_at_steps"] and rep["texts_equal"])
    pool = StreamingPool(flag, slots=slots, stream_cfg=sc)
    rec["capture_s"], rec["captured"] = pool.capture_s, pool._graph is not None
    if pool._graph is not None:
        with torch.no_grad():
            rec["ring_step_ms_replayed"] = chip_smoke.cuda_ms(pool._graph.replay, 20)
            rec["ring_step_ms_eager"] = chip_smoke.cuda_ms(eager._ring_step, 10)
            if mh.is_primary():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    pool._graph.replay()
                    torch.cuda.synchronize()
                rec["replay_profile"] = all_reduce_share(prof)
            else:
                pool._graph.replay()
                torch.cuda.synchronize()
    del pool, eager
    mg.free()
    rng = np.random.RandomState(15)
    t = np.arange(int(secs * chip_smoke.SAMPLE_RATE)) / chip_smoke.SAMPLE_RATE
    wavs = [(0.2 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)
             + 0.05 * rng.randn(len(t))).astype(np.float32) for _ in range(beam_b)]
    beams = {}
    for route in ("beam_device", "beam"):
        dc = DecodeConfig(strategy=route, beam_size=chip_smoke.CTC_BEAM_K,
                          beam_topk=chip_smoke.CTC_BEAM_TOPK)
        flag.transcribe(wavs[:8], decode_cfg=dc)  # warm
        sync(dev)
        mh.barrier()
        t0 = time.perf_counter()
        texts = flag.transcribe(wavs, decode_cfg=dc)
        sync(dev)
        beams[route] = {"seconds": time.perf_counter() - t0, "rows": beam_b,
                        "texts_nonempty": sum(bool(x) for x in texts)}
    rec["ctc_beam"] = beams
    jw = [wavs[i % beam_b] for i in range(BATCH)]
    rows = joint._rows(BATCH) or slice(0, BATCH)
    model = joint.model
    with torch.inference_mode():
        feats = featurize_batch(torch.from_numpy(np.stack(jw)).to(dev), joint.config.frontend)
        enc, el = model.encode(feats[rows])
        steps = 4 if args.tiny else TIMED_STEPS
        tok = torch.zeros((enc.shape[0], 1), dtype=torch.long, device=dev)
        caches = model.init_cache(enc.shape[0], enc, steps + 1)
        logits, caches = model.decode_step(tok, 0, enc, caches, el)
        sync(dev)
        mh.barrier()
        t0 = time.perf_counter()
        for pos in range(1, steps + 1):
            tok = logits.argmax(-1, keepdim=True)
            logits, caches = model.decode_step(tok, pos, enc, caches, el)
        sync(dev)
        rec["joint_greedy_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
        rec["joint_rows_per_rank"] = enc.shape[0]
        del caches
    rec["peak_gb_per_card"] = gathered(peak_gb(dev))
    mh.barrier()
    return rec


def group_ctc(args) -> dict:
    out = {}
    for tag, mesh in SERVE_MESHES.items():
        flag, joint = ctc_load(args, mesh)
        assert flag.mesh is not None and flag.model.tp.size == mesh["model_axis"], flag.mesh
        assert joint.model.tp.size == mesh["model_axis"]
        out[f"ctc_{tag}"] = ctc_measure(flag, joint, args, tag)
        emit(out[f"ctc_{tag}"])
        del flag, joint
        mg.free()
    return out


# --part loops: the offline decode loops on the serve and ctc parts' split
# bundles, each captured against graph=False on every rank; Whisper's at
# chip_smoke phase 23's lengths, its beam over two rows of four
LOOP_BEAM = (2, 4)
LOOP_TIMED_REPLAYS = 4  # replays of a loop's kept graph timed
LOOP_SAMPLE_T, LOOP_SAMPLE_SEED = chip_smoke.DG_SAMPLE_T, chip_smoke.DG_SAMPLE_SEED


def loops_measure(args, tag: str, mesh) -> dict:
    """Every offline decode loop on `mesh`'s split bundles (large-v3 bf16,
    the joint config, the flagship), each on this data rank's rows of the
    B=16 batch: Whisper greedy, temperature sampling (one seeded generator
    a call) and the beam; the joint greedy, beam and spec_greedy over the
    CTC draft; the device CTC beam. Each through chip_smoke.both_routes: the
    captured call against graph=False, bitwise on this rank (a difference
    is recorded as False, and the run exits 1; on a card every loop must
    also have replayed its graph), with both routes' ms a step (a pass for
    spec) and the kept graph's replays timed a unit (a step, a pass or a
    frame). Every rank runs the same calls."""
    from jiao_liao_speech_recognition_torch.decode import ctc
    from jiao_liao_speech_recognition_torch.decode.speculative import spec_greedy_from_enc

    dev = args.device
    wb = api.load(config=serve_config(args, mesh), device=dev)
    flag, joint = ctc_load(args, mesh)
    w = wb.config.whisper
    prompt, eot = wg.resolve_specials(w)
    sup = dict(suppress_ids=w.suppress_ids, begin_suppress_ids=w.begin_suppress_ids)
    rows = wb._rows(BATCH) or slice(0, BATCH)
    wavs = batch_wavs(args)
    L = 12 if args.tiny else chip_smoke.DG_EAGER_LEN
    JL = 12 if args.tiny else chip_smoke.JOINT_MAX_LEN
    with torch.inference_mode():
        x = torch.from_numpy(np.stack(wavs)).to(dev)
        enc = wb.model.encode(featurize_batch(x, wb.config.frontend)[rows])
        jw, ja, _ = joint._prepare_audio_chunked(wavs, None)
        enc_j, el = joint.model.encode(*joint._features(jw[rows], ja[rows]))
        draft, dlens = ctc.ctc_greedy_collapse(joint.model.ctc_argmax_ids(enc_j), el, 0)
        fw, fa, _ = flag._prepare_audio_chunked(wavs, None)
        lp, olens = flag.encode(*flag._features(fw[rows], fa[rows]))

    def sampled(g):
        gen = torch.Generator(device=dev).manual_seed(LOOP_SAMPLE_SEED)
        return wg.greedy_from_enc(wb.model, enc, None, L, prompt, eot, temperature=LOOP_SAMPLE_T,
                                  generator=gen, graph=g, **sup)

    def spec(g):
        ids, lens, passes = spec_greedy_from_enc(joint.model, enc_j, el, draft, dlens, max_len=JL,
                                                 return_passes=True, graph=g)
        return ids, lens, torch.tensor(passes)

    nb, K = LOOP_BEAM
    loops = {
        "whisper_greedy": lambda g: wg.greedy_from_enc(wb.model, enc, None, L, prompt, eot,
                                                       graph=g, **sup),
        "whisper_sampled": sampled,
        "whisper_beam": lambda g: wg.beam_from_enc(wb.model, enc[:nb], None, K, L, prompt, eot,
                                                   graph=g, **sup),
        "joint_greedy": lambda g: wg.greedy_from_enc(joint.model, enc_j, el, JL, (0,), 0,
                                                     graph=g),
        "joint_beam": lambda g: wg.beam_from_enc(joint.model, enc_j, el, chip_smoke.JOINT_BEAM,
                                                 JL, (0,), 0, graph=g),
        "joint_spec": spec,
        "ctc_beam_device": lambda g: ctc.ctc_prefix_beam_search(
            lp, olens, chip_smoke.CTC_BEAM_K, 0, topk_tokens=16, graph=g)}
    rec = {"case": f"loops_{tag}", "mesh": None if wb.mesh is None else list(wb.mesh.shape),
           "rows_per_rank": enc.shape[0],
           "heads_a_rank": wb.model.decoder.blocks[0].self_attn.num_heads}
    per_replay = {"joint_spec": 1, "ctc_beam_device": ctc.FRAMES_PER_REPLAY}
    for name, fn in loops.items():
        mh.barrier()
        with chip_smoke.KeptGraphs() as kg:
            try:
                r = chip_smoke.both_routes(fn, f"{tag} {name}",
                                           unit="pass" if name == "joint_spec" else "step")
            except AssertionError as e:  # recorded: every rank reaches the gather
                r = {"bitwise_eager": False, "error": str(e)[:500]}
        if kg.kept:  # every rank replays the kept graph alike (its collectives)
            r["replayed_ms_per_unit"] = chip_smoke.cuda_ms(
                kg.kept[-1].graph.replay, LOOP_TIMED_REPLAYS) / per_replay.get(
                    name, wg.STOP_CHECK_EVERY)
        del kg
        rec[name] = {**r, "bitwise_every_rank": gathered(r["bitwise_eager"]),
                     "replayed_every_rank": gathered(r.get("replays", 0) > 0)}
    del wb, flag, joint
    return rec


def group_loops(args) -> dict:
    out = {}
    for tag, mesh in SERVE_MESHES.items():
        out[f"loops_{tag}"] = loops_measure(args, tag, mesh)
        emit(out[f"loops_{tag}"])
        mg.free()
    return out


def joint_train_cases(work: Path, args) -> dict:
    extra = [f"data.train_manifest={work / 'flag' / 'train.jsonl'}", "joint.dropout=0.0",
             *(TINY_JOINT_FLAG if args.tiny else [])]
    return {"joint_fsdp2_model2": mg.config(JOINT, work, "joint_fsdp2_model2", args.steps, *extra,
                                            "mesh.fsdp_axis=2", "mesh.model_axis=2"),
            "joint_one_card": mg.config(JOINT, work, "joint_one_card", args.steps, *extra,
                                        "mesh.fsdp_axis=1")}


def joint_train_case(cfg, name: str, args) -> dict:
    """train_case for the joint config, with its steps/s and idle share."""
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, info, tok, manifest = train(cfg, args.device)
    rec = {"case": name, "mesh": info["mesh"], "losses": info["losses"],
           "loop_steps_per_sec": info["steps_per_sec"],
           "seconds_incl_init_and_checkpoint": time.perf_counter() - t0}
    if args.device == "cuda":
        rec.update(mg.rate_and_idle(cfg, state, tok, manifest, args.rate_steps))
    rec["peak_gb_per_card"] = gathered(peak_gb(args.device))
    del state, tok, manifest
    mg.free()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("serve", "train", "ctc", "loops", "all"), default="all")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rate-steps", type=int, default=4)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "jl_tp"))
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="tiny widths (a CPU rehearsal)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("needs CUDA cards, one per process", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    mh.initialize(device=args.device,
                  graph_collectives=args.part in ("serve", "ctc", "loops", "all"))
    cards = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip().splitlines()
             if args.device == "cuda" else ["cpu"])
    emit({"world": mh.process_count(), "cards": cards, "torch": torch.__version__,
          "part": args.part})
    if args.part == "loops":
        grouped = group_loops(args)
        checks = {tag: {name: r["bitwise_every_rank"] + (
                            r["replayed_every_rank"] if args.device == "cuda" else [])
                        for name, r in rec.items() if isinstance(r, dict)}
                  for tag, rec in grouped.items()}
        ok = all(all(v) for c in checks.values() for v in c.values())
        emit({"checks": checks, "ok": ok})
        if args.out and mh.is_primary():
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"cards": cards, "cases": grouped,
                                                  "checks": checks, "ok": ok}, indent=1))
        mh.shutdown()
        return 0 if ok else 1
    write_corpora(work, args)
    mh.barrier()
    t0 = time.perf_counter()
    grouped = {}
    if args.part in ("serve", "all"):
        grouped.update(group_serve(args, work))
    train_cfgs = train_cases(work, args)
    if args.part in ("train", "all"):
        for name in ("large_v3_fsdp2_model2", "flagship_data2_model2"):
            grouped[name] = train_case(train_cfgs[name], name, args)
            emit(grouped[name])
    joint_cfgs = joint_train_cases(work, args)
    if args.part == "ctc":
        grouped.update(group_ctc(args))
        grouped["joint_fsdp2_model2"] = joint_train_case(joint_cfgs["joint_fsdp2_model2"],
                                                         "joint_fsdp2_model2", args)
        emit(grouped["joint_fsdp2_model2"])
    group_s = time.perf_counter() - t0
    primary = mh.is_primary()
    mh.shutdown()
    if not primary:
        return 0

    summary = {"cards": cards, "group_s": group_s, "cases": grouped, "checks": {}}
    ok = True
    if args.part in ("serve", "all"):
        rec, checks = one_card_serve(args, work, {k: v for k, v in grouped.items()
                                                  if k in SERVE_MESHES})
        print(json.dumps(rec), flush=True)
        summary["cases"]["serve_one_card"] = rec
        summary["checks"].update(checks)
        ok &= all(c["ok"] for c in checks.values())
    if args.part in ("train", "all"):
        for ref_name, name, bar in (
                ("flagship_one_card", "flagship_data2_model2", mg.FLAGSHIP_REL_BAR),
                ("large_v3_one_card", "large_v3_fsdp2_model2", mg.WHISPER_REL_BAR)):
            ref = train_case(train_cfgs[ref_name], ref_name, args)
            print(json.dumps(ref), flush=True)
            summary["cases"][ref_name] = ref
            err = mg.rel(grouped[name]["losses"], ref["losses"])
            good = err <= bar and all(math.isfinite(x) for x in grouped[name]["losses"])
            summary["checks"][name] = {"loss_rel_err": err, "bar": bar, "ok": good}
            ok &= good
        rc = mg.restore_check(work, args.steps, train_cfgs["large_v3_fsdp2_model2"],
                              train_cfgs["large_v3_one_card"], args.device)
        summary["checks"]["large_v3_fsdp2_model2_restored_in_one_process"] = rc
        ok &= rc["ok"]
    if args.part == "ctc":
        flag, joint = ctc_load(args)
        one = ctc_measure(flag, joint, args, "one_card")
        del flag, joint
        mg.free()
        print(json.dumps(one), flush=True)
        summary["cases"]["ctc_one_card"] = one
        for tag in SERVE_MESHES:
            rec = grouped[f"ctc_{tag}"]
            good = (all(b is True for b in rec["pool_bitwise_every_rank"])
                    and (args.device != "cuda" or rec["captured"]))
            summary["checks"][f"ctc_{tag}_pool_captured_bitwise_eager"] = {
                "every_rank": rec["pool_bitwise_every_rank"], "captured": rec["captured"],
                "ok": good}
            ok &= good
        ref = joint_train_case(joint_cfgs["joint_one_card"], "joint_one_card", args)
        print(json.dumps(ref), flush=True)
        summary["cases"]["joint_one_card"] = ref
        got = grouped["joint_fsdp2_model2"]["losses"]
        err = mg.rel(got, ref["losses"])
        good = err <= mg.FLAGSHIP_REL_BAR and all(math.isfinite(x) for x in got)
        summary["checks"]["joint_fsdp2_model2"] = {"loss_rel_err": err,
                                                   "bar": mg.FLAGSHIP_REL_BAR, "ok": good}
        ok &= good
    summary["ok"] = ok
    print(json.dumps(summary["checks"]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
