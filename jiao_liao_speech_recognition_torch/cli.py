"""Command line of the PyTorch port, with the JAX package's ``cli.py``
subcommands, flags and JSON output:

    python -m jiao_liao_speech_recognition_torch.cli prepare table.tsv --out-dir m --cmvn
    python -m jiao_liao_speech_recognition_torch.cli train --config configs/x.yaml [key=value ...]
    python -m torch.distributed.run --nproc-per-node 4 -m jiao_liao_speech_recognition_torch.cli \
        train --multihost --config configs/whisper_large_v3_adapters.yaml [key=value ...]
    python -m jiao_liao_speech_recognition_torch.cli train \
        --config configs/whisper_large_v3_adapters.yaml data.train_manifest=m/train.jsonl \
        data.tokenizer_dir=bpe_dir
    python -m jiao_liao_speech_recognition_torch.cli evaluate --manifest m/test.jsonl \\
        --checkpoint ckpt/final --per-utt per_utt.jsonl
    python -m jiao_liao_speech_recognition_torch.cli serve a.wav b.wav --checkpoint ckpt \\
        --slots 16 [--stdin] [--int8] [--timestamps]
    python -m torch.distributed.run --nproc-per-node 4 -m jiao_liao_speech_recognition_torch.cli \
        serve --multihost --int8 a.wav --config split.yaml   (mesh: model_axis: 4)
    python -m jiao_liao_speech_recognition_torch.cli transcribe a.wav --checkpoint ckpt \\
        --stream [--stream-window 10 --stream-hop 0.4 --stream-lookahead 0.64]
    python -m jiao_liao_speech_recognition_torch.cli transcribe a.wav \\
        --config configs/joint_ctc_attention.yaml --strategy beam --beam-size 8
    python -m jiao_liao_speech_recognition_torch.cli transcribe a.wav --checkpoint ckpt \\
        --strategy beam --beam-size 8 [--lm-path lm.npz --lm-weight 0.5]
    python -m jiao_liao_speech_recognition_torch.cli train-lm m/train.jsonl --output lm.npz
    python -m jiao_liao_speech_recognition_torch.cli train-unigram m/train.jsonl --output u.json
    python -m jiao_liao_speech_recognition_torch.cli export-whisper --checkpoint ckpt/final \
        --out hf_dir
    python -m jiao_liao_speech_recognition_torch.cli build-native

``train`` runs ``config.stages`` through ``train/schedules.run_stages``
(then saves the bundle to ``<checkpoint_dir>/final``), else
``api.fine_tune``. ``train`` and ``transcribe`` take ``--profile LOGDIR``
(a ``torch.profiler`` trace of the run, utils/profiling.py). Audio is
WAV (8/16/24/32-bit PCM or float) or FLAC at any rate, resampled to the
frontend's. Every subcommand that computes takes one flag the JAX CLI
lacks, ``--device`` (default ``cuda``). ``train``, ``transcribe`` and ``serve`` take
``--multihost``: join the process group (parallel/multihost.py:
``torch.distributed.run``'s variables or ``JL_COORDINATOR`` /
``JL_NUM_PROCESSES`` / ``JL_PROCESS_ID``) before any CUDA use, then train
on, or load the bundle split over, the mesh of the config's mesh section
(``mesh.model_axis`` > 1: tensor parallelism, ``--int8`` quantizing the
split bundle); the primary process alone prints and writes. A flag whose
module is not ported yet is refused with exit code 2 and the ROADMAP item
that brings it (none is left).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from pathlib import Path

# flag -> the ROADMAP queue 1 item that ports its module
NOT_PORTED: dict = {}


def refuse(what: str) -> int:
    print(f"error: {what} is not ported yet: ROADMAP {NOT_PORTED[what]}", file=sys.stderr)
    return 2


def refuse_flags(args, *flags: str) -> int | None:
    """-> refuse(flag) for the first of `flags` given on the command line
    (each defaults to None, False or ""), else None."""
    for flag in flags:
        if getattr(args, flag.lstrip("-").replace("-", "_")) not in (None, False, ""):
            return refuse(flag)
    return None


def _load_config(args):
    from .utils.config import ExperimentConfig, apply_overrides, load_yaml

    cfg = load_yaml(args.config) if args.config else ExperimentConfig()
    if args.override:
        cfg = apply_overrides(cfg, args.override)
    return cfg


@contextlib.contextmanager
def _process_group(args, graph_collectives: bool = False):
    """With --multihost, inside the process group (joined before any CUDA
    use, so that a config's mesh shards the model at load) -> whether this
    process is the primary, which alone prints and writes.
    `graph_collectives` for a command that captures NCCL collectives in a
    CUDA graph (multihost.initialize)."""
    from .parallel import multihost

    if args.multihost:
        multihost.initialize(device=args.device, graph_collectives=graph_collectives)
    try:
        yield multihost.is_primary()
    finally:
        if args.multihost:
            multihost.shutdown()


def cmd_train(args) -> int:
    from .utils.profiling import trace

    with _process_group(args) as primary:
        cfg = _load_config(args)
        with trace(args.profile):
            return _train_body(args, cfg, primary)


def _train_body(args, cfg, primary: bool) -> int:
    out = Path(cfg.train.checkpoint_dir) / "final"
    if cfg.stages:
        from .models.bundle import ModelBundle
        from .train.schedules import run_stages

        model, tokenizer, history = run_stages(cfg, resume=args.resume, device=args.device,
                                               graph=args.graph)
        if primary:
            for h in history:
                print(json.dumps(h, ensure_ascii=False))
            ModelBundle(cfg, model.eval(), tokenizer).save(str(out))
            print(f"saved final bundle to {out}")
    else:
        from .api import fine_tune

        state, _ = fine_tune(cfg, resume=args.resume, device=args.device,
                             graph=args.graph)  # saves `out`
        if primary:
            print(f"saved final bundle to {out} (step {int(state.step)})")
    return 0


def _load_bundle(args):
    """-> the bundle, or None after printing why --int8 cannot serve it."""
    from .api import load

    bundle = load(checkpoint=args.checkpoint, config=args.config, device=args.device)
    if args.int8:
        try:
            bundle = bundle.quantize()
        except NotImplementedError as e:
            print(f"error: --int8: {e}", file=sys.stderr)
            return None
    return bundle


def _decode_config(bundle, strategy, beam_size, lm_path, lm_weight):
    """The bundle's DecodeConfig with the command line's choices."""
    cfg = bundle.config.decode
    return dataclasses.replace(
        cfg, strategy=strategy or cfg.strategy,
        beam_size=cfg.beam_size if beam_size is None else beam_size,
        lm_path=lm_path or cfg.lm_path, lm_weight=cfg.lm_weight if lm_weight is None else lm_weight)


def cmd_transcribe(args) -> int:
    from .utils.profiling import trace

    # a split model's decode loops are captured with their collectives
    with _process_group(args, graph_collectives=True) as primary:
        bundle = _load_bundle(args)
        if bundle is None:
            return 2
        with trace(args.profile):
            return _transcribe_body(bundle, args, primary)


def _transcribe_body(bundle, args, primary: bool = True) -> int:
    """Every process computes; the primary alone prints and writes."""
    from .api import transcribe
    from .utils.captions import format_srt, format_vtt, group_cues, group_words

    decode_cfg = _decode_config(bundle, args.strategy, args.beam_size, args.lm_path,
                                args.lm_weight)
    if args.stream:
        return _transcribe_streaming(bundle, args, primary)

    def say(rec) -> None:
        if primary:
            print(json.dumps(rec, ensure_ascii=False))

    if args.caption:
        fmt = format_srt if args.caption == "srt" else format_vtt
        for path, toks in zip(args.audio, bundle.transcribe_timed(args.audio)):
            units = [{"token": w["word"], "start": w["start"], "end": w["end"]}
                     for w in group_words(toks)]
            out_path = os.path.splitext(path)[0] + "." + args.caption
            if primary:
                with open(out_path, "w", encoding="utf-8") as f:
                    f.write(fmt(group_cues(units)))
            say({"audio": path, "caption": out_path, "text": "".join(t["token"] for t in toks)})
        return 0
    if args.timestamps:
        for path, toks in zip(args.audio, bundle.transcribe_timed(args.audio)):
            say({"audio": path, "text": "".join(t["token"] for t in toks), "tokens": toks,
                 "words": group_words(toks)})
        return 0
    for path, text in zip(args.audio, transcribe(bundle, args.audio, decode_cfg=decode_cfg)):
        say({"audio": path, "text": text})
    return 0


def _transcribe_streaming(bundle, args, primary: bool = True) -> int:
    """A live stream simulated: each file fed hop by hop through the
    sliding-window transcriber (serve/streaming.py), one JSON line a hop
    (committed text and the unstable preview), then a final line a file.
    On a split bundle every process feeds the same hops; the primary
    alone prints."""
    from .serve.streaming import StreamingConfig, StreamingTranscriber

    sc = StreamingConfig(window_seconds=args.stream_window, hop_seconds=args.stream_hop,
                         lookahead_seconds=args.stream_lookahead)
    sr = bundle.config.frontend.sample_rate
    for path in args.audio:
        pcm = bundle._collect_audio(path, None)[0]
        st = StreamingTranscriber(bundle, sc)
        hop = int(sc.hop_seconds * sr)
        for s in range(0, len(pcm), hop):
            res = st.feed(pcm[s:s + hop])
            if primary:
                print(json.dumps({"audio": path, "t": round((s + hop) / sr, 2),
                                  "partial": res.text, "preview": res.preview},
                                 ensure_ascii=False), flush=True)
        text = st.finish().text
        if primary:
            print(json.dumps({"audio": path, "text": text}, ensure_ascii=False))
    return 0


def cmd_serve(args) -> int:
    """Continuous-batching transcription (serve/engine.py) of audio paths
    from argv and, with --stdin, one a line from standard input: one JSONL
    line a request in completion order (short utterances come back while
    long ones still decode), the stats on standard error."""
    with _process_group(args, graph_collectives=True) as primary:
        bundle = _load_bundle(args)
        if bundle is None:
            return 2
        return _serve_body(bundle, args, primary)


def _stdin_paths(multihost: bool):
    """Audio paths from standard input, one a line; under a process group
    the primary reads them and every process takes each line in turn."""
    from .parallel import multihost as mh

    while True:
        line = sys.stdin.readline() if mh.is_primary() else None
        if multihost:
            line = mh.broadcast_object(line)
        if not line:
            return
        if line.strip():
            yield line.strip()


def _serve_body(bundle, args, primary: bool) -> int:
    """Every process serves the same requests (a split model's ranks step
    together); the primary alone prints."""
    from .serve import ServingEngine
    from .utils.captions import group_words

    try:
        eng = ServingEngine(bundle, slots=args.slots, steps_per_dispatch=args.steps_per_dispatch,
                            timestamps=args.timestamps)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    paths = {}

    def emit(reqs):
        for r in reqs:
            rec = {"audio": paths[r.rid], "text": r.text,
                   "latency_s": round(r.finished_at - r.submitted_at, 4)}
            if r.timed is not None:
                rec["tokens"] = r.timed
                rec["words"] = group_words(r.timed)
            if primary:
                print(json.dumps(rec, ensure_ascii=False), flush=True)

    def feed(path):
        paths[eng.submit(path)] = path
        while eng.in_flight > eng.slots:  # every lane busy: decode rather than queue
            emit(eng.step())

    for a in args.audio:
        feed(a)
    if args.stdin:
        for path in _stdin_paths(args.multihost):
            feed(path)
    while eng.in_flight:
        emit(eng.step())
    s = eng.stats
    if primary:
        print(f"served {s.completed} utterances in {s.dispatches} dispatches ({s.decode_steps} "
              f"decode steps); latency mean {s.mean_latency_s:.3f}s p95 "
              f"{s.p95_latency_s:.3f}s", file=sys.stderr)
    return 0


def cmd_evaluate(args) -> int:
    from .data.manifest import read_manifest
    from .evals.metrics import cer, corpus_cer, corpus_wer, wer

    bundle = _load_bundle(args)
    if bundle is None:
        return 2
    decode_cfg = _decode_config(bundle, args.decode, args.beam_size, args.lm_path, args.lm_weight)
    rows = read_manifest(args.manifest).rows
    refs, hyps = [], []
    for i in range(0, len(rows), args.batch_size):
        chunk = rows[i : i + args.batch_size]
        hyps.extend(bundle.transcribe([r.audio for r in chunk], decode_cfg=decode_cfg))
        refs.extend(r.text for r in chunk)
    result = {"cer": corpus_cer(refs, hyps), "wer": corpus_wer(refs, hyps),
              "utterances": len(refs)}
    if args.per_utt:
        with open(args.per_utt, "w", encoding="utf-8") as f:
            for row, ref, hyp in zip(rows, refs, hyps):
                f.write(json.dumps({
                    "audio": row.audio, "dialect": row.dialect, "ref": ref, "hyp": hyp,
                    "cer": round(cer(ref, hyp), 4), "wer": round(wer(ref, hyp), 4),
                }, ensure_ascii=False) + "\n")
        result["per_utt"] = args.per_utt
    print(json.dumps(result, ensure_ascii=False))
    return 0


def cmd_featurize(args) -> int:
    import numpy as np

    from .api import featurize

    feats = featurize(args.audio, device=args.device).cpu().numpy()
    out = args.output or (args.audio + ".logmel.npy")
    np.save(out, feats)
    print(f"wrote {out} shape={tuple(feats.shape)}")
    return 0


def cmd_prepare(args) -> int:
    """Transcript table -> filtered, split manifests; with --cmvn, global
    CMVN stats over the train split (featurized on --device)."""
    from .data.prepare import prepare_corpus

    paths = prepare_corpus(
        args.table, args.out_dir, audio_root=args.audio_root, dialect=args.dialect,
        min_seconds=args.min_seconds, max_seconds=args.max_seconds,
        dev_fraction=args.dev_fraction, test_fraction=args.test_fraction, seed=args.seed,
    )
    result = dict(paths)
    if args.cmvn:
        from .data.manifest import read_manifest
        from .data.tokenizer import CharTokenizer
        from .frontend.cmvn import compute_corpus_cmvn
        from .utils.config import DataConfig, FrontendConfig

        manifest = read_manifest(paths["train"])
        acc = compute_corpus_cmvn(
            manifest, CharTokenizer.build(manifest.texts()),
            DataConfig(batch_size=8, min_audio_seconds=args.min_seconds),
            FrontendConfig(num_mels=args.num_mels), device=args.device)
        stats_path = str(Path(args.out_dir) / f"{args.dialect or 'corpus'}_cmvn.npz")
        acc.save(stats_path)
        result["cmvn_stats"] = stats_path
    print(json.dumps(result, ensure_ascii=False))
    return 0


def cmd_train_lm(args) -> int:
    """A char n-gram LM over manifest transcripts for shallow fusion
    (decode/lm.py), its tokenizer from --checkpoint (the acoustic model's
    vocabulary) or built from the manifests."""
    from .data.manifest import read_manifest
    from .data.tokenizer import CharTokenizer
    from .decode.lm import NGramCharLM

    texts = []
    for m in args.manifest:
        texts.extend(read_manifest(m).texts())
    if args.checkpoint:
        from .models.bundle import load_tokenizer

        tokenizer = load_tokenizer(Path(args.checkpoint))
    else:
        tokenizer = CharTokenizer.build(texts)
    lm = NGramCharLM.train_from_texts(texts, tokenizer, order=args.order)
    lm.save(args.output)
    print(json.dumps({"lm": args.output, "order": args.order, "vocab": lm.vocab_size,
                      "ngrams": len(lm.counts), "texts": len(texts)}))
    return 0


def cmd_train_unigram(args) -> int:
    """EM-train a unigram subword vocab over manifest transcripts
    (data/unigram.py); ``data.unigram_vocab`` pointed at the output trains
    with it."""
    from .data.manifest import read_manifest
    from .data.unigram import UnigramTokenizer

    texts = []
    for m in args.manifest:
        texts.extend(read_manifest(m).texts())
    tok = UnigramTokenizer.train(texts, vocab_size=args.vocab_size,
                                 max_piece_len=args.max_piece_len)
    tok.save(args.output)
    if args.sp_vocab:
        tok.save_sp_vocab(args.sp_vocab)
    print(json.dumps({"unigram_vocab": args.output, "vocab": len(tok), "texts": len(texts),
                      "multi_char_pieces": sum(1 for p in tok.vocab[2:] if len(p) > 1)}))
    return 0


def cmd_import_whisper(args) -> int:
    from .models.whisper_import import import_hf_checkpoint

    bundle = import_hf_checkpoint(args.src, args.out, device=args.device)
    w = bundle.config.whisper
    print(json.dumps({
        "out": args.out, "name": w.name, "d_model": w.d_model,
        "layers": [w.encoder_layers, w.decoder_layers],
        "num_mels": w.num_mels, "vocab_size": w.vocab_size,
        "tokenizer": type(bundle.tokenizer).__name__ if bundle.tokenizer else None,
    }))
    return 0


def cmd_export_whisper(args) -> int:
    """A whisper-family bundle -> an HF checkpoint directory
    (models/whisper_import.export_hf_checkpoint)."""
    from .api import load
    from .models.whisper_import import export_hf_checkpoint

    bundle = load(checkpoint=args.checkpoint, config=args.config, device=args.device)
    if bundle.config.model_family != "whisper":
        print("export-whisper needs a whisper-family bundle", file=sys.stderr)
        return 1
    out = export_hf_checkpoint(bundle, args.out)
    print(json.dumps({"out": str(out)}))
    return 0


def cmd_build_native(args) -> int:
    """Build the C++ host libraries (native/beam.cpp, wavio.cpp,
    flacio.cpp) and load them."""
    from .utils.native_ext import load_beam, load_flacio, load_wavio

    try:
        for load in (load_beam, load_wavio, load_flacio):
            load()
        ok = True
    except RuntimeError as e:
        print(e, file=sys.stderr)
        ok = False
    print("native build:", "ok" if ok else "FAILED")
    return 0 if ok else 1


def _device(p) -> None:
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def _multihost(p, what: str) -> None:
    p.add_argument("--multihost", action="store_true",
                   help=f"join the process group before {what} (one process per card; launch "
                   "under python -m torch.distributed.run, or set JL_COORDINATOR / "
                   "JL_NUM_PROCESSES / JL_PROCESS_ID); the config's mesh section splits "
                   "the model")


def build_parser() -> argparse.ArgumentParser:
    from .utils.config import STRATEGIES

    p = argparse.ArgumentParser(prog="jiao_liao_speech_recognition_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="(adapter) fine-tune / multi-dialect stages")
    pt.add_argument("--config", required=True)
    pt.add_argument("--resume", action="store_true")
    pt.add_argument("--profile", metavar="LOGDIR", help="write a torch.profiler trace")
    pt.add_argument("--no-graph", dest="graph", action="store_false",
                    help="run every train step eagerly (default on one card: each bucket's step "
                    "captured once as a CUDA graph and replayed)")
    _multihost(pt, "training")
    pt.add_argument("override", nargs="*", help="key.subkey=value overrides")
    _device(pt)
    pt.set_defaults(fn=cmd_train)

    pr = sub.add_parser("transcribe", help="audio file(s) -> text")
    pr.add_argument("audio", nargs="+")
    pr.add_argument("--checkpoint")
    pr.add_argument("--config")
    pr.add_argument("--profile", metavar="LOGDIR", help="write a torch.profiler trace")
    pr.add_argument("--strategy", choices=STRATEGIES,
                    help="decode strategy override (default: the bundle's config)")
    pr.add_argument("--beam-size", type=int, default=None)
    pr.add_argument("--lm-path", default="",
                    help="n-gram LM .npz for a beam's shallow fusion (ctc beam; the AR beam of "
                    "whisper and joint)")
    pr.add_argument("--lm-weight", type=float, default=None)
    pr.add_argument("--int8", action="store_true",
                    help="int8-quantize the decoder weights before serving (whisper)")
    pr.add_argument("--timestamps", action="store_true",
                    help="emit per-token and word start/end seconds")
    pr.add_argument("--caption", choices=["srt", "vtt"],
                    help="write a subtitle sidecar file next to each audio file")
    pr.add_argument("--stream", action="store_true",
                    help="simulate live streaming: sliding-window greedy CTC with partial "
                    "results a hop (serve/streaming.py; ctc family, joint's CTC branch)")
    pr.add_argument("--stream-window", type=float, default=10.0,
                    help="streaming window seconds (default 10)")
    pr.add_argument("--stream-hop", type=float, default=0.4,
                    help="streaming hop seconds (default 0.4)")
    pr.add_argument("--stream-lookahead", type=float, default=0.64,
                    help="right context before a frame commits (default 0.64)")
    _multihost(pr, "transcribing")
    _device(pr)
    pr.set_defaults(fn=cmd_transcribe)

    pe = sub.add_parser("evaluate", help="CER/WER on a manifest")
    pe.add_argument("--manifest", required=True)
    pe.add_argument("--checkpoint")
    pe.add_argument("--config")
    pe.add_argument("--batch-size", type=int, default=16)
    pe.add_argument("--decode", default="greedy",
                    choices=["greedy", "beam", "beam_device", "ctc_greedy"])
    pe.add_argument("--beam-size", type=int, default=8)
    pe.add_argument("--lm-path", default="", help="n-gram LM .npz for shallow fusion")
    pe.add_argument("--lm-weight", type=float, default=None)
    pe.add_argument("--int8", action="store_true",
                    help="evaluate the int8-quantized serving bundle (whisper)")
    pe.add_argument("--per-utt", metavar="OUT.jsonl",
                    help="also write one row per utterance (audio, dialect, ref, hyp, cer, wer)")
    _device(pe)
    pe.set_defaults(fn=cmd_evaluate)

    ps = sub.add_parser("serve", help="continuous-batching transcription service (whisper): "
                        "audio paths from argv/stdin -> JSONL in completion order")
    ps.add_argument("audio", nargs="*", help="audio paths to serve at once")
    ps.add_argument("--checkpoint")
    ps.add_argument("--config")
    ps.add_argument("--stdin", action="store_true",
                    help="also read audio paths from stdin, one a line")
    ps.add_argument("--slots", type=int, default=8, help="decode lanes")
    ps.add_argument("--steps-per-dispatch", type=int, default=32,
                    help="decode steps between two harvests")
    ps.add_argument("--int8", action="store_true",
                    help="int8-quantize the decoder weights before serving")
    ps.add_argument("--timestamps", action="store_true",
                    help="per-token and word spans in each result (alignment at harvest)")
    _multihost(ps, "serving")
    _device(ps)
    ps.set_defaults(fn=cmd_serve)

    pl = sub.add_parser("train-lm", help="char n-gram LM over manifests (fusion)")
    pl.add_argument("manifest", nargs="+")
    pl.add_argument("--output", required=True)
    pl.add_argument("--order", type=int, default=3)
    pl.add_argument("--checkpoint", help="take the tokenizer from this bundle")
    pl.set_defaults(fn=cmd_train_lm)

    pu = sub.add_parser("train-unigram", help="EM-train a unigram subword vocab")
    pu.add_argument("manifest", nargs="+")
    pu.add_argument("--output", required=True)
    pu.add_argument("--vocab-size", type=int, default=1024)
    pu.add_argument("--max-piece-len", type=int, default=4)
    pu.add_argument("--sp-vocab", help="also write the spm_export_vocab TSV here")
    pu.set_defaults(fn=cmd_train_unigram)

    pi = sub.add_parser("import-whisper",
                        help="HF Whisper checkpoint dir (safetensors) -> bundle checkpoint")
    pi.add_argument("src", help="HF dir: model.safetensors + config.json [+ tokenizer]")
    pi.add_argument("--out", required=True, help="bundle checkpoint dir to write")
    _device(pi)
    pi.set_defaults(fn=cmd_import_whisper)

    px = sub.add_parser("export-whisper",
                        help="whisper bundle checkpoint -> HF dir (from_pretrained-able)")
    px.add_argument("--checkpoint", required=True)
    px.add_argument("--config")
    px.add_argument("--out", required=True, help="HF checkpoint dir to write")
    _device(px)
    px.set_defaults(fn=cmd_export_whisper)

    pn = sub.add_parser("build-native",
                        help="build the C++ host libraries (CTC beam, WAV and FLAC decoders)")
    pn.set_defaults(fn=cmd_build_native)

    pf = sub.add_parser("featurize", help="audio -> log-mel .npy")
    pf.add_argument("audio")
    pf.add_argument("--output")
    _device(pf)
    pf.set_defaults(fn=cmd_featurize)

    pp = sub.add_parser("prepare", help="transcript table -> train/dev/test manifests")
    pp.add_argument("table", help="TSV/CSV of (audio_path, transcript) rows")
    pp.add_argument("--out-dir", required=True)
    pp.add_argument("--audio-root", default="")
    pp.add_argument("--dialect", default="")
    pp.add_argument("--min-seconds", type=float, default=0.3)
    pp.add_argument("--max-seconds", type=float, default=30.0)
    pp.add_argument("--dev-fraction", type=float, default=0.05)
    pp.add_argument("--test-fraction", type=float, default=0.05)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--cmvn", action="store_true",
                    help="also compute global-CMVN stats over the train split")
    pp.add_argument("--num-mels", type=int, default=80)
    _device(pp)
    pp.set_defaults(fn=cmd_prepare)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
