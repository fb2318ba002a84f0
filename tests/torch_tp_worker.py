"""One rank of tests/test_torch_tp.py's process group (gloo, world 4): the
port's tensor-parallel paths on the inputs the test wrote to ``--in``,
each rank's results as JSON (and rank 0's tensors as npz) in ``--out``.

    python tests/torch_tp_worker.py --in DIR --out DIR   (under torch_ranks.spawn)

Cases, in order, each on its own mesh of the world:
* step: the Whisper config of tests/test_tp.py, one train step at data 2
  x model 2 from the JAX package's weights; the loss, the updated weights
  (joined), each parameter's and Adam moment's placement;
* greedy: sharded greedy decode (data 2 x model 2; each (data) rank its
  rows of the batch, tokens joined);
* transcribe: ModelBundle.shard + transcribe of the test's WAVs, then save;
* train_loop: tests/test_mesh_train.py's CTC config with WF adapters at
  fsdp 2 x model 2, 4 steps; the losses and the joined weights;
* dropout: a CTC model with dropout 0.1 in training at data 2 x model 2:
  each rank's log-probs, and the one-process model's with the same seed;
* int8: at model 4, ``quantize()`` before and after ``shard()`` (each
  rank's buffers in both orders, the joined int8 decoder on rank 0),
  greedy tokens of the split int8 model, and block 0's fc2 row partials
  summed over the group on a seeded input;
* int8_wf: the test's WF-adapted weights quantized after a data 2 x
  model 2 split: greedy tokens, and the decode steps against the same
  model quantized whole;
* serving at data 2 x model 2: the engine's texts (bf16 and int8), the AR
  beam over JAX's encoder output, ``transcribe_timed``;
* cli_serve: ``cli serve --multihost --int8`` and ``cli transcribe
  --multihost --timestamps`` of the split bundle ``transcribe`` saved
  (its mesh data 2 x model 2), each rank's standard output;
* ctc_split: the test's CTC weights split at data 2 x model 2:
  StreamingTranscriber's state after every feed (and at model 4, and a
  banded model's), StreamingPool's results after every step (the device
  ring, eager on the CPU), and each (data) rank's rows through the three
  CTC prefix beam routes (the device beam, the native engine, the host
  searcher with the test's n-gram LM); then saved (its mesh in its config);
* joint_split: the test's joint weights split at data 2 x model 2: greedy
  (and at model 4), spec_greedy, the AR beam's hypotheses and scores with
  their CTC NLLs, joint_beam's picks, the CTC branch's pool; and
  train_loop at fsdp 2 x model 2 (its losses, the joined weights);
* cli_ctc: ``cli transcribe --multihost --stream`` and ``--strategy beam``
  of the bundle ctc_split saved, each rank's standard output;
* dryrun: the dry run's ``ctc:2x2`` (with a checkpoint), ``whisper:1x2``
  and ``ctc:2x2`` resumed from the one-process checkpoint ``--resume``;
* cli: ``cli train --multihost`` of configs/adapter_finetune.yaml cut to
  tiny widths with ``mesh.model_axis=2`` (it leaves the group at its end).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jiao_liao_speech_recognition_torch import cli  # noqa: E402
from jiao_liao_speech_recognition_torch.data.manifest import read_manifest  # noqa: E402
from jiao_liao_speech_recognition_torch.data.pipeline import Batch  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.whisper_generate import (  # noqa: E402
    beam_from_enc,
    greedy_generate,
)
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import dryrun  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import mesh as pmesh  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.quant import int8_row_product  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel.tp import apply_tp  # noqa: E402
from jiao_liao_speech_recognition_torch.serve.engine import ServingEngine  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as c  # noqa: E402

WHISPER = c.WhisperConfig(vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
                          num_heads=4, mlp_dim=128, max_target_positions=32, dtype="float32",
                          use_flash_attention=False, max_source_positions=64)


def whisper_cfg(**mesh) -> c.ExperimentConfig:
    """tests/test_tp.py's CFG (and its optimizer) in the port's config."""
    cfg = c.ExperimentConfig(model_family="whisper", whisper=dataclasses.replace(WHISPER),
                             specaugment=c.SpecAugmentConfig(enabled=False),
                             mesh=c.MeshConfig(**mesh))
    cfg.train.optimizer = c.OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=5,
                                            schedule="constant")
    return cfg


def whisper_model(src: Path) -> WhisperModel:
    model = WhisperModel(WHISPER)
    model.load_state_dict(convert.whisper_params_to_state_dict(
        convert.read_npz_params(src / "whisper.npz")))
    return model


def gather_rows(obj, mesh):
    """Each (data, fsdp) rank's `obj` (a list), in rank order, on every rank."""
    parts = [None] * mh.process_count()
    torch.distributed.all_gather_object(parts, obj)
    tp = mesh.size(2)
    return [x for r in range(0, len(parts), tp) for x in parts[r]]


def placements(model, optimizer) -> dict:
    """name -> (DTensor shape, placements, local shape) of each parameter,
    and of its Adam moments."""
    out = {}
    for name, p in model.named_parameters():
        rec = {"shape": list(p.shape), "placements": [str(x) for x in p.placements],
               "local": list(p.to_local().shape)}
        st = optimizer.state.get(p, {})
        rec["moments"] = [[list(v.shape), [str(x) for x in v.placements]]
                          for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")]
        out[name] = rec
    return out


def case_step(src: Path, dst: Path) -> dict:
    cfg = whisper_cfg(data_axis=2, model_axis=2)
    model = whisper_model(src)
    mesh = pmesh.build_mesh_for_batch(cfg.mesh, 8)
    pmesh.shard_model(mesh, model)
    state = engine.init_state(cfg, model)
    with np.load(src / "step_batch.npz") as z:
        host = Batch(audio=z["audio"], audio_lengths=z["audio_lengths"], labels=z["labels"],
                     label_lengths=z["label_lengths"], texts=[""] * 8, bucket_seconds=0.5)
    batch = engine.batch_to_device(host, "cpu", family="whisper", whisper_prompt=(1, 2), eot_id=0)
    step = engine.make_train_step(engine.make_loss_fn(cfg, model), cfg.train.optimizer)
    metrics = step(state, pmesh.shard_batch(mesh, batch, 8))
    rec = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "mesh": list(mesh.shape), "placements": placements(model, state.optimizer),
           "tp_dims": model.tp_dims}
    full = pmesh.full_model(model, lambda: WhisperModel(WHISPER))
    if mh.is_primary():
        np.savez(dst / "step_params.npz", **{k: v.detach().numpy()
                                              for k, v in full.state_dict().items()})
    return rec


def case_greedy(src: Path, dst: Path) -> dict:
    mesh = pmesh.build_mesh(c.MeshConfig(data_axis=2, model_axis=2))
    model = whisper_model(src)
    apply_tp(model, pmesh.tp_group(mesh))
    model.eval()
    mel = torch.from_numpy(np.load(src / "mel.npy"))
    r, k = pmesh.dp_rank(mesh), mel.shape[0] // 2
    gen, lens = greedy_generate(model, mel[r * k:(r + 1) * k], max_len=10, prompt=(1, 2),
                                eot_id=0)
    return {"tokens": gather_rows(gen.tolist(), mesh), "lengths": gather_rows(lens.tolist(), mesh),
            "local_heads": model.decoder.blocks[0].self_attn.num_heads}


def case_transcribe(src: Path, dst: Path) -> dict:
    cfg = whisper_cfg(data_axis=2, model_axis=2)
    cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=0.5)
    tok = CharTokenizer(json.loads((src / "vocab.json").read_text())["vocab"])
    bundle = ModelBundle(cfg, whisper_model(src), tok).shard()
    wavs = sorted(str(p) for p in src.glob("u*.wav"))
    texts = bundle.transcribe(wavs)
    bundle.save(str(dst / "sharded_bundle"))
    return {"texts": texts, "mesh": list(bundle.mesh.shape)}


def case_train_loop(src: Path, dst: Path) -> dict:
    spec = json.loads((src / "train_loop.json").read_text())
    cfg = c.ExperimentConfig(
        model_family="ctc",
        ctc_model=c.CTCModelConfig(vocab_size=spec["vocab_size"], d_model=64, num_layers=1,
                                   num_heads=4, mlp_dim=128, conv_channels=32, dtype="float32",
                                   use_flash_attention=False, dropout=0.0,
                                   adapter=c.AdapterConfig(kind="wf", wf_rank=4)),
        specaugment=c.SpecAugmentConfig(enabled=False),
        data=c.DataConfig(batch_size=8, bucket_boundaries_seconds=(1.5,), min_audio_seconds=0.1,
                          max_text_len=8, train_manifest=spec["manifest"]),
        mesh=c.MeshConfig(fsdp_axis=2, model_axis=2))
    cfg.train.optimizer = c.OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4,
                                            schedule="constant")
    cfg.train.train_adapters_only = True
    cfg.train.checkpoint_dir = str(dst / "ck_train_loop")
    cfg.train.checkpoint_every_steps = 100
    manifest = read_manifest(spec["manifest"])
    tok = CharTokenizer(spec["vocab"])
    model = CTCEncoderModel(cfg.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(convert.read_npz_params(src / "ctc.npz")))
    state, info = engine.train_loop(cfg, manifest, tok, model)
    full = pmesh.full_model(model, lambda: CTCEncoderModel(cfg.ctc_model))
    if mh.is_primary():
        np.savez(dst / "loop_params.npz", **{k: v.detach().numpy()
                                              for k, v in full.state_dict().items()})
    return {"losses": info["losses"], "mesh": info["mesh"],
            "split": sorted(model.tp_dims), "placements": placements(model, state.optimizer)}


def case_dropout(src: Path, dst: Path) -> dict:
    cc = c.CTCModelConfig(vocab_size=24, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
                          conv_channels=32, dtype="float32", use_flash_attention=False,
                          dropout=0.1, adapter=c.AdapterConfig(kind="bottleneck", dropout=0.1))
    mesh = pmesh.build_mesh(c.MeshConfig(data_axis=2, model_axis=2))
    whole, split = CTCEncoderModel(cc, seed=3), CTCEncoderModel(cc, seed=3)
    apply_tp(split, pmesh.tp_group(mesh))
    feats = torch.from_numpy(np.random.RandomState(5).randn(2, 80, 120).astype(np.float32))
    out = {}
    with torch.no_grad():
        for name, m in (("whole", whole), ("split", split)):
            m.train()
            seed = 1234 + pmesh.dp_rank(mesh)  # the train step's dropout seed of this rank
            out[name] = m(feats, torch.tensor([120, 90]), dropout_seed=seed)[0].tolist()
    return out


BEAM = dict(beam_size=3, max_len=10, prompt=(1, 2), eot_id=0)
ROW_X_ROWS = 8  # rows of the seeded input to the summed fc2 row partials
# the serving cases' specials and characters (every id past the two
# specials a character, so that each generated id shows in the text)
SERVE_SPECIALS = dict(prompt_ids=(1, 2), eot_id=0)
SERVE_VOCAB = [chr(0x4E00 + i) for i in range(WHISPER.vocab_size - 2)]
SERVE_MAX_LEN = 12


def _bundle(src: Path, **mesh) -> ModelBundle:
    cfg = whisper_cfg(**mesh)
    cfg.whisper = dataclasses.replace(cfg.whisper, **SERVE_SPECIALS)
    cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=0.5)
    cfg.decode.max_decode_len = SERVE_MAX_LEN
    return ModelBundle(cfg, whisper_model(src), CharTokenizer(SERVE_VOCAB))


def case_int8(src: Path, dst: Path) -> dict:
    """Model 4: quantize then shard, shard then quantize."""
    after = _bundle(src, model_axis=4).shard().quantize()
    before = _bundle(src, model_axis=4).quantize().shard()
    sa, sb = after.model.state_dict(), before.model.state_dict()
    same = sorted(sa) == sorted(sb) and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)
    joined = pmesh.gather_split(sa, after.model)
    if mh.is_primary():
        np.savez(dst / "int8_joined.npz", **{k: v.numpy() for k, v in joined.items()
                                              if k.startswith("decoder.")})
    mel = torch.from_numpy(np.load(src / "mel.npy"))
    gen, lens = greedy_generate(after.model, mel, max_len=10, prompt=(1, 2), eot_id=0)
    fc2 = after.model.decoder.blocks[0].mlp.fc2
    x = torch.from_numpy(np.random.RandomState(23).randn(ROW_X_ROWS, 128).astype(np.float32))
    with torch.no_grad():
        n = fc2.kernel_q.shape[0]
        part = int8_row_product(x[:, fc2.tp.rank * n:(fc2.tp.rank + 1) * n], fc2.kernel_q,
                                fc2.scale)
        summed = fc2.tp.reduce(part).to(torch.bfloat16)
    return {"orders_bitwise": same, "tp_dims": after.model.tp_dims,
            "tp_dims_before": before.model.tp_dims, "heads": after.model.decoder.blocks[0]
            .self_attn.num_heads, "local_vocab": int(after.model.decoder.embed_tokens
                                                     .embedding_q.shape[0]),
            "fc2_rows": n, "fc2_summed": summed.float().tolist(),
            "tokens": gen.tolist(), "lengths": lens.tolist()}


def case_int8_wf(src: Path, dst: Path) -> dict:
    """Data 2 x model 2: the test's WF-adapted weights (B drawn, so the
    inserts move the output) quantized after the split: greedy tokens, and
    the decode-step logits against the same model quantized whole in this
    process; and the whole model's steps with the inserts' B zeroed, which
    must differ."""
    wcfg = dataclasses.replace(WHISPER, adapter=c.AdapterConfig(kind="wf", wf_rank=4))
    cfg = whisper_cfg(data_axis=2, model_axis=2)
    cfg.whisper = wcfg
    state = convert.whisper_params_to_state_dict(convert.read_npz_params(src / "whisper_wf.npz"))

    def make(inserts: bool):
        m = WhisperModel(wcfg)
        m.load_state_dict({k: v if inserts or not k.endswith("adapter_wf.b") else
                           torch.zeros_like(v) for k, v in state.items()})
        return ModelBundle(cfg, m.eval(), None)

    mel = torch.from_numpy(np.load(src / "mel.npy"))
    split = make(True).shard().quantize().model
    gen, lens = greedy_generate(split, mel, max_len=10, prompt=(1, 2), eot_id=0)
    toks = torch.from_numpy(np.random.RandomState(24).randint(0, WHISPER.vocab_size, (2, 6)))

    def steps(model):
        with torch.no_grad():
            enc = model.encode(mel[:2])
            caches = model.init_cache(2, enc, 8)
            return torch.stack([model.decode_step(toks[:, p:p + 1], p, enc, caches)[0]
                                for p in range(6)], 1)

    whole = steps(make(True).quantize().model)
    plain = steps(make(False).quantize().model)
    scale = float(whole.abs().max())
    return {"tokens": gen.tolist(), "lengths": lens.tolist(),
            "rel_err": float((steps(split) - whole).abs().max()) / scale,
            "inserts_move": float((plain - whole).abs().max()) / scale}


def case_serving(src: Path, dst: Path) -> dict:
    """Data 2 x model 2: the engine (bf16, int8), the beam, timestamps."""
    wavs = sorted(str(p) for p in src.glob("u*.wav"))
    bundle = _bundle(src, data_axis=2, model_axis=2).shard()
    out = {}
    for name, b in (("bf16", bundle), ("int8", bundle.quantize())):
        eng = ServingEngine(b, slots=2, steps_per_dispatch=4)
        out[f"engine_{name}"] = eng.transcribe(wavs)
    enc = torch.from_numpy(np.load(src / "beam_enc.npy"))
    gen, lens, scores = beam_from_enc(bundle.model, enc, None, BEAM["beam_size"],
                                      BEAM["max_len"], BEAM["prompt"], BEAM["eot_id"])
    out["beam"] = {"tokens": gen.tolist(), "lengths": lens.tolist(), "scores": scores.tolist()}
    out["timed"] = bundle.transcribe_timed(wavs)
    bundle.save(str(dst / "serve_bundle"))  # whole weights, the split mesh in its config
    return out


def case_cli_serve(src: Path, dst: Path) -> dict:
    """The CLI on the bundle case_serving saved (loaded split over its
    config's mesh); the group stays up (its shutdown is the worker's)."""
    ckpt = str(dst / "serve_bundle")
    wavs = sorted(str(p) for p in src.glob("u*.wav"))
    runs = {"serve_int8": ["serve", *wavs, "--checkpoint", ckpt, "--slots", "2",
                           "--steps-per-dispatch", "3", "--int8"],
            "transcribe_timestamps": ["transcribe", *wavs, "--checkpoint", ckpt,
                                      "--timestamps"]}
    out = {}
    keep = mh.shutdown
    mh.shutdown = lambda: None
    try:
        for name, argv in runs.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([*argv, "--multihost", "--device", "cpu"])
            out[name] = {"rc": rc, "lines": buf.getvalue().splitlines()}
    finally:
        mh.shutdown = keep
    return out


# the split CTC and joint cases (the test writes their weights from the
# same constants)
CTC_SPLIT = dict(vocab_size=17, d_model=64, num_layers=1, num_heads=4, mlp_dim=128,
                 conv_channels=32, dtype="float32", use_flash_attention=False)
CTC_VOCAB = [chr(0x4E00 + i) for i in range(CTC_SPLIT["vocab_size"] - 2)]
BANDED = dict(attention_left_context=4, attention_right_context=2)
JOINT_SPLIT = dict(vocab_size=32, d_model=64, num_layers=1, decoder_layers=1, num_heads=4,
                   mlp_dim=128, conv_channels=16, dropout=0.0, use_flash_attention=False,
                   max_target_positions=32, dtype="float32")
JOINT_VOCAB = [chr(0x4E00 + i) for i in range(JOINT_SPLIT["vocab_size"] - 2)]
STREAM = (1.28, 0.32, 0.16)  # window, hop, lookahead seconds
CHUNK_SECONDS = 1.0
JOINT_MAX_LEN = 12
JOINT_BEAM = 3
BEAM_ROUTES = {"beam_device": dict(strategy="beam_device"), "beam": dict(strategy="beam"),
               "beam_lm": dict(strategy="beam", lm_weight=0.8)}


def ctc_config(m, banded: bool = False, **mesh):
    """The split CTC case's config in config module `m` (the port's or the
    JAX package's)."""
    cfg = m.ExperimentConfig(model_family="ctc", ctc_model=m.CTCModelConfig(
        **CTC_SPLIT, **(BANDED if banded else {})), mesh=m.MeshConfig(**mesh))
    cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=CHUNK_SECONDS)
    return cfg


def joint_config(m, **mesh):
    """The split joint case's config (WF inserts, as the published joint
    config) in config module `m`."""
    cfg = m.ExperimentConfig(model_family="joint", joint=m.JointModelConfig(
        **JOINT_SPLIT, adapter=m.AdapterConfig(kind="wf", wf_rank=2)), mesh=m.MeshConfig(**mesh))
    cfg.frontend = dataclasses.replace(cfg.frontend, chunk_seconds=CHUNK_SECONDS)
    cfg.specaugment = m.SpecAugmentConfig(enabled=False)
    return cfg


def beam_config(m, name: str, lm_path: str):
    kw = dict(BEAM_ROUTES[name], beam_size=4)
    if "lm_weight" in kw:
        kw["lm_path"] = lm_path
    return m.DecodeConfig(**kw)


def stream_states(transcriber, audio, cuts) -> list:
    """A transcriber fed `audio` cut at `cuts`, then finished -> its state
    after each call (either package's StreamingTranscriber)."""
    def state(res):
        return [list(map(int, transcriber._tokens)), [list(map(int, s)) for s in
                                                      transcriber._spans],
                res.text, res.new_text, res.preview, int(res.committed_frames),
                float(res.trailing_silence), bool(res.is_final)]

    out = [state(transcriber.feed(c)) for c in np.split(audio, cuts)]
    return out + [state(transcriber.finish())]


def drive_pool(pool, audios, hop: int) -> dict:
    """Streams arriving a hop at a time, one step() between (either
    package's StreamingPool) -> {"steps": each step's results, "texts":
    the streams' final texts}."""
    sids = [pool.open() for _ in audios]
    offs = [0] * len(audios)
    done, steps = {}, []
    while len(done) < len(audios):
        for k, sid in enumerate(sids):
            if sid in done:
                continue
            if offs[k] < len(audios[k]):
                pool.feed(sid, audios[k][offs[k]:offs[k] + hop])
                offs[k] += hop
            else:
                done[sid] = pool.finish(sid).text
        steps.append([[int(sid), r.text, r.new_text, r.preview, int(r.committed_frames),
                       float(r.trailing_silence), bool(r.is_final)]
                      for sid, r in sorted(pool.step().items())])
    return {"steps": steps, "texts": [done[s] for s in sids]}


def _ctc_bundle(src: Path, banded: bool = False, **mesh) -> ModelBundle:
    cfg = ctc_config(c, banded, **mesh)
    model = CTCEncoderModel(cfg.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(
        convert.read_npz_params(src / "ctc_split.npz")))
    return ModelBundle(cfg, model.eval(), CharTokenizer(CTC_VOCAB)).shard()


def case_ctc_split(src: Path, dst: Path) -> dict:
    """Split CTC streaming and the CTC prefix beams (see the docstring)."""
    from jiao_liao_speech_recognition_torch.serve.streaming import (StreamingConfig,
                                                                      StreamingPool,
                                                                      StreamingTranscriber)

    sc = StreamingConfig(*STREAM)
    with np.load(src / "stream.npz") as z:
        one, cuts, pool_audio = z["one"], z["cuts"], [z[f"pool{i}"] for i in range(3)]
    out = {}
    for tag, banded, mesh in (("data2_model2", False, dict(data_axis=2, model_axis=2)),
                              ("model4", False, dict(model_axis=4)),
                              ("banded", True, dict(data_axis=2, model_axis=2))):
        bundle = _ctc_bundle(src, banded, **mesh)
        out[f"stream_{tag}"] = stream_states(StreamingTranscriber(bundle, sc), one, cuts)
    bundle = _ctc_bundle(src, data_axis=2, model_axis=2)
    out["heads"] = bundle.model.blocks[0].self_attn.num_heads
    pool = StreamingPool(bundle, slots=4, stream_cfg=sc)
    out["pool"] = drive_pool(pool, pool_audio, int(STREAM[1] * 16000))
    out["pool_ring"] = pool._graph is None and pool._ring is not None
    wavs, alens, _ = bundle._prepare_audio_chunked(
        sorted(str(p) for p in src.glob("r*.wav"))[:4], None)
    rows = bundle._rows(len(wavs))
    out["beam_rows"] = [rows.start, rows.stop]
    for name in BEAM_ROUTES:
        ids, lens = bundle._ctc_beam_ids(wavs[rows], alens[rows],
                                         beam_config(c, name, str(src / "lm.npz")))
        out[name] = {"ids": np.asarray(ids).tolist(), "lens": np.asarray(lens).tolist()}
    bundle.save(str(dst / "ctc_bundle"))  # whole weights, the split mesh in its config
    return out


def case_joint_split(src: Path, dst: Path) -> dict:
    """The split joint family (see the docstring)."""
    from jiao_liao_speech_recognition_torch.decode import joint_generate as jg
    from jiao_liao_speech_recognition_torch.decode.speculative import joint_spec_greedy
    from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel
    from jiao_liao_speech_recognition_torch.serve.streaming import StreamingConfig, StreamingPool

    state = convert.joint_params_to_state_dict(convert.read_npz_params(src / "joint.npz"))
    feats = torch.from_numpy(np.load(src / "joint_feats.npy"))
    flens = torch.from_numpy(np.load(src / "joint_flens.npy"))
    L, K = JOINT_MAX_LEN, JOINT_BEAM

    def bundle(**mesh):
        cfg = joint_config(c, **mesh)
        model = JointCTCAttentionModel(cfg.joint)
        model.load_state_dict(state)
        return ModelBundle(cfg, model.eval(), CharTokenizer(JOINT_VOCAB)).shard()

    out = {}
    for tag, mesh in (("data2_model2", dict(data_axis=2, model_axis=2)),
                      ("model4", dict(model_axis=4))):
        m = bundle(**mesh).model
        gen, lens = jg.joint_greedy(m, feats, flens, max_len=L)
        out[f"greedy_{tag}"] = {"tokens": gen.tolist(), "lengths": lens.tolist(),
                                "heads": m.dec_blocks[0].cross_attn.num_heads,
                                "vocab_rows": int(m.embed_tokens.embedding.shape[0])}
    b = bundle(data_axis=2, model_axis=2)
    m = b.model
    gen, lens = joint_spec_greedy(m, feats, flens, max_len=L)
    out["spec_greedy"] = {"tokens": gen.tolist(), "lengths": lens.tolist()}
    with torch.inference_mode():
        enc, el = m.encode(feats, flens)
        gen, lens, scores = wg.beam_from_enc(m, enc, el, K, L, (0,), 0)
        nll = jg.ctc_rescore(m, enc, el, gen, lens)
    out["hyps"] = {"tokens": gen.tolist(), "lengths": lens.tolist(), "scores": scores.tolist(),
                   "nll": nll.tolist()}
    gen, lens = jg.joint_beam(m, feats, flens, beam_size=K, max_len=L)
    out["joint_beam"] = {"tokens": gen.tolist(), "lengths": lens.tolist()}
    with np.load(src / "stream.npz") as z:
        pool_audio = [z[f"pool{i}"] for i in range(3)]
    pool = StreamingPool(b, slots=4, stream_cfg=StreamingConfig(*STREAM))
    out["pool"] = drive_pool(pool, pool_audio, int(STREAM[1] * 16000))

    spec = json.loads((src / "train_loop.json").read_text())
    cfg = joint_config(c, fsdp_axis=2, model_axis=2)
    cfg.joint.vocab_size = spec["vocab_size"]
    cfg.data = c.DataConfig(batch_size=8, bucket_boundaries_seconds=(1.5,), min_audio_seconds=0.1,
                            max_text_len=8, train_manifest=spec["manifest"])
    cfg.train.optimizer = c.OptimizerConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4,
                                            schedule="constant")
    cfg.train.train_adapters_only = True
    cfg.train.checkpoint_dir = str(dst / "ck_joint_loop")
    cfg.train.checkpoint_every_steps = 100
    model = JointCTCAttentionModel(cfg.joint)
    model.load_state_dict(convert.joint_params_to_state_dict(
        convert.read_npz_params(src / "joint_train.npz")))
    _, info = engine.train_loop(cfg, read_manifest(spec["manifest"]),
                                CharTokenizer(spec["vocab"]), model)
    full = pmesh.full_model(model, lambda: JointCTCAttentionModel(cfg.joint))
    if mh.is_primary():
        np.savez(dst / "joint_loop_params.npz", **{k: v.detach().numpy()
                                                    for k, v in full.state_dict().items()})
    out["train_loop"] = {"losses": info["losses"], "mesh": info["mesh"],
                         "split": sorted(model.tp_dims)}
    return out


def case_cli_ctc(src: Path, dst: Path) -> dict:
    """The CLI's streaming and CTC beam on the bundle case_ctc_split saved
    (loaded split over its config's mesh); the group stays up."""
    ckpt = str(dst / "ctc_bundle")
    wavs = sorted(str(p) for p in src.glob("r*.wav"))[:2]
    runs = {"stream": ["transcribe", *wavs, "--checkpoint", ckpt, "--stream",
                       "--stream-window", str(STREAM[0]), "--stream-hop", str(STREAM[1]),
                       "--stream-lookahead", str(STREAM[2])],
            "beam": ["transcribe", *wavs, "--checkpoint", ckpt, "--strategy", "beam",
                     "--beam-size", "4"]}
    out = {}
    keep = mh.shutdown
    mh.shutdown = lambda: None
    try:
        for name, argv in runs.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([*argv, "--multihost", "--device", "cpu"])
            out[name] = {"rc": rc, "lines": buf.getvalue().splitlines()}
    finally:
        mh.shutdown = keep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="src", required=True)
    ap.add_argument("--out", dest="dst", required=True)
    ap.add_argument("--resume", required=True, help="a one-process dry-run checkpoint")
    args = ap.parse_args(argv)
    src, dst = Path(args.src), Path(args.dst)
    torch.set_num_threads(1)
    mh.initialize(device="cpu")
    out = {"rank": mh.process_index()}
    for name, fn in (("step", case_step), ("greedy", case_greedy),
                     ("transcribe", case_transcribe), ("train_loop", case_train_loop),
                     ("dropout", case_dropout), ("int8", case_int8), ("int8_wf", case_int8_wf),
                     ("serving", case_serving), ("cli_serve", case_cli_serve),
                     ("ctc_split", case_ctc_split), ("joint_split", case_joint_split),
                     ("cli_ctc", case_cli_ctc)):
        out[name] = fn(src, dst)
    work = dst / "dryrun"
    out["dryrun"] = {
        "ctc:2x2": dryrun.run_case("ctc", 2, work, model=2),
        "whisper:1x2": dryrun.run_case("whisper", 1, work, model=2),
        "ctc:2x2_resumed": dryrun.run_case("ctc", 2, work, resume_from=Path(args.resume),
                                           tag="_resumed", model=2)}
    spec = json.loads((src / "train_loop.json").read_text())
    out["cli"] = cli.main([
        "train", "--multihost", "--device", "cpu", "--config", "configs/adapter_finetune.yaml",
        f"data.train_manifest={spec['manifest']}", "data.eval_manifest=", "data.batch_size=8",
        "data.bucket_boundaries_seconds=[1.5]", "data.num_host_workers=1",
        "data.min_audio_seconds=0.1", "data.max_text_len=8", "frontend.chunk_seconds=2.0",
        "ctc_model.d_model=64", "ctc_model.num_layers=1", "ctc_model.num_heads=4",
        "ctc_model.mlp_dim=128", "ctc_model.conv_channels=32", "ctc_model.dtype=float32",
        "mesh.model_axis=2", "train.optimizer.total_steps=2", "train.optimizer.warmup_steps=0",
        f"train.checkpoint_dir={dst / 'cli_ckpt'}", f"train.metrics_path={dst / 'cli.jsonl'}",
        "train.log_every_steps=1"])
    (dst / f"rank{out['rank']}.json").write_text(json.dumps(out))
    mh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
