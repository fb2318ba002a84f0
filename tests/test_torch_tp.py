"""The port's tensor parallelism against the JAX package's
(``parallel/tp_rules.py``, the model half of ``parallel/mesh.py``,
``ModelBundle.shard``): every parameter's placement against
``tp_param_sharding`` / ``fsdp_tp_sharding`` on conftest's 8 CPU devices,
and the port's ranks on gloo (tests/torch_tp_worker.py, spawned once for
the module as tests/torch_ranks.py spawns them) against JAX's one-device
results at JAX's own bars (tests/test_tp.py, tests/test_mesh_train.py):
one train step at data 2 x model 2, sharded greedy tokens, sharded
transcribe texts, train_loop at fsdp 2 x model 2, the dry run's TP cases
and checkpoints crossing between a TP run and one process, equal dropout
masks in a model group; split Whisper serving: int8 buffers in both orders
of quantize and shard (bitwise JAX's quantize(), placed as JAX's
shard().quantize()), int8 greedy tokens (and a WF-adapted model's), the
row partials' sum against JAX's K10, the engine's texts (bf16 and int8), the AR beam, timestamps,
and the CLI's serve and transcribe under --multihost against one
process; the split CTC and joint families: streaming (one stream after
every feed at data 2 x model 2, at model 4 and banded; the pool after every
step), the three CTC prefix beam routes, the joint greedy, spec_greedy and
AR beam with CTC rescoring, the joint pool and the joint train_loop at
fsdp 2 x model 2, and the CLI's --stream and CTC beam under --multihost
against one process; and, on the CPU alone, the padded K5 pack, heads
that do not divide and the capture refused to a stand-in group."""

import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_tp_worker as tw  # noqa: E402
from torch_ranks import spawn  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import Manifest, ManifestRow  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import write_manifest  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.pipeline import Batch as JBatch  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import ctc as jctc  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import joint_generate as jjg  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.speculative import joint_spec_greedy  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.whisper_generate import beam_from_enc  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.whisper_generate import greedy_generate  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend.audio_io import write_wav  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import features as jfeatures  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import joint as jjoint  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jq  # noqa: E402
from jiao_liao_speech_recognition_tpu.parallel import mesh as jmesh  # noqa: E402
from jiao_liao_speech_recognition_tpu.parallel.tp_rules import fsdp_tp_sharding  # noqa: E402
from jiao_liao_speech_recognition_tpu.parallel.tp_rules import tp_param_sharding  # noqa: E402
from jiao_liao_speech_recognition_tpu.serve import ServingEngine as JEngine  # noqa: E402
from jiao_liao_speech_recognition_tpu.serve import streaming as jstreaming  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops.ctc_loss import ctc_loss as jctc_loss  # noqa: E402
from jiao_liao_speech_recognition_tpu.train import engine as jeng  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import cli  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_mlp as tfm  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import dryrun  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import tp as ttp  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import tp_rules  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# JAX's bars for a TP step against one device (tests/test_tp.py)
STEP_LOSS_BAR = 2e-5
STEP_PARAM_BAR = 1e-4
# and for the production loop on a mesh against one device
# (tests/test_mesh_train.py)
LOOP_BAR = 1e-4
# N processes against one (tests/test_multihost.py, as
# tests/test_torch_multihost.py holds the dry run)
BAR = dict(rtol=2e-4, atol=1e-6)
WORLD = 4
DRYRUN_STEPS = 2
# the AR beam's summed log-probs, split against one device (f32 sums
# reordered by the row layers' all-reduce)
BEAM_SCORE_BAR = 1e-5
# the split int8 model's f32 decode-step logits against the same model
# quantized whole (tests/test_torch_quant.py's bar for int8 logits: bf16
# roundings flip by one ulp in different places), relative to the largest
LOGIT_REL_BAR = 0.01
BEAM = dict(beam_size=3, max_len=10, prompt=(1, 2), eot_id=0)  # the worker's
ENGINE = dict(slots=2, steps_per_dispatch=4, max_len=12)  # the worker's

JCFG = jcfg.ExperimentConfig(
    model_family="whisper",
    whisper=jcfg.WhisperConfig(vocab_size=64, d_model=64, encoder_layers=1, decoder_layers=1,
                               num_heads=4, mlp_dim=128, max_target_positions=32,
                               dtype="float32", use_flash_attention=False,
                               max_source_positions=64),
    specaugment=jcfg.SpecAugmentConfig(enabled=False),
)
# the same model with WF inserts (the worker's case_int8_wf)
WF_CFG = dataclasses.replace(JCFG, whisper=dataclasses.replace(
    JCFG.whisper, adapter=jcfg.AdapterConfig(kind="wf", wf_rank=4)))
WF_B_SCALE = 0.1  # the inserts' B, drawn off its zero init so they move the output


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _step_batch():
    """tests/test_tp.py's _batch (B=8, 8000 samples, 5 labels), seeded."""
    rng = np.random.RandomState(0)
    return dict(audio=rng.randn(8, 8000).astype(np.float32) * 0.1,
                audio_lengths=np.full((8,), 8000, np.int32),
                labels=rng.randint(3, 64, (8, 5)).astype(np.int32),
                label_lengths=np.full((8,), 5, np.int32))


def _mesh_cfg():
    """tests/test_mesh_train.py's _cfg(batch=8, steps=4, adapters=True)."""
    cfg = jcfg.ExperimentConfig(
        model_family="ctc",
        ctc_model=jcfg.CTCModelConfig(vocab_size=24, d_model=64, num_layers=1, num_heads=4,
                                      mlp_dim=128, conv_channels=32, dtype="float32",
                                      use_flash_attention=False, dropout=0.0,
                                      adapter=jcfg.AdapterConfig(kind="wf", wf_rank=4)),
        specaugment=jcfg.SpecAugmentConfig(enabled=False),
        data=jcfg.DataConfig(batch_size=8, bucket_boundaries_seconds=(1.5,),
                             min_audio_seconds=0.1, max_text_len=8),
        mesh=jcfg.MeshConfig(data_axis=1))
    cfg.train.optimizer = jcfg.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                               total_steps=4, schedule="constant")
    cfg.train.train_adapters_only = True
    return cfg


def _wf_params():
    """JAX's init of WF_CFG with each insert's B drawn (seeded)."""
    noise = np.random.RandomState(9)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + WF_B_SCALE * noise.randn(*v.shape)).astype(np.float32)
        if [str(getattr(k, "key", k)) for k in path][-2:] == ["adapter_wf", "b"]
        else np.asarray(v), JBundle._init_params(WF_CFG))


def _jax_refs(src, manifest, wf_params, out):
    """The JAX package's one-device results, at "highest" matmul precision
    (the port computes in full f32)."""
    with jax.default_matmul_precision("highest"):
        params = JBundle._init_params(JCFG)
        host = _step_batch()
        batch = jeng.batch_to_device(JBatch(texts=[""] * 8, bucket_seconds=0.5, **host),
                                     family="whisper", whisper_prompt=(1, 2), eot_id=0)
        cfg = dataclasses.replace(JCFG)
        cfg.train.optimizer = jcfg.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                                   total_steps=5, schedule="constant")
        _, _, tx, step = jeng.build_train_setup(cfg, params)
        st1, m1 = step(jeng.init_state(cfg, tx, params), batch)
        out["step_loss"] = float(m1["loss"])
        out["step_params"] = convert.whisper_params_to_state_dict(_np(st1.params))

        params = JBundle._init_params(JCFG)  # the step donated the first copy
        mel = jnp.asarray(np.load(src / "mel.npy"))
        gen, lens = jax.jit(lambda p, m: greedy_generate(
            JWhisper(JCFG.whisper), p, m, max_len=10, prompt=(1, 2), eot_id=0))(params, mel)
        out["tokens"], out["lengths"] = np.asarray(gen).tolist(), np.asarray(lens).tolist()

        tcfg_ = dataclasses.replace(JCFG)
        tcfg_.frontend = dataclasses.replace(tcfg_.frontend, chunk_seconds=0.5)
        bundle = JBundle(config=tcfg_, params=params, tokenizer=JTok.build(["abc def"]))
        wavs = sorted(str(p) for p in src.glob("u*.wav"))
        out["texts"] = bundle.transcribe(wavs)
        scfg = dataclasses.replace(tcfg_, whisper=dataclasses.replace(
            JCFG.whisper, prompt_ids=(1, 2), eot_id=0))  # the worker's serving config
        scfg.decode = dataclasses.replace(scfg.decode, max_decode_len=ENGINE["max_len"])
        bundle = JBundle(config=scfg, params=params, tokenizer=JTok(
            [chr(0x4E00 + i) for i in range(JCFG.whisper.vocab_size - 2)]))
        out["timed"] = bundle.transcribe_timed(wavs)
        qbundle = bundle.quantize()
        out["int8_state"] = convert.whisper_params_to_state_dict(_np(qbundle.params))
        gen, lens = jax.jit(lambda p, m: greedy_generate(
            JWhisper(JCFG.whisper), p, m, max_len=10, prompt=(1, 2), eot_id=0))(
            qbundle.params, mel)
        out["int8_tokens"], out["int8_lengths"] = np.asarray(gen).tolist(), np.asarray(
            lens).tolist()
        wf = JBundle(config=WF_CFG, params=wf_params, tokenizer=None).quantize()
        gen, lens = jax.jit(lambda p, m: greedy_generate(
            JWhisper(WF_CFG.whisper), p, m, max_len=10, prompt=(1, 2), eot_id=0))(wf.params, mel)
        out["int8_wf_tokens"], out["int8_wf_lengths"] = np.asarray(gen).tolist(), np.asarray(
            lens).tolist()
        for name, b in (("bf16", bundle), ("int8", qbundle)):
            out[f"engine_{name}"] = JEngine(b, **ENGINE).transcribe(wavs)
        enc = jnp.asarray(np.load(src / "beam_enc.npy"))
        out["beam"] = [np.asarray(a).tolist() for a in beam_from_enc(
            JWhisper(JCFG.whisper), params, enc, None, **BEAM)]

        mcfg = _mesh_cfg()
        mcfg.train.checkpoint_dir = str(src / "jax_ck")
        tok = JTok.build(manifest.texts())
        mcfg.ctc_model.vocab_size = len(tok)
        state, info = jeng.train_loop(mcfg, manifest, tok, JBundle._init_params(mcfg))
        out["loop_loss"] = info["last_metrics"]["loss"]
        out["loop_params"] = convert.params_to_state_dict(_np(state.params))
    _jax_split_refs(src, manifest, out)


def _split_inputs(src, manifest):
    """The split CTC and joint cases' inputs: the CTC weights (the port's
    seeded init, as the bridge writes them; the head scaled for peakier
    rows, as tests/test_torch_ctc_beam.py does), an n-gram LM, the streams'
    audio, the joint weights (moved off their init, WF inserts included),
    its features and its train_loop's initial weights."""
    ctc = CTCEncoderModel(tw.ctc_config(tcfg).ctc_model, seed=5)
    params = convert.state_dict_to_params(ctc.state_dict())
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8.0
    convert.write_npz_params(params, src / "ctc_split.npz")
    JLM.train_from_texts(["".join(tw.CTC_VOCAB[i] for i in row) for row in
                          ((1, 2, 3), (2, 3, 4, 5), (3, 1))], JTok(tw.CTC_VOCAB),
                         order=2).save(str(src / "lm.npz"))
    rng = np.random.RandomState(40)
    one = (0.1 * rng.randn(int(16000 * 2.4))).astype(np.float32)
    np.savez(src / "stream.npz", one=one, cuts=np.sort(rng.randint(1, len(one), size=5)),
             **{f"pool{i}": (0.1 * rng.randn(int(16000 * t))).astype(np.float32)
                for i, t in enumerate((1.6, 0.7, 1.2))})
    noise = np.random.RandomState(41)
    joint = JointCTCAttentionModel(tw.joint_config(tcfg).joint, seed=6).state_dict()
    convert.write_npz_params(convert.joint_state_dict_to_params(
        {k: v + 0.05 * torch.from_numpy(noise.randn(*v.shape).astype(np.float32))
         for k, v in joint.items()}), src / "joint.npz")
    np.save(src / "joint_feats.npy", rng.randn(4, 80, 64).astype(np.float32))
    np.save(src / "joint_flens.npy", np.array([64, 32, 55, 64], np.int32))
    jt = tw.joint_config(tcfg).joint
    jt.vocab_size = len(JTok.build(manifest.texts()))
    convert.write_npz_params(convert.joint_state_dict_to_params(
        JointCTCAttentionModel(jt, seed=7).state_dict()), src / "joint_train.npz")


def _joint_loop_cfg(vocab_size: int):
    """The worker's joint train_loop config in the JAX package's terms."""
    cfg = tw.joint_config(jcfg)
    cfg.joint.vocab_size = vocab_size
    cfg.data = jcfg.DataConfig(batch_size=8, bucket_boundaries_seconds=(1.5,),
                               min_audio_seconds=0.1, max_text_len=8)
    cfg.train.optimizer = jcfg.OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                               total_steps=4, schedule="constant")
    cfg.train.train_adapters_only = True
    return cfg


def _jax_split_refs(src, manifest, out):
    """JAX's one-device results for the worker's ctc_split and joint_split
    cases (called inside _jax_refs's "highest" precision)."""
    sc = jstreaming.StreamingConfig(*tw.STREAM)
    hop = int(tw.STREAM[1] * 16000)
    with np.load(src / "stream.npz") as z:
        one, cuts, pool_audio = z["one"], z["cuts"], [z[f"pool{i}"] for i in range(3)]
    params = convert.read_npz_params(src / "ctc_split.npz")
    for banded in (True, False):
        jb = JBundle(config=tw.ctc_config(jcfg, banded), params=params,
                     tokenizer=JTok(tw.CTC_VOCAB))
        out[f"stream_banded_{banded}"] = tw.stream_states(
            jstreaming.StreamingTranscriber(jb, sc), one, cuts)
    out["pool"] = tw.drive_pool(jstreaming.StreamingPool(jb, slots=4, stream_cfg=sc),
                                pool_audio, hop)
    wavs, alens, _ = jb._prepare_audio_chunked(sorted(str(p) for p in src.glob("r*.wav"))[:4],
                                               None)
    fe = jb.config.frontend
    lp, ol = jb.encode(jfeatures.featurize_batch(jnp.asarray(wavs), fe),
                       jnp.asarray(alens // fe.hop_length, jnp.int32))
    for name in tw.BEAM_ROUTES:
        dc = tw.beam_config(jcfg, name, str(src / "lm.npz"))
        if name == "beam_device":
            ids, lens = jctc.ctc_prefix_beam_search(lp, ol, dc.beam_size, dc.ctc_blank_id,
                                                    topk_tokens=min(dc.beam_topk, 16))
        else:
            ids, lens = jctc.ctc_prefix_beam_search_host(
                np.asarray(lp), np.asarray(ol), dc.beam_size, dc.ctc_blank_id,
                topk_tokens=dc.beam_topk, lm=JLM.load(dc.lm_path) if dc.lm_path else None,
                lm_weight=dc.lm_weight)
        out[f"ctc_{name}"] = {"ids": np.asarray(ids).tolist(),
                              "lens": np.asarray(lens).tolist()}

    jc = tw.joint_config(jcfg)
    jm, jp = jjoint.JointCTCAttentionModel(jc.joint), convert.read_npz_params(src / "joint.npz")
    feats = jnp.asarray(np.load(src / "joint_feats.npy"))
    flens = jnp.asarray(np.load(src / "joint_flens.npy"))
    L, K = tw.JOINT_MAX_LEN, tw.JOINT_BEAM
    for name, fn in (("joint_greedy", jjg.joint_greedy), ("spec_greedy", joint_spec_greedy)):
        gen, lens = fn(jm, jp, feats, flens, max_len=L)
        out[name] = {"tokens": np.asarray(gen).tolist(), "lengths": np.asarray(lens).tolist()}
    enc, el = jm.apply({"params": jp}, feats, flens, method=jm.encode)
    gen, lens, scores = jwg.beam_from_enc(jm, jp, enc, el, beam_size=K, max_len=L, prompt=(0,),
                                          eot_id=0)
    lp = jm.apply({"params": jp}, enc, method=jm.ctc_log_probs)
    B, _, Lg = gen.shape
    nll = jctc_loss(jnp.repeat(lp, K, axis=0), jnp.repeat(el, K, axis=0),
                    jnp.reshape(gen, (B * K, Lg)), jnp.reshape(lens, (B * K,)))
    out["joint_hyps"] = {"tokens": np.asarray(gen).tolist(),
                         "lengths": np.asarray(lens).tolist(),
                         "scores": np.asarray(scores).tolist(),
                         "nll": np.asarray(nll).reshape(B, K).tolist()}
    gen, lens = jjg.joint_beam(jm, jp, feats, flens, beam_size=K, max_len=L)
    out["joint_beam"] = {"tokens": np.asarray(gen).tolist(), "lengths": np.asarray(lens).tolist()}
    jb = JBundle(config=jc, params=jp, tokenizer=JTok(tw.JOINT_VOCAB))
    out["joint_pool"] = tw.drive_pool(jstreaming.StreamingPool(jb, slots=4, stream_cfg=sc),
                                      pool_audio, hop)
    tok = JTok.build(manifest.texts())
    jt = _joint_loop_cfg(len(tok))
    jt.train.checkpoint_dir = str(src / "jax_joint_ck")
    state, info = jeng.train_loop(jt, manifest, tok, convert.read_npz_params(
        src / "joint_train.npz"))
    out["joint_loop_loss"] = info["last_metrics"]["loss"]
    out["joint_loop_params"] = convert.joint_params_to_state_dict(_np(state.params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written once; the world-4 ranks (one spawn) beside the JAX
    references (a thread); the dry run's one-process references before
    the spawn and the TP checkpoint resumed in one process after it."""
    src = tmp_path_factory.mktemp("tp_in")
    dst = tmp_path_factory.mktemp("tp_out")
    work = dst / "dryrun"
    mel = np.random.RandomState(1).randn(4, 80, 64).astype(np.float32) * 0.3
    with jax.default_matmul_precision("highest"):
        params = JBundle._init_params(JCFG)
        convert.write_npz_params(_np(params), src / "whisper.npz")
        wf_params = _wf_params()
        convert.write_npz_params(wf_params, src / "whisper_wf.npz")
        jm = JWhisper(JCFG.whisper)
        np.save(src / "beam_enc.npy", np.asarray(jm.apply({"params": params}, jnp.asarray(mel),
                                                          method=jm.encode)))
    np.savez(src / "step_batch.npz", **_step_batch())
    np.save(src / "mel.npy", mel)
    for i, f in enumerate((300, 700, 1100, 1500)):
        wav = (0.2 * np.sin(2 * np.pi * f * np.arange(8000) / 16000)).astype(np.float32)
        write_wav(str(src / f"u{i}.wav"), wav, 16000)
    (src / "vocab.json").write_text(json.dumps({"vocab": JTok.build(["abc def"]).vocab}))
    rng = np.random.RandomState(2)
    texts = ["你好", "世界", "胶辽", "官话", "语音", "识别", "大海", "山东"]
    rows = []
    for i in range(8):
        write_wav(src / f"r{i}.wav", (rng.randn(16000) * 0.1).astype(np.float32), 16000)
        rows.append(ManifestRow(str(src / f"r{i}.wav"), texts[i], 1.0, "jiaoliao"))
    manifest = Manifest(rows)
    write_manifest(rows, str(src / "train.jsonl"))
    mcfg = _mesh_cfg()
    tok = JTok.build(manifest.texts())
    mcfg.ctc_model.vocab_size = len(tok)
    convert.write_npz_params(_np(JBundle._init_params(mcfg)), src / "ctc.npz")
    (src / "train_loop.json").write_text(json.dumps({
        "manifest": str(src / "train.jsonl"), "vocab": tok.vocab, "vocab_size": len(tok)}))
    _split_inputs(src, manifest)

    ref = {fam: dryrun.run_case(fam, 1, work, steps=DRYRUN_STEPS) for fam in ("ctc", "whisper")}
    ckpt1 = work / "ctc_w1_f1" / "ckpt"
    ref["ctc_resumed"] = dryrun.run_case("ctc", 1, work, steps=DRYRUN_STEPS, resume_from=ckpt1,
                                         tag="_resumed")
    jax_out = {}
    thread = threading.Thread(target=_jax_refs, args=(src, manifest, wf_params, jax_out))
    thread.start()
    try:
        results = spawn(["tests/torch_tp_worker.py", "--in", str(src), "--out", str(dst),
                         "--resume", str(ckpt1)], WORLD, timeout=240)
    finally:
        thread.join()
    for rank, (rc, text) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}:\n{text[-4000:]}"
    ranks = [json.loads((dst / f"rank{r}.json").read_text()) for r in range(WORLD)]
    from_tp = dryrun.run_case("ctc", 1, work, steps=DRYRUN_STEPS,
                              resume_from=work / "ctc_w4_f2_m2" / "ckpt", tag="_from_tp")
    return {"src": src, "dst": dst, "work": work, "ranks": ranks, "jax": jax_out, "ref": ref,
            "from_tp": from_tp}


# ------------------------------------------------------------------ rules

_PARAMS = {}
# a joint model whose vocab (32) divides by 2 and 4, as the published 4,336
JOINT_PLACED = dict(vocab_size=32, d_model=64, num_layers=2, decoder_layers=1, num_heads=4,
                    mlp_dim=128, conv_channels=32, dtype="float32")


def _jax_params(family: str, adapter: str):
    key = (family, adapter)
    if key not in _PARAMS:
        ad = jcfg.AdapterConfig(kind=adapter, wf_rank=4, att_num_heads=2, att_key_dim=16)
        if family == "whisper":
            cfg = dataclasses.replace(JCFG, whisper=dataclasses.replace(JCFG.whisper, adapter=ad))
        elif family == "joint":
            cfg = jcfg.ExperimentConfig(model_family="joint", joint=jcfg.JointModelConfig(
                **JOINT_PLACED, adapter=ad))
        else:
            cfg = jcfg.ExperimentConfig(ctc_model=jcfg.CTCModelConfig(
                vocab_size=24, d_model=64, num_layers=2, num_heads=4, mlp_dim=128,
                conv_channels=32, dtype="float32", adapter=ad))
        _PARAMS[key] = _np(JBundle._init_params(cfg))
    return _PARAMS[key]


def _spec(sharding, nd):
    spec = tuple(sharding.spec)
    return spec + (None,) * (nd - len(spec))


@pytest.mark.parametrize("fsdp", [1, 2])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("adapter", ["none", "wf", "att"])
@pytest.mark.parametrize("family", ["whisper", "ctc", "joint"])
def test_placement_of_every_parameter_matches_jax(family, adapter, tp, fsdp):
    """Every parameter's placement by the port's rules (its name and JAX's
    shape) equals tp_param_sharding's and fsdp_tp_sharding's spec; the
    port model's own split set is the parameters JAX splits over model."""
    params = _jax_params(family, adapter)
    mesh = jmesh.build_mesh(jcfg.MeshConfig(fsdp_axis=fsdp, model_axis=tp), jax.devices())
    to_key = {"whisper": convert.whisper_torch_key,
              "joint": convert.joint_torch_key}.get(family, convert.torch_key)
    tp_sh = jax.tree_util.tree_leaves_with_path(tp_param_sharding(mesh, params))
    both = jax.tree_util.tree_leaves_with_path(fsdp_tp_sharding(mesh, params))
    leaves = {tuple(str(getattr(k, "key", k)) for k in kp): v
              for kp, v in jax.tree_util.tree_leaves_with_path(params)}
    split = set()
    for (kp, a), (_, b) in zip(tp_sh, both):
        path = tuple(str(getattr(k, "key", k)) for k in kp)
        shape, name = leaves[path].shape, to_key(path)
        assert tp_rules.tp_placement(name, shape, tp) == _spec(a, len(shape)), name
        assert tp_rules.fsdp_tp_placement(name, shape, tp, fsdp) == _spec(b, len(shape)), name
        if "model" in _spec(a, len(shape)):
            split.add(name)
    assert split, "no parameter split over model"
    port = _port_model(family, adapter)
    assert set(ttp.split_dims(port, tp)) == split


def _port_model(family, adapter):
    ad = tcfg.AdapterConfig(kind=adapter, wf_rank=4, att_num_heads=2, att_key_dim=16)
    if family == "whisper":
        return WhisperModel(tcfg.WhisperConfig(**{**dataclasses.asdict(JCFG.whisper),
                                                  "adapter": ad}))
    if family == "joint":
        return JointCTCAttentionModel(tcfg.JointModelConfig(**JOINT_PLACED, adapter=ad))
    return CTCEncoderModel(tcfg.CTCModelConfig(vocab_size=24, d_model=64, num_layers=2,
                                               num_heads=4, mlp_dim=128, conv_channels=32,
                                               dtype="float32", adapter=ad))


@pytest.mark.parametrize("case", ["step", "train_loop"])
def test_split_shards_and_adam_moments_follow_the_rules(runs, case):
    """On the ranks, each parameter holds its model-axis part (the whole
    shape over tp along the split dim) sharded over fsdp along the dim
    fsdp_tp_sharding gives (else dim 0), and Adam's moments have their
    parameter's shape and placements (JAX's opt_state_sharding)."""
    tp = 2
    fsdp = 2 if case == "train_loop" else 1
    whole = (_port_model("whisper", "none") if case == "step"
             else CTCEncoderModel(tcfg.CTCModelConfig(
                 vocab_size=runs["ranks"][0]["train_loop"]["placements"]["ctc_head.kernel"]
                 ["shape"][1], d_model=64, num_layers=1, num_heads=4, mlp_dim=128,
                 conv_channels=32, dtype="float32", adapter=tcfg.AdapterConfig(kind="wf",
                                                                               wf_rank=4))))
    shapes = {n: tuple(p.shape) for n, p in whole.named_parameters()}
    for rank in runs["ranks"]:
        recs = rank[case]["placements"]
        assert set(recs) == set(shapes)
        moments = 0
        for name, rec in recs.items():
            spec = tp_rules.fsdp_tp_placement(name, shapes[name], tp, fsdp)
            want = [s // tp if p == "model" else s for s, p in zip(shapes[name], spec)]
            assert rec["shape"] == want, name
            dim = spec.index("fsdp") if "fsdp" in spec else 0
            assert rec["placements"][-1] in (f"S({dim})", f"Shard(dim={dim})"), (name, rec)
            for shape, placements in rec["moments"]:
                assert shape == rec["shape"] and placements == rec["placements"], name
                moments += 1
        assert moments >= 2 * sum(p.requires_grad for p in whole.parameters()) or \
            case == "train_loop"


# ------------------------------------------------------------- the paths


def test_tp_step_matches_jax_one_device(runs):
    """One train step at data 2 x model 2 from JAX's weights: the global
    loss within 2e-5 of JAX's one-device step on every rank, every updated
    parameter within 1e-4 (tests/test_tp.py's bars)."""
    want = runs["jax"]
    for rank in runs["ranks"]:
        assert rank["step"]["mesh"] == [2, 1, 2]
        assert abs(rank["step"]["loss"] - want["step_loss"]) < STEP_LOSS_BAR
    with np.load(runs["dst"] / "step_params.npz") as got:
        assert sorted(got.files) == sorted(want["step_params"])
        worst = max(float(np.abs(got[k] - want["step_params"][k].numpy()).max())
                    for k in got.files)
    assert worst < STEP_PARAM_BAR, worst
    assert runs["ranks"][0]["step"]["tp_dims"]["decoder.embed_tokens.embedding"] == 0


def test_sharded_greedy_matches_jax(runs):
    """Greedy decode of a model split over 2 ranks (2 of 4 heads each) on
    each data rank's rows: JAX's one-device tokens and lengths."""
    for rank in runs["ranks"]:
        g = rank["greedy"]
        assert g["local_heads"] == 2
        assert g["tokens"] == runs["jax"]["tokens"]
        assert g["lengths"] == runs["jax"]["lengths"]


def test_bundle_shard_transcribe_matches_jax(runs):
    """ModelBundle.shard() on a data 2 x model 2 mesh, then transcribe of
    four WAVs (two a data rank): JAX's texts, on every rank; save() of the
    split bundle writes the whole weights."""
    for rank in runs["ranks"]:
        assert rank["transcribe"]["mesh"] == [2, 1, 2]
        assert rank["transcribe"]["texts"] == runs["jax"]["texts"]
    # saved whole: the weights it was split from, bit for bit
    saved = convert.read_npz_params(runs["dst"] / "sharded_bundle" / "params.npz")
    whole = convert.read_npz_params(runs["src"] / "whisper.npz")
    flat = convert.flatten_params
    assert sorted(flat(saved)) == sorted(flat(whole))
    for k, v in flat(whole).items():
        np.testing.assert_array_equal(flat(saved)[k], v)


def test_train_loop_at_fsdp_and_model_axes_matches_jax(runs):
    """train_loop at fsdp 2 x model 2 (WF adapters trained): the last loss
    within 1e-4 of JAX's one-device train_loop on every rank, the CTC head
    and every adapter within 1e-4 (tests/test_mesh_train.py's bars)."""
    want = runs["jax"]
    for rank in runs["ranks"]:
        rec = rank["train_loop"]
        assert rec["mesh"] == [1, 2, 2] and len(rec["losses"]) == 4
        assert abs(rec["losses"][-1] - want["loop_loss"]) < LOOP_BAR
        assert "blocks.0.self_attn.q_proj.kernel" in rec["split"]
    with np.load(runs["dst"] / "loop_params.npz") as got:
        for k in got.files:
            if "adapter" in k or k.startswith("ctc_head"):
                assert np.abs(got[k] - want["loop_params"][k].numpy()).max() < LOOP_BAR, k


@pytest.mark.parametrize("case,family", [("ctc:2x2", "ctc"), ("whisper:1x2", "whisper")])
def test_dryrun_model_axis_gives_the_one_process_losses(runs, case, family):
    """The dry run's TP cases (fsdp 2 x model 2; data 2 x model 2 for the
    Whisper model, whose ranks hold different target counts): each step's
    global loss and pre-clip gradient norm equal the one-process run's;
    every rank logs the same losses."""
    recs = [r["dryrun"][case] for r in runs["ranks"]]
    ref = runs["ref"][family]
    primary = recs[0]
    assert primary["mesh"] == ([1, 2, 2] if case == "ctc:2x2" else [2, 1, 2])
    np.testing.assert_allclose(primary["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(primary["grad_norms"], ref["grad_norms"], **BAR)
    for r in recs:
        np.testing.assert_allclose(r["losses"], primary["losses"], rtol=1e-6, atol=0)


def test_tp_checkpoint_resumes_in_one_process_in_lockstep(runs):
    """ctc:2x2's step-2 checkpoint restored in one process continues with
    the one-process run's own resume's losses and norms."""
    ref, got = runs["ref"]["ctc_resumed"], runs["from_tp"]
    assert ref["final_step"] == got["final_step"] == 2 * DRYRUN_STEPS
    np.testing.assert_allclose(got["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], **BAR)


def test_one_process_checkpoint_resumes_under_tp_in_lockstep(runs):
    ref = runs["ref"]["ctc_resumed"]
    recs = [r["dryrun"]["ctc:2x2_resumed"] for r in runs["ranks"]]
    assert all(r["final_step"] == 2 * DRYRUN_STEPS for r in recs)
    np.testing.assert_allclose(recs[0]["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(recs[0]["grad_norms"], ref["grad_norms"], **BAR)


def test_tp_checkpoint_is_the_one_process_layout(runs):
    """The TP run's state.pt holds the one-process keys and whole shapes
    (model, Adam's state by integer id), values within 1e-4."""
    from jiao_liao_speech_recognition_torch.train.checkpoints import TrainCheckpointer

    def blob(name):
        d = TrainCheckpointer(str(runs["work"] / name / "ckpt")).dir
        return torch.load(d / f"{DRYRUN_STEPS:08d}" / "state.pt", weights_only=False)

    a, b = blob("ctc_w1_f1"), blob("ctc_w4_f2_m2")
    assert list(a["model"]) == list(b["model"]) and b["step"] == DRYRUN_STEPS
    for k, v in a["model"].items():
        assert v.shape == b["model"][k].shape and not hasattr(b["model"][k], "to_local")
        np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), rtol=0, atol=1e-4)
    assert list(a["optimizer"]["state"]) == list(b["optimizer"]["state"])
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert tuple(v.shape) == tuple(b["optimizer"]["state"][i][k].shape), (i, k)


def test_dropout_masks_equal_within_a_model_group(runs):
    """With dropout 0.1 in training (MLP hidden units split, bottleneck
    slots replicated), the two ranks of a model group give the same
    log-probs, and each equals the unsplit model's under the same seed (the
    split dropout keeps its rank's columns of the whole layer's mask);
    the two data ranks, seeded apart, differ."""
    ranks = runs["ranks"]
    out = [np.asarray(r["dropout"]["split"]) for r in ranks]
    np.testing.assert_array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[2], out[3])
    for r, o in zip(ranks, out):
        np.testing.assert_allclose(o, np.asarray(r["dropout"]["whole"]), rtol=0, atol=1e-5)
    assert np.abs(out[0] - out[2]).max() > 1e-3


def test_cli_train_multihost_takes_a_model_axis(runs):
    """`cli train --multihost` of configs/adapter_finetune.yaml (tiny
    widths) with mesh.model_axis=2 on the four ranks: rc 0 everywhere, a
    loss a step on a 2 x 1 x 2 mesh, and the primary's final bundle loads
    in one process (unsharded, with the warning) and transcribes."""
    from jiao_liao_speech_recognition_torch import api

    assert [r["cli"] for r in runs["ranks"]] == [0] * WORLD
    recs = [json.loads(x) for x in (runs["dst"] / "cli.jsonl").read_text().splitlines()]
    assert sum("loss" in r for r in recs) == 2
    with pytest.warns(UserWarning, match="no process group"):
        bundle = api.load(str(runs["dst"] / "cli_ckpt" / "final"), device="cpu")
    assert bundle.config.mesh.model_axis == 2 and bundle.mesh is None
    assert len(bundle.transcribe([str(runs["src"] / "r0.wav")])) == 1


# ------------------------------------------------- split Whisper serving


def test_int8_split_in_both_orders_is_jax_quantize(runs):
    """At model 4, quantize() then shard() and shard() then quantize() give
    every rank the same buffers bit for bit (a row layer's scales taken
    over the whole column), and the int8 decoder joined over the group is
    JAX's quantize() of the same weights bit for bit."""
    for rank in runs["ranks"]:
        rec = rank["int8"]
        assert rec["orders_bitwise"] and rec["tp_dims"] == rec["tp_dims_before"]
        assert rec["heads"] == 1 and rec["local_vocab"] == 16 and rec["fc2_rows"] == 32
    want = {k: v for k, v in runs["jax"]["int8_state"].items() if k.startswith("decoder.")}
    with np.load(runs["dst"] / "int8_joined.npz") as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.numpy().dtype, k
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_placements_are_jax_shard_then_quantize(runs, tp):
    """Each int8 leaf of JAX's bundle.shard(mesh).quantize() on the CPU-8
    mesh is split over model where the port's rules split it (kernel_q as
    its kernel, a column layer's scale and bias with its columns, a row
    layer's scale whole, the int8 table and its scales by vocab rows); at
    model 4 the worker's split int8 model holds those dims."""
    mesh = jmesh.build_mesh(jcfg.MeshConfig(model_axis=tp), jax.devices())
    jb = JBundle(config=JCFG, params=JBundle._init_params(JCFG), tokenizer=None)
    qparams = jb.shard(mesh).quantize().params
    want = {}
    for kp, leaf in jax.tree_util.tree_leaves_with_path(qparams):
        path = tuple(str(getattr(k, "key", k)) for k in kp)
        spec = _spec(leaf.sharding, leaf.ndim)
        name = convert.whisper_torch_key(path)
        dim = spec.index("model") if "model" in spec else None
        assert tp_rules.model_dim(tp_rules.tp_placement(name, leaf.shape, tp)) == dim, name
        if dim is not None:
            want[name] = dim
    assert any(k.endswith("kernel_q") for k in want) and "decoder.embed_tokens.scale" in want
    assert not any(k.endswith("fc2.scale") or k.endswith("out_proj.scale") for k in want)
    if tp == 4:
        assert runs["ranks"][0]["int8"]["tp_dims"] == want


def test_int8_split_greedy_and_row_partials_match_jax(runs):
    """The split int8 model's greedy tokens (model 4, every rank) are JAX's
    quantized greedy_generate's; block 0's fc2 row partials summed over the
    four ranks and rounded once are within 1 bf16 ulp of JAX's K10 (its
    Pallas kernel in interpret mode) on the same input."""
    from test_torch_quant import _ulps

    for rank in runs["ranks"]:
        assert rank["int8"]["tokens"] == runs["jax"]["int8_tokens"]
        assert rank["int8"]["lengths"] == runs["jax"]["int8_lengths"]
    st = runs["jax"]["int8_state"]
    q = jnp.asarray(st["decoder.blocks.0.mlp.fc2.kernel_q"].numpy())
    scale = jnp.asarray(st["decoder.blocks.0.mlp.fc2.scale"].numpy())
    x = np.random.RandomState(23).randn(8, 128).astype(np.float32)
    want = np.asarray(jq._int8_matmul_pallas(jnp.asarray(x, jnp.bfloat16), q, scale), np.float32)
    for rank in runs["ranks"]:
        assert _ulps(rank["int8"]["fc2_summed"], want) <= 1.0


def test_split_int8_wf_layers_take_the_split_wf_route(runs):
    """A WF-adapted model quantized after a data 2 x model 2 split (its
    inserts whole beside each split Int8Dense): its greedy tokens on every
    rank are JAX's quantized greedy_generate's of the same weights (JAX's
    quantize() keeps each adapter_wf beside its dense_q), as
    tests/test_torch_whisper_train.py holds the unsplit model; and its
    decode-step logits are those of the same model quantized whole, within
    LOGIT_REL_BAR of their largest (bf16 roundings of the row layers' sums
    flip by an ulp where the split sums in another order), while the
    inserts move the logits far more than that."""
    want = runs["jax"]["int8_wf_tokens"]
    assert len({t for row in want for t in row}) > 1
    for rank in runs["ranks"]:
        rec = rank["int8_wf"]
        assert rec["tokens"] == want and rec["lengths"] == runs["jax"]["int8_wf_lengths"]
        assert rec["rel_err"] <= LOGIT_REL_BAR < rec["inserts_move"], rec


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_split_engine_texts_are_the_jax_engines(runs, dtype):
    """ServingEngine on a data 2 x model 2 bundle (bf16, and quantized after
    the split): every rank's texts are the JAX engine's on one device."""
    want = runs["jax"][f"engine_{dtype}"]
    assert len(set(want)) > 1
    for rank in runs["ranks"]:
        assert rank["serving"][f"engine_{dtype}"] == want


def test_split_beam_matches_jax(runs):
    """beam_from_enc on the split model over JAX's encoder output: JAX's
    tokens and lengths on every rank, scores within 1e-5."""
    tokens, lengths, scores = runs["jax"]["beam"]
    for rank in runs["ranks"]:
        got = rank["serving"]["beam"]
        assert got["tokens"] == tokens and got["lengths"] == lengths
        np.testing.assert_allclose(got["scores"], scores, rtol=0, atol=BEAM_SCORE_BAR)


def test_split_transcribe_timed_matches_jax(runs):
    """transcribe_timed on the split bundle (q and k joined at the hooks):
    JAX's tokens and times on every rank."""
    want = runs["jax"]["timed"]
    assert any(want)
    for rank in runs["ranks"]:
        assert rank["serving"]["timed"] == want


@pytest.mark.parametrize("name", ["serve_int8", "transcribe_timestamps"])
def test_cli_multihost_serving_matches_one_process(runs, name, capsys):
    """`cli serve --multihost --int8` and `cli transcribe --multihost
    --timestamps` of the split bundle (data 2 x model 2): rc 0 on every
    rank, the primary alone prints, and its lines (latency aside) are the
    one-process run's."""
    ranks = [r["cli_serve"][name] for r in runs["ranks"]]
    assert [r["rc"] for r in ranks] == [0] * WORLD
    assert all(r["lines"] == [] for r in ranks[1:])
    wavs = sorted(str(p) for p in runs["src"].glob("u*.wav"))
    ckpt = str(runs["dst"] / "serve_bundle")
    argv = (["serve", *wavs, "--checkpoint", ckpt, "--slots", "2", "--steps-per-dispatch", "3",
             "--int8"] if name == "serve_int8"
            else ["transcribe", *wavs, "--checkpoint", ckpt, "--timestamps"])
    capsys.readouterr()
    with pytest.warns(UserWarning, match="no process group"):
        assert cli.main([*argv, "--device", "cpu"]) == 0
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    got = [json.loads(x) for x in ranks[0]["lines"]]
    for rec in want + got:
        rec.pop("latency_s", None)
    assert len(got) == len(wavs) and sorted(got, key=str) == sorted(want, key=str)


# -------------------------------------------- split CTC and joint paths


@pytest.mark.parametrize("tag", ["data2_model2", "model4", "banded"])
def test_split_streaming_transcriber_matches_jax_after_every_feed(runs, tag):
    """StreamingTranscriber on the split CTC bundle (data 2 x model 2, model
    4, and a banded model's module-path attention on its heads): after every
    feed and at finish, every rank's committed tokens, spans, texts,
    preview, frames and silence are JAX's one-device transcriber's."""
    want = runs["jax"][f"stream_banded_{tag == 'banded'}"]
    assert want[-1][0] and want[-1][7]  # tokens committed, and the final result
    for rank in runs["ranks"]:
        assert rank["ctc_split"][f"stream_{tag}"] == want


def test_split_streaming_pool_matches_jax_pool_after_every_step(runs):
    """StreamingPool on the split CTC bundle (the device ring, stepped
    eagerly on the CPU): every rank's results after every step and final
    texts are JAX's one-device pool's."""
    want = runs["jax"]["pool"]
    assert any(want["texts"]) and len(want["steps"]) > 5
    for rank in runs["ranks"]:
        assert rank["ctc_split"]["heads"] == 2 and rank["ctc_split"]["pool_ring"]
        assert rank["ctc_split"]["pool"] == want


@pytest.mark.parametrize("route", list(tw.BEAM_ROUTES))
def test_split_ctc_beams_match_jax(runs, route):
    """The three CTC prefix beam routes on the split CTC bundle: each rank's
    ids and lengths for its data rank's rows are JAX's (its device beam,
    and its host searcher, bare and with the n-gram LM fused) on those
    rows of the whole batch."""
    want = runs["jax"][f"ctc_{route}"]
    assert any(want["lens"])
    for rank in runs["ranks"]:
        rec = rank["ctc_split"]
        a, b = rec["beam_rows"]
        assert b - a == 2
        assert rec[route]["ids"] == want["ids"][a:b], route
        assert rec[route]["lens"] == want["lens"][a:b], route


@pytest.mark.parametrize("case", ["greedy_data2_model2", "greedy_model4", "spec_greedy"])
def test_split_joint_greedy_and_spec_greedy_match_jax(runs, case):
    """The split joint model's greedy (data 2 x model 2: 2 heads and 16 vocab
    rows a rank; model 4: 1 and 8) and spec_greedy tokens and lengths are
    JAX's on every rank."""
    want = runs["jax"]["spec_greedy" if case == "spec_greedy" else "joint_greedy"]
    assert len({t for row in want["tokens"] for t in row}) > 1
    for rank in runs["ranks"]:
        got = rank["joint_split"][case]
        assert got["tokens"] == want["tokens"] and got["lengths"] == want["lengths"]
        if case != "spec_greedy":
            tp = 4 if case.endswith("model4") else 2
            assert got["heads"] == 4 // tp and got["vocab_rows"] == 32 // tp


def test_split_joint_beam_matches_jax(runs):
    """The split joint model's AR beam: every hypothesis and length is JAX's,
    the summed log-probs and the CTC rescoring's NLLs within 1e-5, and
    joint_beam's picks are JAX's, on every rank."""
    want = runs["jax"]["joint_hyps"]
    for rank in runs["ranks"]:
        got = rank["joint_split"]["hyps"]
        assert got["tokens"] == want["tokens"] and got["lengths"] == want["lengths"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=BEAM_SCORE_BAR)
        np.testing.assert_allclose(got["nll"], want["nll"], rtol=0, atol=BEAM_SCORE_BAR)
        assert rank["joint_split"]["joint_beam"] == runs["jax"]["joint_beam"]


def test_split_joint_pool_matches_jax_pool(runs):
    """The split joint bundle's CTC branch through StreamingPool: every
    rank's results after every step are JAX's joint pool's."""
    want = runs["jax"]["joint_pool"]
    assert any(want["texts"])
    for rank in runs["ranks"]:
        assert rank["joint_split"]["pool"] == want


def test_joint_train_loop_at_fsdp_and_model_axes_matches_jax(runs):
    """The joint family's train_loop at fsdp 2 x model 2 (WF adapters
    trained, the hybrid loss): the last loss within 1e-4 of JAX's
    one-device train_loop on every rank, the CTC head and every adapter
    within 1e-4 (the bars of the CTC family's case)."""
    want = runs["jax"]
    for rank in runs["ranks"]:
        rec = rank["joint_split"]["train_loop"]
        assert rec["mesh"] == [1, 2, 2] and len(rec["losses"]) == 4
        assert abs(rec["losses"][-1] - want["joint_loop_loss"]) < LOOP_BAR
        assert {"enc_blocks.0.self_attn.q_proj.kernel", "dec_blocks.0.cross_attn.k_proj.kernel",
                "embed_tokens.embedding"} <= set(rec["split"])
    checked = 0
    with np.load(runs["dst"] / "joint_loop_params.npz") as got:
        for k in got.files:
            if "adapter" in k or k.startswith("ctc_head"):
                want_k = want["joint_loop_params"][k].numpy()
                assert np.abs(got[k] - want_k).max() < LOOP_BAR, k
                checked += 1
    assert checked > 10


@pytest.mark.parametrize("name", ["stream", "beam"])
def test_cli_multihost_ctc_matches_one_process(runs, name, capsys):
    """`cli transcribe --multihost --stream` and `--strategy beam` of the
    split CTC bundle (data 2 x model 2): rc 0 on every rank, the primary
    alone prints, and its lines are the one-process run's."""
    ranks = [r["cli_ctc"][name] for r in runs["ranks"]]
    assert [r["rc"] for r in ranks] == [0] * WORLD
    assert all(r["lines"] == [] for r in ranks[1:])
    wavs = sorted(str(p) for p in runs["src"].glob("r*.wav"))[:2]
    ckpt = str(runs["dst"] / "ctc_bundle")
    argv = (["transcribe", *wavs, "--checkpoint", ckpt, "--stream", "--stream-window",
             str(tw.STREAM[0]), "--stream-hop", str(tw.STREAM[1]), "--stream-lookahead",
             str(tw.STREAM[2])] if name == "stream"
            else ["transcribe", *wavs, "--checkpoint", ckpt, "--strategy", "beam",
                  "--beam-size", "4"])
    capsys.readouterr()
    with pytest.warns(UserWarning, match="no process group"):
        assert cli.main([*argv, "--device", "cpu"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(want) >= len(wavs) and ranks[0]["lines"] == want


# ------------------------------------------------------------ CPU only


@pytest.mark.parametrize("width", [320, 640, 384])
def test_padded_qkv_pack_equals_unpadded(width):
    """pack_qkv(pad_to=128) at a rank's width (3 x 320 = 960 at large-v3 on
    four ranks): K5's plain version reads the same q, k and v, bit for
    bit, and the pad columns are zero."""
    rng = np.random.RandomState(width)
    t = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
         for s in ((256, width),) * 3 + ((width,),) * 2]
    wq, wk, wv, bq, bv = t
    x = torch.from_numpy(rng.randn(2, 5, 256).astype(np.float32)).to(torch.bfloat16)
    g, b = torch.ones(256), torch.zeros(256)
    w0, b0 = tfm.pack_qkv(wq, bq, wk, wv, bv)
    w1, b1 = tfm.pack_qkv(wq, bq, wk, wv, bv, pad_to=128)
    assert w1.shape[1] % 128 == 0 and w1.shape[1] - 3 * width < 128
    assert not w1[:, 3 * width:].any() and not b1[3 * width:].any()
    for a, c in zip(tfm.ln_qkv_plain(x, g, b, w0, b0), tfm.fused_ln_qkv(x, g, b, w1, b1,
                                                                          width=width)):
        assert torch.equal(a, c)


def test_split_wf_block_keeps_its_folds_until_an_insert_changes():
    """A split WF block's folded serving operands (packed q/k/v, wo, fc1,
    fc2) are built once and kept until a kernel or an insert changes in
    place; then they are built anew and equal a fresh fold."""
    from jiao_liao_speech_recognition_torch.models.layers import TransformerBlock

    gen = torch.Generator().manual_seed(0)
    block = TransformerBlock(64, 4, 128, gen, adapter=tcfg.AdapterConfig(kind="wf", wf_rank=4))
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("adapter_wf.b"):
                p.normal_(0.0, 0.1, generator=gen)
    ttp.apply_tp(block, ttp.TPGroup(1, 2))
    bf = torch.bfloat16
    with torch.no_grad():
        attn, mlp = block._attention_weights(bf), block._mlp_weights(bf)
        assert block._attention_weights(bf) is attn and block._mlp_weights(bf) is mlp
        block.self_attn.q_proj.adapter_wf.b.add_(0.5)
        block.mlp.fc2.adapter_wf.g.mul_(2.0)
        attn2, mlp2 = block._attention_weights(bf), block._mlp_weights(bf)
        q = block._folded(block.self_attn.q_proj, torch.float32).to(bf)
        assert not torch.equal(attn2[0][:, :q.shape[1]], attn[0][:, :q.shape[1]])
        assert torch.equal(attn2[0][:, :q.shape[1]], q)
        assert torch.equal(mlp2[0], mlp[0]) and not torch.equal(mlp2[1], mlp[1])
        assert torch.equal(mlp2[1], block._folded(block.mlp.fc2, bf))


def test_split_model_refuses_only_what_cannot_run():
    """A split joint bundle (rank 0 of 2, no collective run) is split like
    the other families; heads that do not divide raise ValueError; and a
    model group played in one process (a stand-in group) is refused by name
    where a card would capture its step in a CUDA graph (the streaming
    pool's ring step, the serving engine's decode step) until graph=False
    asks for the eager step."""
    from types import SimpleNamespace

    from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel
    from jiao_liao_speech_recognition_torch.serve.engine import ServingEngine
    from jiao_liao_speech_recognition_torch.serve.streaming import StreamingPool

    class Mesh:  # data 1 x fsdp 1 x model 2, rank 0, no process group
        def size(self, dim):
            return (1, 1, 2)[dim]

        def get_coordinate(self):
            return [0, 0, 0]

        def get_group(self, dim):
            return None

    joint = ModelBundle(tcfg.ExperimentConfig(model_family="joint"), JointCTCAttentionModel(
        tcfg.JointModelConfig(vocab_size=24, d_model=64, num_layers=1, decoder_layers=1,
                              num_heads=4, mlp_dim=128, conv_channels=32)), None)
    joint.shard(Mesh())
    assert joint.model.enc_blocks[0].self_attn.num_heads == 2
    assert joint.model.embed_tokens.embedding.shape == (12, 64)
    assert "ctc_head.kernel" not in joint.model.tp_dims
    odd = CTCEncoderModel(tcfg.CTCModelConfig(vocab_size=24, d_model=96, num_layers=1,
                                              num_heads=3, mlp_dim=128, conv_channels=32))
    with pytest.raises(ValueError, match="heads do not divide"):
        ttp.apply_tp(odd, ttp.TPGroup(0, 2))

    class StandIn:  # one process's stand-in for the group's collectives
        def all_reduce(self, t):
            return t

        def all_gather(self, t):
            return [t, t]

    ctc = CTCEncoderModel(tcfg.CTCModelConfig(vocab_size=24, d_model=64, num_layers=1,
                                              num_heads=4, mlp_dim=128, conv_channels=32))
    ttp.apply_tp(ctc, ttp.TPGroup(0, 2, StandIn()))
    on_card = SimpleNamespace(model=ctc, device=torch.device("cuda"), is_whisper=True,
                              config=tcfg.ExperimentConfig())
    for cls in (StreamingPool, ServingEngine):
        with pytest.raises(ValueError, match="stand-in model group"):
            cls(on_card, graph=True)
    ttp.check_capturable(ctc, torch.device("cpu"), "StreamingPool")  # the CPU steps eagerly
