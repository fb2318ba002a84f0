"""The port's training loop in several processes on the CPU (gloo), held to
the same loop in one process: the dry run (``parallel/dryrun.py``) at
world 2 on data x fsdp meshes 2 x 1 and 1 x 2 and at world 4 on 2 x 2, for
a CTC model with SpecAugment and every waveform augmentation on and a
Whisper model whose processes hold different target counts; FSDP's
shards; checkpoints crossing the process count both ways; and
``parallel.multihost.initialize``'s topology sources.

Processes start as tests/multihost_worker.py's do (a free local port, a
deadline of their own); each holds a tiny f32 model (d 64, 2 blocks a
stack, a 32-symbol vocabulary)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import free_port, spawn  # noqa: E402

from jiao_liao_speech_recognition_torch.parallel import dryrun  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost as mh  # noqa: E402
from jiao_liao_speech_recognition_torch.train.checkpoints import TrainCheckpointer  # noqa: E402

# JAX's bar for N processes against one (tests/test_multihost.py): the
# same f32 arithmetic, sums taken across processes in another order
BAR = dict(rtol=2e-4, atol=1e-6)
DRYRUN = ["-m", "jiao_liao_speech_recognition_torch.parallel.dryrun", "--device", "cpu"]


def _dry(n, work, cases, steps=2):
    """The dry run's cases in n processes -> {case: [each rank's record]}."""
    argv = DRYRUN + ["--workdir", str(work), "--steps", str(steps)] + \
        [a for c in cases for a in ("--case", c)]
    out = {}
    for rank, (rc, text) in enumerate(spawn(argv, n, timeout=150)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{text[-4000:]}"
        for line in text.splitlines():
            if line.startswith("DRYRUN "):
                rec = json.loads(line[len("DRYRUN "):])
                out.setdefault(rec["case"], []).append(rec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process (this one, no group) for each family, 2 steps, then 2
    more from its checkpoint; world 2 and world 4 in subprocesses (world 2
    also resumes the one-process CTC checkpoint); one process resuming
    world 2's. The same for CTC with 2 micro-steps an update, 3 steps and
    3 more: its step-3 checkpoints hold a half-accumulated gradient."""
    work = tmp_path_factory.mktemp("dryrun")
    ref = {fam: dryrun.run_case(fam, 1, work) for fam in ("ctc", "whisper")}
    ckpt1 = work / "ctc_w1_f1" / "ckpt"
    ref["ctc_resumed"] = dryrun.run_case("ctc", 1, work, resume_from=ckpt1, tag="_resumed")
    w2 = _dry(2, work, ["ctc:1", "ctc:2", "whisper:1", "whisper:2", f"ctc:2@{ckpt1}"])
    w4 = _dry(4, work, ["ctc:2", "whisper:2"])
    from_w2 = dryrun.run_case("ctc", 1, work, resume_from=work / "ctc_w2_f2" / "ckpt",
                              tag="_from_w2")
    ref["ctc_a2"] = dryrun.run_case("ctc", 1, work, steps=3, accum=2)
    a2 = work / "ctc_w1_f1_a2" / "ckpt"
    ref["ctc_a2_resumed"] = dryrun.run_case("ctc", 1, work, steps=3, accum=2, resume_from=a2,
                                            tag="_resumed")
    w2a = _dry(2, work, ["ctc:2:2", f"ctc:2:2@{a2}"], steps=3)
    from_w2_a2 = dryrun.run_case("ctc", 1, work, steps=3, accum=2,
                                 resume_from=work / "ctc_w2_f2_a2" / "ckpt", tag="_from_w2")
    return {"work": work, "ref": ref, "w2": w2, "w4": w4, "from_w2": from_w2, "w2a": w2a,
            "from_w2_a2": from_w2_a2}


@pytest.mark.parametrize("family", ["ctc", "whisper"])
@pytest.mark.parametrize("data,fsdp", [(2, 1), (1, 2), (2, 2)])
def test_processes_give_the_one_process_losses_and_grad_norms(runs, family, data, fsdp):
    """Every step's loss (the global batch's, on every process) and
    pre-clip gradient norm equal the one-process loop's on the same
    batches: the clip's norm spans the fsdp shards, the CTC mean and the
    Whisper masked mean are the global batch's (the Whisper processes hold
    different target counts), and SpecAugment and the augmentation draw
    each row's values alike on any topology."""
    world = data * fsdp
    recs = runs[f"w{world}"][f"{family}:{fsdp}"]
    ref = runs["ref"][family]
    assert len(recs) == world and {r["rank"] for r in recs} == set(range(world))
    assert all(r["mesh"] == [data, fsdp, 1] and r["final_step"] == 2 for r in recs)
    primary = next(r for r in recs if r["rank"] == 0)
    np.testing.assert_allclose(primary["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(primary["grad_norms"], ref["grad_norms"], **BAR)
    for r in recs:  # the same global losses on every process
        np.testing.assert_allclose(r["losses"], primary["losses"], rtol=1e-6, atol=0)
    assert primary["checkpoints"] == ["00000002"]


def test_whisper_ranks_hold_different_target_counts(runs):
    """The premise of the Whisper case: the rows each process holds carry
    different numbers of targets, so a local masked mean would be wrong."""
    from jiao_liao_speech_recognition_torch.data.manifest import read_manifest
    from jiao_liao_speech_recognition_torch.data.pipeline import BatchIterator
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.utils.config import DataConfig

    manifest = read_manifest(str(runs["work"] / "train.jsonl"))
    tok = CharTokenizer.build(manifest.texts())
    cfg = DataConfig(batch_size=4, bucket_boundaries_seconds=(1.0,), max_audio_seconds=1.0,
                     min_audio_seconds=0.1, max_text_len=16)
    counts = [int(next(BatchIterator(manifest, tok, cfg, process_index=p,
                                     process_count=2)).label_lengths.sum()) for p in (0, 1)]
    assert counts[0] != counts[1], counts
    assert runs["ref"]["whisper"]["final_step"] == 2


@pytest.mark.parametrize("world,fsdp", [(2, 1), (2, 2), (4, 2)])
def test_fsdp_shards_parameters_and_adam_state(runs, world, fsdp):
    """At fsdp 2 each process holds about half of the >= 2-D parameters'
    elements and of Adam's moments (dim 0 padded where fsdp does not divide
    the largest axis); at fsdp 1 every process holds all of them."""
    for fam in ("ctc", "whisper"):
        recs = runs[f"w{world}"].get(f"{fam}:{fsdp}")
        if recs is None:
            continue
        for r in recs:
            for key in ("param_share", "adam_share"):
                assert abs(r[key] - 1.0 / fsdp) <= 0.05 / fsdp, (fam, r["rank"], key, r[key])
        assert sum(r["param_share"] for r in recs) == pytest.approx(world / fsdp, rel=1e-3)


def test_checkpoint_of_two_processes_resumes_in_one_in_lockstep(runs):
    """world 2's step-2 checkpoint, restored in one process, continues for
    2 steps with the one-process run's own resume's losses and norms."""
    ref, got = runs["ref"]["ctc_resumed"], runs["from_w2"]
    assert ref["final_step"] == got["final_step"] == 4
    np.testing.assert_allclose(got["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"], **BAR)
    assert got["checkpoints"] == ["00000002", "00000004"]


def test_checkpoint_of_one_process_resumes_in_two_in_lockstep(runs):
    ref = runs["ref"]["ctc_resumed"]
    recs = runs["w2"]["ctc:2_resumed"]
    primary = next(r for r in recs if r["rank"] == 0)
    assert all(r["final_step"] == 4 for r in recs)
    np.testing.assert_allclose(primary["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(primary["grad_norms"], ref["grad_norms"], **BAR)


def test_half_accumulated_gradients_cross_the_process_count(runs):
    """Two micro-steps an update: 3 steps at world 2 against one process,
    then each step-3 checkpoint (a gradient half accumulated, gathered from
    the shards or scattered into them) resumed on the other topology for 3
    more steps, in lockstep with the one-process resume."""
    ref, ref_r = runs["ref"]["ctc_a2"], runs["ref"]["ctc_a2_resumed"]
    w2 = next(r for r in runs["w2a"]["ctc:2_a2"] if r["rank"] == 0)
    w2_r = next(r for r in runs["w2a"]["ctc:2_a2_resumed"] if r["rank"] == 0)
    assert len(ref["grad_norms"]) == 1 and len(ref_r["grad_norms"]) == 2  # updates at 2, 4, 6
    np.testing.assert_allclose(w2["logged_losses"], ref["logged_losses"], **BAR)
    np.testing.assert_allclose(w2["grad_norms"], ref["grad_norms"], **BAR)
    for got in (w2_r, runs["from_w2_a2"]):
        assert got["final_step"] == 6 and got["checkpoints"][-1] == "00000006"
        np.testing.assert_allclose(got["logged_losses"], ref_r["logged_losses"], **BAR)
        np.testing.assert_allclose(got["grad_norms"], ref_r["grad_norms"], **BAR)
    blob = torch.load(runs["work"] / "ctc_w2_f2_a2" / "ckpt" / "00000003" / "state.pt",
                      weights_only=False)
    want = torch.load(runs["work"] / "ctc_w1_f1_a2" / "ckpt" / "00000003" / "state.pt",
                      weights_only=False)
    assert blob["grads"] and sorted(blob["grads"]) == sorted(want["grads"])
    for k, g in want["grads"].items():
        np.testing.assert_allclose(blob["grads"][k].numpy(), g.numpy(), rtol=1e-4, atol=1e-6)


def test_processes_write_the_one_process_checkpoint_layout(runs):
    """The primary of a wrapped model writes state.pt as one process does:
    the same keys, optimizer state keyed by integer, full tensors."""
    def blob(path):
        return torch.load(TrainCheckpointer(str(path)).dir / "00000002" / "state.pt",
                          weights_only=False)

    a = blob(runs["work"] / "ctc_w1_f1" / "ckpt")
    for d in ("ctc_w2_f2", "ctc_w4_f2"):
        b = blob(runs["work"] / d / "ckpt")
        assert sorted(a) == sorted(b) and b["step"] == 2
        assert list(a["model"]) == list(b["model"])
        for k, v in a["model"].items():
            assert v.shape == b["model"][k].shape and not hasattr(b["model"][k], "to_local")
            np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), rtol=0, atol=1e-4)
        assert list(a["optimizer"]["state"]) == list(b["optimizer"]["state"])
        assert a["optimizer"]["param_groups"][0]["params"] == \
            b["optimizer"]["param_groups"][0]["params"]
        assert b["extra"] == a["extra"]


# ------------------------------------------------------------ initialize


@pytest.fixture
def no_group(monkeypatch):
    for k in ("JL_COORDINATOR", "JL_NUM_PROCESSES", "JL_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not mh.is_initialized()
    yield monkeypatch
    mh.shutdown()


@pytest.mark.parametrize("source", ["jl", "torchrun", "arguments"])
def test_initialize_reads_its_topology_and_is_idempotent(no_group, source):
    port = free_port()
    kw = {}
    if source == "jl":
        no_group.setenv("JL_COORDINATOR", f"127.0.0.1:{port}")
        no_group.setenv("JL_NUM_PROCESSES", "1")
        no_group.setenv("JL_PROCESS_ID", "0")
    elif source == "torchrun":
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                     ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
            no_group.setenv(k, v)
    else:
        no_group.setenv("JL_COORDINATOR", "127.0.0.1:1")  # the arguments win
        kw = dict(coordinator_address=f"127.0.0.1:{port}", num_processes=1, process_id=0)
    assert mh.process_count() == 1 and mh.is_primary()
    mh.initialize(device="cpu", **kw)
    assert mh.is_initialized() and mh.device_type() == "cpu"
    assert torch.distributed.get_backend() == "gloo"
    assert (mh.process_index(), mh.process_count(), mh.is_primary()) == (0, 1, True)
    mh.initialize(device="cpu", coordinator_address="127.0.0.1:1")  # a no-op now
    mh.barrier()
    assert mh.any_process(True) and not mh.any_process(False)
    assert mh.broadcast_object({"a": 1}) == {"a": 1}


def test_initialize_without_topology_or_card_raises(no_group):
    with pytest.raises(ValueError, match="no topology"):
        mh.initialize(device="cpu")
    no_group.setenv("JL_COORDINATOR", f"127.0.0.1:{free_port()}")
    no_group.setenv("JL_NUM_PROCESSES", "1")
    no_group.setenv("JL_PROCESS_ID", "0")
    no_group.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.initialize()  # cuda is the default: it does not carry on without one
    assert not mh.is_initialized()
    mh.barrier()  # a no-op without a group
    assert mh.all_sum(torch.ones(2)).tolist() == [1.0, 1.0]


def test_dryrun_main_runs_one_process_without_a_group(tmp_path, capsys, monkeypatch):
    for k in ("JL_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert dryrun.main(["--workdir", str(tmp_path), "--device", "cpu", "--case", "ctc:1",
                        "--steps", "1"]) == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("DRYRUN ")]
    rec = json.loads(line[0][len("DRYRUN "):])
    assert rec["mesh"] == [1, 1, 1] and rec["final_step"] == 1
