"""The port's elastic launcher (paddle_tpu_torch/distributed/launch.py)
driving its drill worker (paddle_tpu_torch/distributed/elastic_worker.py)
through a kill, on the CPU.

One ``--elastic`` launch of a 2-layer GPT TrainStep (f32, dropout 0.1,
8 steps, an async checkpoint every 2) with PD_CHAOS_MODE=kill at step 3:
the supervisor sees the worker die, leaves exactly one remediation
receipt (verdict crash, action respawn_gang), and the respawned worker
resumes from the newest intact checkpoint and finishes with per-step
losses bit-equal to a control run of the same worker body. The control
runs in this process and the supervisor loop is the launcher's own
``launch()`` (the ``python -m`` entry calls nothing else), so the drill
pays for two worker interpreters only. Then the launcher's worker
environment: torch.distributed's variables beside the PADDLE_* ones.
"""
import glob
import json
import os

import pytest

from paddle_tpu_torch.distributed import elastic_worker, launch
from paddle_tpu_torch.observability import decisions

WORKER = elastic_worker.__file__
ARGS = ["--model", "tiny", "--device", "cpu", "--steps", "8",
        "--ckpt-every", "2", "--batch", "4", "--seq", "16"]


@pytest.fixture
def env(monkeypatch, tmp_path):
    for var in ("PD_CHAOS_MODE", "PD_CHAOS_STEP", "PD_CHAOS_RANK",
                "PD_CHAOS_EVERY", "PD_FR_DIR", "CUDA_VISIBLE_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PD_ELASTIC_DIR", str(tmp_path / "receipts"))
    monkeypatch.setenv("PD_FR_DIR", str(tmp_path / "flight"))
    was = decisions.enabled()
    yield monkeypatch
    decisions.reset()
    decisions.enable(was)


def test_kill_respawn_resume_equals_control(env, tmp_path):
    control = elastic_worker.run(elastic_worker.parse_args(
        ARGS + ["--ckpt-dir", str(tmp_path / "c_ckpt"),
                "--out-dir", str(tmp_path / "c_out")]))
    env.setenv("PD_CHAOS_MODE", "kill")
    env.setenv("PD_CHAOS_STEP", "3")
    env.setenv("PD_CHAOS_RANK", "0")
    out = tmp_path / "out"
    with pytest.raises(SystemExit) as ex:
        launch.launch(["--elastic", "--heartbeat_timeout", "10",
                       "--restart_backoff", "0.05", "--dump_grace", "0.2",
                       WORKER, "--ckpt-dir", str(tmp_path / "ckpt"),
                       "--out-dir", str(out), *ARGS])
    assert ex.value.code == 0
    receipts = [json.load(open(f)) for f in glob.glob(
        str(tmp_path / "receipts" / "receipt_*.json"))]
    assert len(receipts) == 1
    (rec,) = receipts
    assert rec["action"] == "respawn_gang"
    assert rec["verdict"]["kind"] == "crash"
    assert rec["verdict"]["rank"] == 0
    assert rec["decision_id"]
    first = json.load(open(out / "inc0_slot0.json"))
    second = json.load(open(out / "inc1_slot0.json"))
    assert not first["done"] and second["done"]
    # the kill at step 3 struck after step 1's save had committed;
    # step 3's had not been made
    assert sorted(int(s) for s in first["losses"]) == [0, 1, 2]
    assert second["resume_step"] == 1
    assert second["candidate_steps"][0] == 1
    assert sorted(int(s) for s in second["losses"]) == list(range(2, 8))
    losses = {**first["losses"], **second["losses"]}
    assert losses == control["losses"]
    for inc in (first, second):
        assert inc["graphs"] == 1 and inc["sentinel_events"] == 0
    # the progress log: step 3 began in incarnation 0 and never ended
    lines = [json.loads(ln) for ln in open(out / "progress_slot0.jsonl")]
    assert {"step": 3, "phase": "begin", "inc": 0} in [
        {k: ln[k] for k in ("step", "phase", "inc")} for ln in lines]
    assert not any(ln["inc"] == 0 and ln["step"] == 3
                   and ln["phase"] == "end" for ln in lines)


def test_worker_env_sets_torch_distributed_variables():
    args = launch.parse_args(["--nproc_per_node", "2", "--master",
                              "10.0.0.1:6000", "train.py"])
    args.master_addr, args.master_port, args.cards = "10.0.0.1", 6000, []
    env = launch._worker_env(args, 1, 2, {"PADDLE_TRAINER_ID": "0",
                                          "PADDLE_TRAINERS_NUM": "1"})
    assert env["MASTER_ADDR"] == "10.0.0.1"
    assert env["MASTER_PORT"] == "6000"
    assert env["LOCAL_RANK"] == env["PADDLE_LOCAL_RANK"] == "1"
    # the renumbered gang's rank and size, under both names
    assert env["RANK"] == env["PADDLE_TRAINER_ID"] == "0"
    assert env["WORLD_SIZE"] == env["PADDLE_TRAINERS_NUM"] == "1"
    # no card for local rank 1: no pin
    assert "CUDA_VISIBLE_DEVICES" not in env or \
        env["CUDA_VISIBLE_DEVICES"] == os.environ.get("CUDA_VISIBLE_DEVICES")
    args.cards = ["3", "5"]
    assert launch._worker_env(args, 1, 2)["CUDA_VISIBLE_DEVICES"] == "5"
