"""The launcher of horovod_tpu_torch (``runner/launcher.py``) against the
reference's (``horovod_tpu.runner.launcher``), on the CPU.

* ``parse_hosts`` (string and hostfile) equal to the reference's.
* ``worker_commands``: one line per slot (the port runs one process per
  GPU; the reference one per host), with the port's env contract.
* ``run`` on two gloo ranks (per-rank logs, a failing rank's exit code, the
  start timeout) and ``run_func``; the CLI (``--check-build``,
  ``--dry-run``).
* One ``run_elastic`` relaunch on two CPU workers of a two-layer GPT-2
  (``tools/torch_elastic_worker.py --model tiny``), driven through the CLI
  (``--elastic -np 2 --spares 1``): ``kill@rank=1,step=3`` with one spare
  needs exactly one restart with the world kept at 2, and every loss, before
  the kill and after the restore, bit-identical to a golden run's (exact
  equality), the first attempt's one failure the planted SIGKILL. The
  port's counterpart of ``tools/preempt_smoke.py``; the golden run goes on
  beside the faulted one, each with its own timeout, under 60 s.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.runner import launcher as jl
from horovod_tpu_torch.runner import launcher as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_elastic_worker.py")


@pytest.mark.parametrize("spec", ["h1:4,h2:2", "a", " x:1 , y ,z:3,",
                                  "10.0.0.1:8"])
def test_parse_hosts_string_matches_reference(spec):
    assert [(h.host, h.slots) for h in pl.parse_hosts(spec)] == \
        [(h.host, h.slots) for h in jl.parse_hosts(spec)]


def test_parse_hostfile_matches_reference(tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# cluster\nnode1 slots=4\nnode2  # two by default? no\n"
                 "\nnode3 slots=2 extra=1\n")
    got = [(h.host, h.slots) for h in pl.parse_hosts(str(f))]
    assert got == [(h.host, h.slots) for h in jl.parse_hosts(str(f))]
    assert got == [("node1", 4), ("node2", 1), ("node3", 2)]


def test_worker_commands_one_line_per_slot():
    cmds = pl.worker_commands(["python", "train.py", "--lr", "0.1"],
                              pl.parse_hosts("h1:2,h2:1"), 29600,
                              extra_env={"HOROVOD_FAULT_PLAN": "a b"})
    assert cmds == [
        f"HOROVOD_FAULT_PLAN='a b' RANK={r} WORLD_SIZE=3 LOCAL_RANK={lr} "
        f"LOCAL_SIZE={ls} MASTER_ADDR=h1 MASTER_PORT=29600 python train.py "
        f"--lr 0.1" for r, lr, ls in ((0, 0, 2), (1, 1, 2), (2, 0, 1))]
    # the reference: one line per host
    assert len(jl.worker_commands(["python"], jl.parse_hosts("h1:2,h2:1"))) \
        == 2
    assert pl.run(["python", "t.py"], hosts="h1:2", dry_run=True) == \
        pl.worker_commands(["python", "t.py"], pl.parse_hosts("h1:2"),
                           pl.DEFAULT_PORT)


def test_build_worker_env():
    env = pl.build_worker_env(2, 4, "10.0.0.1:29500", base_env={"A": "1"})
    assert env == {"A": "1", "RANK": "2", "WORLD_SIZE": "4",
                   "LOCAL_RANK": "2", "LOCAL_SIZE": "4",
                   "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}
    env = pl.build_worker_env(5, 8, "h:1", base_env={}, local_rank=1,
                              local_size=4)
    assert (env["LOCAL_RANK"], env["LOCAL_SIZE"]) == ("1", "4")


def test_run_two_gloo_ranks_with_logs_and_failures(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time, torch
        sys.path.insert(0, {REPO!r})
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        s = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]), op=hvd.Sum)
        print("rank", hvd.rank(), "of", hvd.size(), "local",
              os.environ["LOCAL_RANK"], "sum", s.item(), flush=True)
        hvd.shutdown()
        if len(sys.argv) > 1 and sys.argv[1] == "fail" and \\
                os.environ["RANK"] == "1":
            sys.exit(7)
        if len(sys.argv) > 1 and sys.argv[1] == "hang":
            time.sleep(60)
    """))

    def launch(mode, timeout):
        logs = tmp_path / f"logs_{mode}"
        try:
            return pl.run([sys.executable, str(script), mode], np=2,
                          timeout=timeout, output_filename=str(logs))
        except (pl.WorkerFailed, TimeoutError) as e:
            return e

    # the three jobs at once: each is two processes that import torch
    with ThreadPoolExecutor(3) as ex:
        ok, fail, hang = ex.map(launch, ("ok", "fail", "hang"), (60, 60, 4))
    assert ok == 0
    for r in range(2):
        out = (tmp_path / "logs_ok" / f"rank.{r}" / "stdout").read_text()
        assert f"rank {r} of 2 local {r} sum 3.0" in out
    assert isinstance(fail, pl.WorkerFailed) and fail.code == 7
    assert isinstance(hang, TimeoutError)


def test_run_func_on_two_gloo_ranks():
    with ThreadPoolExecutor(2) as ex:
        ranks = ex.submit(pl.run_func, hvd.core.rank, np=2, device="cpu",
                          timeout=60)
        out = ex.submit(pl.run_func, hvd.allreduce,
                        args=(torch.arange(3.0),), kwargs={"op": hvd.Sum},
                        np=2, device="cpu", timeout=60)
        assert ranks.result() == [0, 1]
        assert all(torch.equal(t, 2 * torch.arange(3.0))
                   for t in out.result())


def _cli(*args, env=None):
    return subprocess.Popen([sys.executable, "-m", "horovod_tpu_torch.runner",
                             *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_cli_check_build_and_dry_run():
    check = _cli("--check-build")
    dry = _cli("-np", "2", "-H", "a:2", "--dry-run", "python", "x.py")
    out, _ = check.communicate(timeout=60)
    assert check.returncode == 0
    info = json.loads(out)
    assert info["gloo_built"] is True and info["backend"] is None
    out, _ = dry.communicate(timeout=60)
    assert dry.returncode == 0
    lines = out.strip().splitlines()
    assert len(lines) == 2 and lines[1].startswith(
        "RANK=1 WORLD_SIZE=2 LOCAL_RANK=1 LOCAL_SIZE=2 MASTER_ADDR=a")


def _lines(state_dir, name):
    with open(os.path.join(state_dir, name)) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_elastic_relaunch_with_a_spare_resumes_bit_identically(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_STALL_CHECK_DISABLE="1")
    cmd = [WORKER, "--model", "tiny", "--device", "cpu", "--steps", "5"]
    # the faulted run through the CLI, its state dir made under TMPDIR,
    # while the golden run goes on beside it
    faulted = tmp_path / "faulted"
    faulted.mkdir()
    env.update(TMPDIR=str(faulted),
               HOROVOD_FAULT_PLAN="kill@rank=1,step=3")
    cli = _cli("--elastic", "-np", "2", "--spares", "1", "--start-timeout",
               "50", *cmd, "--wait-spares", "1", env=env)
    golden = tmp_path / "golden"
    golden.mkdir()
    try:
        assert pl.run_elastic([sys.executable] + cmd, np=2,
                              state_dir=str(golden), timeout=50,
                              extra_env={"OMP_NUM_THREADS": "1"}) == 0
        _, err = cli.communicate(timeout=55)
    finally:
        if cli.poll() is None:
            cli.kill()
    want = {x["step"]: x["loss"] for x in _lines(golden, "steps.jsonl")
            if "event" not in x}
    assert sorted(want) == list(range(5))
    assert not (golden / "exits.jsonl").exists()
    assert cli.returncode == 0, err[-3000:]
    assert "finished after 1 restart(s)" in err
    (sdir,) = [p for p in faulted.iterdir()
               if p.name.startswith("hvd_torch_elastic_")]
    # the one failure was the planted SIGKILL of rank 1
    (ex,) = _lines(sdir, "exits.jsonl")
    assert ex["attempt"] == 0 and ex["exits"]["1"] == -signal.SIGKILL, ex
    lines = _lines(sdir, "steps.jsonl")
    runs = [x for x in lines if "event" not in x]
    promo = [x for x in lines if x.get("event") == "promoted"]
    done = [x for x in lines if x.get("event") == "done"]
    assert len(promo) == 1 and promo[0]["rank"] == 1 and \
        promo[0]["cuda_initialized_in_standby"] is False
    assert [d["attempt"] for d in done] == [1]
    assert done[0]["restored_step"] == max(
        done[0]["checkpoints_seen"]["published"])
    assert sorted(x["step"] for x in runs if x["attempt"] == 0) == [0, 1, 2]
    again = [x["step"] for x in runs if x["attempt"] == 1]
    assert again == list(range(done[0]["restored_step"] + 1, 5))
    assert {x["world"] for x in runs} == {2}
    for x in runs:
        assert x["loss"] == want[x["step"]], x
    assert done[0]["elastic_recovery_seconds"] > 0
