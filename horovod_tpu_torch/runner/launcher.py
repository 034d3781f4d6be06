"""Process launcher: ``horovodrun`` for the port.

Port of ``horovod_tpu/runner/launcher.py`` (upstream
``horovod/runner/launch.py``, ``gloo_run.py`` and the elastic driver). The
port runs one process per GPU, upstream Horovod's model: a host spec
``h:4`` gives four ranks with ``LOCAL_RANK`` 0-3, and local rank ``r``
drives GPU ``r`` when it calls ``init()`` (``-np`` above the visible GPUs
fails there, loudly); ``init(device="cpu")`` keeps every rank on the CPU
with gloo. The reference runs one process per host, which drives all its
chips. Each worker gets the rendezvous contract ``horovod_tpu_torch.init()``
reads: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; elastic jobs add the reference's
``HVD_TPU_ELASTIC_*`` variables.

* :func:`run` -- local mode spawns ``np`` processes and supervises them
  (one failing rank takes the others down); with ``hosts`` it builds one
  command per slot, and with ``ssh=True`` runs and supervises them over
  ssh; ``output_filename`` gives per-rank logs.
* :func:`run_func` -- ``horovod.run``: a function on ``np`` ranks, its
  results back.
* :func:`run_elastic` -- relaunch on worker loss, with hot spares.
* ``python -m horovod_tpu_torch.runner`` -- the CLI (:func:`main`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shlex
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["HostSpec", "parse_hosts", "build_worker_env", "worker_commands",
           "free_port", "run", "run_func", "run_elastic", "main",
           "WorkerFailed"]

DEFAULT_PORT = 29500
# Seconds between SIGTERM and SIGKILL when a job is torn down: survivors
# of a dead rank sit in a collective that will never finish.
TEARDOWN_GRACE_S = 10.0


class WorkerFailed(RuntimeError):
    """A worker exited non-zero; ``code`` is its exit code."""

    def __init__(self, code: int):
        super().__init__(f"worker exited with code {code}")
        self.code = code


@dataclasses.dataclass
class HostSpec:
    host: str
    slots: int


def parse_hosts(hosts: str) -> List[HostSpec]:
    """Parse ``"host1:4,host2:4"`` (upstream ``parse_hosts``) or a hostfile
    path with ``host slots=N`` lines (upstream ``parse_host_files``)."""
    specs: List[HostSpec] = []
    if os.path.isfile(hosts):
        with open(hosts) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                parts = line.split()
                slots = 1
                for p in parts[1:]:
                    if p.startswith("slots="):
                        slots = int(p.split("=", 1)[1])
                specs.append(HostSpec(parts[0], slots))
        return specs
    for item in hosts.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            h, s = item.rsplit(":", 1)
            specs.append(HostSpec(h, int(s)))
        else:
            specs.append(HostSpec(item, 1))
    return specs


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_worker_env(rank: int, world: int, coordinator: str,
                     base_env: Optional[Dict] = None,
                     local_rank: Optional[int] = None,
                     local_size: Optional[int] = None) -> Dict:
    """Environment of one worker: the rendezvous contract ``init()`` reads
    (``coordinator`` is ``"addr:port"``; local rank and size default to a
    one-host world)."""
    env = dict(base_env if base_env is not None else os.environ)
    addr, _, port = coordinator.rpartition(":")
    env.update({
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(rank if local_rank is None else local_rank),
        "LOCAL_SIZE": str(world if local_size is None else local_size),
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
    })
    return env


def _slots(hosts: List[HostSpec]):
    """(host, rank, local_rank, local_size) of every slot, host by host."""
    rank = 0
    for spec in hosts:
        for lr in range(spec.slots):
            yield spec.host, rank, lr, spec.slots
            rank += 1


def worker_commands(command: Sequence[str], hosts: List[HostSpec],
                    coordinator_port: int = DEFAULT_PORT,
                    extra_env: Optional[Dict[str, str]] = None) -> List[str]:
    """One launch line per slot (one process per GPU): the env contract
    prefixed to ``command``; ``extra_env`` rides every line. The
    rendezvous is the first host."""
    world = sum(s.slots for s in hosts)
    extras = "".join(f"{k}={shlex.quote(v)} "
                     for k, v in (extra_env or {}).items())
    cmds = []
    for _, rank, lr, ls in _slots(hosts):
        env = (f"{extras}RANK={rank} WORLD_SIZE={world} LOCAL_RANK={lr} "
               f"LOCAL_SIZE={ls} MASTER_ADDR={hosts[0].host} "
               f"MASTER_PORT={coordinator_port}")
        cmds.append(f"{env} {' '.join(shlex.quote(c) for c in command)}")
    return cmds


def _ssh_argv(host: str, line: str) -> List[str]:
    """argv to execute ``line`` on ``host`` (upstream gloo_run's ssh
    execution). BatchMode so a missing key fails instead of prompting;
    ``-tt`` so terminating the local client HUPs the remote processes."""
    return ["ssh", "-tt", "-o", "BatchMode=yes",
            "-o", "StrictHostKeyChecking=no", host, line]


def _teardown(procs: List[subprocess.Popen]) -> None:
    """SIGTERM every live process, SIGKILL what is left after
    ``TEARDOWN_GRACE_S``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + TEARDOWN_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _supervise(procs: List[subprocess.Popen],
               timeout: Optional[float]) -> int:
    """Wait for workers; any worker failing takes down its peers, which
    would otherwise block forever on the dead rank."""
    rc = 0
    timed_out = False
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        pending = list(procs)
        while pending and rc == 0:
            for p in list(pending):
                code = p.poll()
                if code is None:
                    continue
                pending.remove(p)
                if code:
                    rc = code
                    break
            if pending and rc == 0 and deadline is not None and \
                    time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        _teardown(procs)
    if timed_out:
        raise TimeoutError(
            f"workers still running after {timeout}s; job killed")
    if rc:
        raise WorkerFailed(rc)
    return 0


def _rank_output(output_filename: Optional[str], rank: int):
    """Per-rank log sink (upstream ``horovodrun --output-filename``:
    ``<dir>/rank.<N>/stdout``). None = inherit the launcher's streams."""
    if output_filename is None:
        return None
    d = os.path.join(output_filename, f"rank.{rank}")
    os.makedirs(d, exist_ok=True)
    return open(os.path.join(d, "stdout"), "wb")


def _popen(argv, env, output_filename, rank):
    sink = _rank_output(output_filename, rank)
    try:
        return subprocess.Popen(list(argv), env=env, stdout=sink,
                                stderr=subprocess.STDOUT if sink else None)
    finally:
        if sink is not None:
            sink.close()   # the child holds its own duplicate fd


def run(command: Sequence[str], np: int = 1, hosts: Optional[str] = None,
        coordinator_port: Optional[int] = None, dry_run: bool = False,
        extra_env: Optional[Dict[str, str]] = None,
        timeout: Optional[float] = None, ssh: bool = False,
        output_filename: Optional[str] = None):
    """``horovodrun`` equivalent.

    - ``hosts=None``: spawn ``np`` local ranks (rank r on GPU r) and wait;
      the rendezvous port is ``coordinator_port`` or a free one.
    - ``hosts="h1:8,h2:8"`` or a hostfile: one command per slot. With
      ``ssh=True`` they run over ssh, supervised; otherwise they are
      printed and returned for the user's own tooling.
    - ``dry_run``: return the commands without executing.
    - ``timeout``: kill the job and raise ``TimeoutError`` when workers are
      still running after this many seconds (``--start-timeout``).
    - ``output_filename``: directory of per-rank logs
      (``<dir>/rank.<N>/stdout``, stderr merged).

    A failing rank takes the others down and raises :class:`WorkerFailed`
    with its exit code.
    """
    if np < 1:
        raise ValueError(f"-np must be >= 1, got {np}")
    if hosts is not None:
        specs = parse_hosts(hosts)
        cmds = worker_commands(command, specs,
                               coordinator_port or DEFAULT_PORT,
                               extra_env=extra_env)
        if dry_run:
            return cmds
        if not ssh:
            for c in cmds:
                print(c)
            return cmds
        procs = [_popen(_ssh_argv(host, line), None, output_filename, rank)
                 for (host, rank, _, _), line in zip(_slots(specs), cmds)]
        return _supervise(procs, timeout)

    if dry_run:
        return [" ".join(command)] * np
    coordinator = f"127.0.0.1:{coordinator_port or free_port()}"
    procs = []
    for rank in range(np):
        env = build_worker_env(rank, np, coordinator)
        if extra_env:
            env.update(extra_env)
        procs.append(_popen(command, env, output_filename, rank))
    return _supervise(procs, timeout)


def run_elastic(command: Sequence[str], np: int = 2, min_np: int = 1,
                max_restarts: int = 3,
                coordinator_port: Optional[int] = None,
                state_dir: Optional[str] = None,
                extra_env: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                discovery=None, max_np: Optional[int] = None,
                spares: int = 0) -> int:
    """Fault-tolerant local launch (upstream
    ``horovod/runner/elastic/driver.py``).

    Spawns ``np`` ranks; when one dies, the whole job is torn down
    (SIGTERM, then SIGKILL after ``TEARDOWN_GRACE_S``: the survivors sit in
    a collective that cannot finish) and relaunched over the survivors
    with a fresh rendezvous port: process restart is the recovery between
    processes. Workers persist their commits under ``state_dir`` (exported
    as ``HVD_TPU_ELASTIC_STATE_DIR``; a sharded checkpoint there is what a
    relaunched rank 0 adopts); ``HVD_TPU_ELASTIC_RESTART`` carries the
    attempt and ``HVD_TPU_ELASTIC_FAILED_AT`` the failure's wall time
    (the recovery clock's start). Each failed attempt appends
    ``{"attempt", "failed_at", "exits": {rank: code}}`` to
    ``<state_dir>/exits.jsonl``: every rank's exit code as it stood when
    the failure was seen, before the teardown (null: still running).

    Stops when a relaunch would drop below ``min_np`` or after
    ``max_restarts`` attempts; returns the number of restarts on success.
    ``timeout`` (default ``HOROVOD_ELASTIC_TIMEOUT`` when set) bounds each
    attempt.

    ``discovery``: optional zero-arg callable returning the available slot
    count, consulted between attempts so recovered capacity scales the
    relaunch back up, capped at ``max_np`` (default ``np``).

    ``spares``: hot-spare processes running the same command with
    ``HVD_TPU_ELASTIC_SPARE=1``: each registers and idles in
    ``hvd.elastic.standby_if_spare()``, holding no GPU, until a worker
    dies; then it is promoted into the dead rank's slot (its GPU is that
    slot's ``LOCAL_RANK``) so the relaunched world keeps its size. The pool
    is not replenished.
    """
    import tempfile

    if timeout is None and os.environ.get("HOROVOD_ELASTIC_TIMEOUT"):
        # Read directly so a value set after init()'s config snapshot
        # still applies; only when the user set it.
        timeout = float(os.environ["HOROVOD_ELASTIC_TIMEOUT"])
    if state_dir is None:
        state_dir = tempfile.mkdtemp(prefix="hvd_torch_elastic_")

    def _spawn_spare(idx: int):
        # Launcher-assigned identity: the registering interpreter may be
        # a grandchild of the Popen handle (a wrapper script).
        token = f"spare-{os.getpid()}-{idx}"
        env = dict(os.environ)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
                  "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        env["HVD_TPU_ELASTIC_SPARE"] = "1"
        env["HVD_TPU_ELASTIC_SPARE_ID"] = token
        env["HVD_TPU_ELASTIC_STATE_DIR"] = state_dir
        if extra_env:
            env.update(extra_env)
        return subprocess.Popen(list(command), env=env), token

    def _port(attempt: int) -> int:
        return free_port() if coordinator_port is None \
            else coordinator_port + attempt

    cap = max_np or np
    spare_pool = [_spawn_spare(i) for i in range(max(0, spares))]
    world = np
    restarts = 0
    promoted: list = []   # [(Popen, rank)] carried into the next attempt
    failed_at: Optional[float] = None
    coordinator = f"127.0.0.1:{_port(0)}"
    procs: List[subprocess.Popen] = []
    try:
        while True:
            procs = []
            ranks = []
            taken = {r for _, r in promoted}
            for rank in range(world):
                if rank in taken:
                    continue
                env = build_worker_env(rank, world, coordinator)
                env["HVD_TPU_ELASTIC_STATE_DIR"] = state_dir
                env["HVD_TPU_ELASTIC_RESTART"] = str(restarts)
                if failed_at is not None:
                    env["HVD_TPU_ELASTIC_FAILED_AT"] = str(failed_at)
                if extra_env:
                    env.update(extra_env)
                procs.append(subprocess.Popen(list(command), env=env))
                ranks.append(rank)
            procs.extend(p for p, _ in promoted)
            ranks.extend(r for _, r in promoted)
            promoted = []

            failed = 0
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            pending = list(procs)
            while pending and not failed:
                for p in list(pending):
                    code = p.poll()
                    if code is None:
                        continue
                    pending.remove(p)
                    if code:
                        # One loss a pass: a gloo survivor of the dead
                        # rank fails at once too, and is not lost.
                        failed += 1
                        break
                # A spare dying is capacity loss, not job failure.
                for entry in list(spare_pool):
                    if entry[0].poll() is not None:
                        spare_pool.remove(entry)
                        logger.warning("elastic: spare %s exited "
                                       "(%d spare(s) left)", entry[1],
                                       len(spare_pool))
                if pending and deadline is not None and \
                        time.monotonic() > deadline:
                    raise TimeoutError(
                        f"elastic workers still running after {timeout}s")
                time.sleep(0.05)

            if not failed:
                return restarts
            failed_at = time.time()
            exits = {r: p.poll() for r, p in zip(ranks, procs)}
            logger.warning("elastic: attempt %d failed; exit codes by rank "
                           "%s", restarts, exits)
            with open(os.path.join(state_dir, "exits.jsonl"), "a") as f:
                f.write(json.dumps({"attempt": restarts,
                                    "failed_at": failed_at,
                                    "exits": exits}) + "\n")
            _teardown(procs)
            # Only workers that failed on their own count as lost; the
            # survivors torn down above relaunch.
            world -= failed
            if discovery is not None:
                try:
                    world = max(world, min(int(discovery()), cap))
                except Exception as e:
                    logger.warning("elastic discovery hook failed (%s); "
                                   "continuing with world=%d", e, world)
            restarts += 1
            coordinator = f"127.0.0.1:{_port(restarts)}"
            if spare_pool and world < cap:
                from horovod_tpu_torch.elastic import driver as _edriver
                # Only spares alive and registered (heartbeat fresh): a
                # dead or wedged one would leave the relaunched rendezvous
                # waiting for a rank that never joins.
                registered = set(_edriver.list_spares(state_dir))
                ready = [e for e in spare_pool
                         if e[0].poll() is None and e[1] in registered]
                n_promote = min(len(ready), cap - world)
                next_world = world + n_promote
                for i in range(n_promote):
                    p, token = ready[i]
                    spare_pool.remove(ready[i])
                    rank = world + i   # highest ranks of the new world
                    _edriver.promote_spare(
                        state_dir, token, rank=rank, world=next_world,
                        coordinator=coordinator, restart=restarts,
                        failed_at=failed_at)
                    promoted.append((p, rank))
                world = next_world
            if world < min_np:
                raise RuntimeError(
                    f"elastic job below min_np: {world} < {min_np} after "
                    f"{restarts} restart(s)")
            if restarts > max_restarts:
                raise RuntimeError(
                    f"elastic job exceeded max_restarts={max_restarts}")
    finally:
        leftover = procs + [e[0] for e in spare_pool] + \
            [p for p, _ in promoted]
        for p in leftover:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in leftover:
            p.wait()


_FUNC_WORKER = """\
import os, pickle, sys
with open(sys.argv[1], "rb") as f:
    fn, args, kwargs, device = pickle.loads(f.read())
import horovod_tpu_torch as hvd
hvd.init(device=device)   # picks up the rendezvous contract from the env
result = fn(*args, **kwargs)
rank = os.environ["RANK"]
with open(os.path.join(sys.argv[2], "result_" + rank + ".pkl"), "wb") as f:
    pickle.dump(result, f)
hvd.shutdown()
"""


def run_func(fn, args: tuple = (), kwargs: Optional[Dict] = None,
             np: int = 1, coordinator_port: Optional[int] = None,
             extra_env: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None,
             device: Optional[str] = None) -> list:
    """Programmatic launcher (upstream ``horovod.run``): execute ``fn`` on
    ``np`` ranks and return ``[fn's result per rank]``. Each worker calls
    ``hvd.init(device=device)`` first (GPU ``LOCAL_RANK`` by default,
    ``"cpu"`` for gloo). ``fn`` travels by pickle, so it must be importable
    by the workers (a module-level function); the reference's cloudpickle
    is not a dependency of the port."""
    import pickle
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hvd_torch_runfunc_") as td:
        fn_path = os.path.join(td, "fn.pkl")
        with open(fn_path, "wb") as f:
            f.write(pickle.dumps((fn, args, kwargs or {}, device)))
        env = dict(extra_env or {})
        # the workers import fn's module the way this process did
        env.setdefault("PYTHONPATH", os.pathsep.join(
            p for p in [os.getcwd()] + sys.path if p))
        command = [sys.executable, "-c", _FUNC_WORKER, fn_path, td]
        run(command, np=np, coordinator_port=coordinator_port,
            extra_env=env, timeout=timeout)
        results = []
        for rank in range(np):
            path = os.path.join(td, f"result_{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"worker {rank} produced no result (crashed after "
                    "rendezvous?)")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m horovod_tpu_torch.runner -np 4 python train.py``.

    The reference's flags, plus ``--elastic`` (``run_elastic``) with
    ``--min-np``, ``--max-np`` and ``--spares``. A
    command that starts with a ``.py`` file runs under this interpreter.
    Exits with the failing rank's code, 124 on a timeout."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch horovod_tpu_torch workers, one process per GPU "
                    "(horovodrun equivalent)")
    parser.add_argument("-np", "--num-proc", type=int, default=1)
    parser.add_argument("-H", "--hosts", default=None,
                        help='e.g. "host1:8,host2:8" or a hostfile path')
    parser.add_argument("--port", type=int, default=None,
                        help="rendezvous port (default: a free one)")
    parser.add_argument("--start-timeout", "--timeout", type=float,
                        default=None, dest="start_timeout",
                        help="kill the job if workers are still running "
                             "after this many seconds")
    parser.add_argument("--ssh", action="store_true",
                        help="execute the per-slot commands over ssh and "
                             "supervise them (upstream gloo_run)")
    parser.add_argument("--output-filename", default=None,
                        help="directory for per-rank logs "
                             "(<dir>/rank.N/stdout, stderr merged)")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--check-build", action="store_true",
                        help="print capability flags and exit "
                             "(horovodrun --check-build)")
    parser.add_argument("--elastic", action="store_true",
                        help="relaunch on worker loss (run_elastic)")
    parser.add_argument("--min-np", type=int, default=1)
    parser.add_argument("--max-np", type=int, default=None)
    parser.add_argument("--spares", type=int, default=0,
                        help="hot spares promoted into a dead rank's slot")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.check_build:
        # No init(): the diagnostic must work when a rendezvous would
        # block or the GPU is held.
        import json as _json

        from horovod_tpu_torch.core import build_info
        print(_json.dumps(build_info(), indent=2, default=str))
        return 0
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        parser.error("no command given")
    if command[0].endswith(".py"):
        command = [sys.executable] + command
    if args.elastic and (args.hosts or args.ssh):
        parser.error("--elastic launches local workers; -H and --ssh are "
                     "not taken with it")
    try:
        if args.elastic:
            restarts = run_elastic(
                command, np=args.num_proc, min_np=args.min_np,
                max_np=args.max_np, spares=args.spares,
                coordinator_port=args.port, timeout=args.start_timeout)
            logger.warning("elastic job finished after %d restart(s)",
                           restarts)
            return 0
        out = run(command, np=args.num_proc, hosts=args.hosts,
                  coordinator_port=args.port, dry_run=args.dry_run,
                  timeout=args.start_timeout, ssh=args.ssh,
                  output_filename=args.output_filename)
    except WorkerFailed as e:
        return e.code
    except TimeoutError as e:
        print(f"horovod_tpu_torch.runner: {e}", file=sys.stderr)
        return 124
    if args.dry_run and isinstance(out, list):
        for c in out:
            print(c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
