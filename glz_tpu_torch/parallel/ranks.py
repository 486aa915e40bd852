"""Run one function in several fresh processes joined by torch.distributed.

    results = ranks.run("package.module:function", 4, arg, ...)
    results = ranks.run("path/to/file.py:function", 2, arg, ..., threads=1)

`run` starts `world_size` new interpreters (python -m
glz_tpu_torch.parallel.ranks; never a fork, so a parent that holds a CUDA
context may call it).  Each rank selects card rank % device_count where
there is a card, joins the process group on a free localhost port
(multihost.init_group: gloo, with NCCL for CUDA tensors where there is a
card) with `timeout` seconds for every collective, calls
function(*args) and hands its return value back through a pickle file;
`run` returns them in rank order.

A rank that raises exits non-zero.  The parent watches all ranks: as soon
as one fails, or when `timeout` has passed, it stops the others and raises
RankError with every rank's exit code and the end of its standard error.
No rank outlives the call.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[2]


class RankError(RuntimeError):
    """Some rank failed or the ranks ran out of time; `returncodes` (None for
    a rank that was stopped) and `stderrs` hold every rank's."""

    def __init__(self, msg: str, returncodes: list, stderrs: list[str]):
        super().__init__(msg)
        self.returncodes = returncodes
        self.stderrs = stderrs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    """The function named "module:function" or "file.py:function"."""
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = pathlib.Path(where).resolve()
        sys.path.insert(0, str(path.parent))
        spec = importlib.util.spec_from_file_location(f"_rank_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def run(target: str, world_size: int, *args, timeout: float = 300.0,
        threads: int | None = None) -> list:
    """Call target(*args) in `world_size` ranks; their results in rank
    order.  threads: torch's intra-op threads in each rank (its default
    when None)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    with tempfile.TemporaryDirectory(prefix="glz_ranks_") as tmp:
        job = pathlib.Path(tmp) / "job.pkl"
        job.write_bytes(pickle.dumps((target, args, threads, timeout)))
        port = free_port()
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
        procs, logs = [], []
        deadline = time.monotonic() + timeout
        try:
            for rank in range(world_size):
                log = open(pathlib.Path(tmp) / f"rank{rank}.err", "w+b")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "glz_tpu_torch.parallel.ranks", tmp, str(rank),
                     str(world_size), str(port)],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-4000:].decode(errors="replace"))
            log.close()
        if any(c != 0 for c in codes):
            late = time.monotonic() > deadline
            raise RankError(
                f"{target} on {world_size} ranks " + ("ran out of time" if late else "failed")
                + f": exit codes {codes}\n"
                + "\n".join(f"--- rank {r} ---\n{t}" for r, t in enumerate(tails)),
                codes, tails)
        return [pickle.loads((pathlib.Path(tmp) / f"result{r}.pkl").read_bytes())
                for r in range(world_size)]


def _main(argv: list[str]) -> int:
    tmp, rank, world_size, port = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    target, args, threads, timeout = pickle.loads((pathlib.Path(tmp) / "job.pkl").read_bytes())
    import torch

    from glz_tpu_torch.parallel import multihost

    if threads:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        multihost.init_group(f"127.0.0.1:{port}", world_size, rank, timeout=timeout)
        result = _resolve(target)(*args)
    except BaseException:
        # exit at once: the parent stops the other ranks, which may be
        # waiting in a collective this rank will never join
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    out = pathlib.Path(tmp) / f"result{rank}.pkl"
    out.with_suffix(".part").write_bytes(pickle.dumps(result))
    os.replace(out.with_suffix(".part"), out)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
