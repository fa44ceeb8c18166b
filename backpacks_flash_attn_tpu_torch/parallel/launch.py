"""Start a world of N ranks, one process each, on this machine.

    from backpacks_flash_attn_tpu_torch.parallel import launch
    results = launch.run_world("pkg.module:fn", 2, args=(...,), backend="gloo")

Each rank runs ``python -m backpacks_flash_attn_tpu_torch.parallel.launch``
with the checkout on its ``PYTHONPATH``: it joins the process group at
``tcp://localhost:<port>`` (a free port; world size and rank given
explicitly, nothing read from a cluster), calls ``fn(*args)`` and writes
its return value for the caller. ``target`` is ``module:function`` or
``path/to/file.py:function``. The backend is the caller's (NCCL needs a
GPU a rank: rank r takes ``cuda:r``; gloo stages CUDA tensors through host
memory, ``parallel/mesh.py``). A rank that fails or outlives ``timeout``
fails the world: the other ranks are stopped and the failing rank's log
tail is raised. The process group's own timeout (``pg_timeout``) makes a
rank that waits on a lost peer fail instead of hanging.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent.parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_world(target: str, world: int, *, args: Sequence[Any] = (),
              backend: str = "gloo", timeout: float = 600.0,
              pg_timeout: float = 300.0, threads: Optional[int] = None,
              inherit_rank0: bool = False,
              workdir: Optional[Path] = None) -> List[Any]:
    """Run ``target(*args)`` on ``world`` ranks; -> their return values in
    rank order. threads: torch's intra-op threads a rank (CPU worlds);
    inherit_rank0: rank 0 prints to this process's stdout and stderr (the
    others to their logs); workdir: where the arguments, results and logs
    go (a temporary directory by default)."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(workdir) if workdir is not None else Path(tmp)
        work.mkdir(parents=True, exist_ok=True)
        args_file = work / "world_args.pt"
        torch.save(tuple(args), args_file)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        port = free_port()
        procs, logs = [], []
        for rank in range(world):
            log = work / f"rank{rank}.log"
            logs.append(log)
            cmd = [sys.executable, "-m", "backpacks_flash_attn_tpu_torch.parallel.launch",
                   "--target", target, "--rank", str(rank), "--world", str(world),
                   "--port", str(port), "--backend", backend,
                   "--pg-timeout", str(pg_timeout), "--args", str(args_file),
                   "--out", str(work / f"rank{rank}.pt")]
            if threads:
                cmd += ["--threads", str(threads)]
            if inherit_rank0 and rank == 0:
                procs.append(subprocess.Popen(cmd, env=env))
            else:
                with open(log, "w") as fh:
                    procs.append(subprocess.Popen(cmd, env=env, stdout=fh,
                                                  stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = (f"rank {bad[0]} of {world} exited {codes[bad[0]]}:\n"
                              + _tail(logs[bad[0]]))
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = (f"the world of {world} ranks ran past {timeout} s; "
                              f"rank 0's log:\n" + _tail(logs[0]))
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed:
            raise RuntimeError(failed)
        return [torch.load(work / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _resolve(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one rank of run_world")
    for flag in ("--target", "--backend", "--args", "--out"):
        p.add_argument(flag, required=True)
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--pg-timeout", type=float, default=300.0)
    p.add_argument("--threads", type=int, default=0)
    a = p.parse_args(argv)
    if a.threads:
        torch.set_num_threads(a.threads)
    if a.backend == "nccl":
        torch.cuda.set_device(a.rank % torch.cuda.device_count())
    dist.init_process_group(a.backend, init_method=f"tcp://localhost:{a.port}",
                            world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=a.pg_timeout))
    try:
        result = _resolve(a.target)(*torch.load(a.args, weights_only=False))
        torch.save(result, a.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
