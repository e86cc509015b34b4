"""Start a function in several ranks of one process group.

torchrun starts the ranks of a command-line run (the CLI reads RANK,
WORLD_SIZE and LOCAL_RANK; see cli/main.py). start_ranks / run_ranks
start them from Python, as the tests and chip_smoke.py do: each rank is
a process of torch.multiprocessing.start_processes that joins a process
group of the caller's backend through a FileStore (no TCP port, so many
runs can go at once), runs fn(rank, *args) with torch on one thread, and
saves its result beside the store; the caller waits at most `timeout`
seconds for all of them, and a rank that raises, dies or hangs fails the
whole call (the others are killed).
"""

from __future__ import annotations

import datetime
import os
import pickle
import time

import torch


def _rank_main(rank: int, world: int, backend: str, workdir: str,
               timeout: float, fn, args) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


class Ranks:
    """Ranks started by start_ranks; wait() -> their results."""

    def __init__(self, context, workdir: str, timeout: float):
        self.context, self.workdir, self.timeout = context, workdir, timeout
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        """The ranks' results, in rank order; raises if a rank raised
        (with its traceback), died, or was still running at the deadline
        (then all are killed)."""
        import torch.multiprocessing as mp

        try:
            while not self.context.join(
                    max(0.0, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    hung = [r for r, p in enumerate(self.context.processes)
                            if p.is_alive()]
                    raise TimeoutError(
                        f"ranks {hung} of {len(self.context.processes)} "
                        f"still running after {self.timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            # every rank's traceback: the first to exit may only have
            # lost its peer
            raise RuntimeError("\n".join(
                f"rank {r}:\n{trace}" for r, trace in self._traces())
                or str(e)) from e
        finally:
            for p in self.context.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            for f in self.context.error_files:
                if os.path.exists(f):
                    os.remove(f)
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.context.processes))]

    def _traces(self):
        for r, f in enumerate(self.context.error_files):
            if os.path.exists(f):
                with open(f, "rb") as fh:
                    yield r, pickle.load(fh)


def start_ranks(fn, world: int, backend: str, workdir: str, args=(),
                timeout: float = 120.0) -> Ranks:
    """Start fn(rank, *args) in `world` spawned ranks of a `backend`
    process group and return at once; .wait() collects the results. fn
    and args must be picklable (fn a module-level function). workdir: an
    empty directory of the caller's for the store and the results. The
    timeout counts from the start."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    context = mp.start_processes(
        _rank_main, args=(world, backend, workdir, timeout, fn, args),
        nprocs=world, join=False, daemon=True, start_method="spawn")
    return Ranks(context, workdir, timeout)


def run_ranks(fn, world: int, backend: str, workdir: str, args=(),
              timeout: float = 120.0) -> list:
    """start_ranks(...).wait(): the ranks' results, in rank order."""
    return start_ranks(fn, world, backend, workdir, args, timeout).wait()
