"""Child ranks of one process group on this host: ``world`` processes
started together, each told its rank on its command line, and waited for
under one deadline. Each rank joins the group itself (a ``FileStore``
rendezvous under ``outdir`` is the usual choice) and prints ``RANK <r>
OK`` as its last act."""

import os
import subprocess
import time
from pathlib import Path

GROUP_TIMEOUT_S = 150


class RankGroup:
    """``argv(rank)`` for ranks ``0 .. world - 1``, started together, each
    writing its output to ``<outdir>/<name>_rank<r>.log``. :meth:`wait`
    waits for them all, kills the group on the first failure or at the
    deadline, and raises unless every rank exited 0 and printed ``RANK
    <r> OK``.

    :param env: variables added to this process's environment for the
        ranks
    """

    def __init__(self, name, argv, world, outdir, timeout=GROUP_TIMEOUT_S,
                 env=None):
        self.name, self.world, self.timeout = name, world, timeout
        self.logs = [Path(outdir) / f"{name}_rank{r}.log"
                     for r in range(world)]
        self.deadline = time.monotonic() + timeout
        run_env = dict(os.environ, **(env or {}))
        self.procs = []
        try:
            for r in range(world):
                with open(self.logs[r], "w") as log:
                    self.procs.append(subprocess.Popen(
                        argv(r), stdout=log, stderr=subprocess.STDOUT,
                        env=run_env))
        except BaseException:
            self._kill()
            raise

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self):
        """Wait for every rank; returns each rank's output."""
        timed_out = False
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > self.deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            self._kill()
        outs = [log.read_text() for log in self.logs]
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0 or f"RANK {r} OK" not in out:
                why = (f"the group timed out after {self.timeout} s"
                       if timed_out else f"exit {p.returncode}")
                raise RuntimeError(f"{self.name}: rank {r} failed ({why}):"
                                   f"\n{out[-4000:]}")
        return outs
