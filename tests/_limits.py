"""What the port's tests (``tests/test_torch_*.py``) hold their process to:
one torch thread, and a time limit for a test that could stall.

Every port test module imports this module, so the cap holds from the
first module collected, in every xdist worker and in a run of one file.

**One torch thread a process.** torch's CPU ops split a tensor of more
than 32 768 elements across its OpenMP threads (one a core by default),
and each op ends on a barrier that waits for every thread. With six test
workers on eight virtual cores, the XLA:CPU thread pools beside them and
cores that the host may lend elsewhere, a thread is often not running
when its op ends: a chain of a few thousand such ops (the plain IoU
matrix of 200 boxes, twelve times) took 24 to 178 s alone on eight
threads and 651 s in the suite, against 2.7 to 3.9 s on one. The workers
are the suite's parallelism; within one, a single thread does the same
work without waiting. The ops that the tests compare bit for bit give the
same bits on one thread as on eight; a model's eager outputs may not, so
a test that compares them with another process runs both on one count.

**A time limit.** :func:`time_limit` fails a test (or a fixture) that
runs past its limit with the stack it had there, and :func:`run_python`
fails with the child's stacks, so a stall costs one failure with a name
rather than the suite's clock."""

import contextlib
import faulthandler
import functools
import signal
import subprocess
import sys
import threading

import torch

torch.set_num_threads(1)


class TimeLimitExceeded(AssertionError):
    """A test ran past its :func:`time_limit`."""


# how long past its limit a test stuck inside C may run before the process
# ends with every thread's stack
BACKSTOP_S = 60


@contextlib.contextmanager
def _limit(seconds, what):
    """At ``seconds``, raise :class:`TimeLimitExceeded` where the test is
    (SIGALRM: on the main thread, between two Python bytecodes, so with
    the test's stack). A test stuck inside C that long past its limit is
    ended by faulthandler, which writes every thread's stack and exits the
    process; xdist then names the test whose worker crashed."""
    main = threading.current_thread() is threading.main_thread()
    faulthandler.dump_traceback_later(seconds + BACKSTOP_S, exit=True)
    if main:
        def alarm(signum, frame):
            raise TimeLimitExceeded(f"{what} ran past its limit of "
                                    f"{seconds} s")
        old = signal.signal(signal.SIGALRM, alarm)
        signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)
        faulthandler.cancel_dump_traceback_later()


def time_limit(seconds):
    """Decorator: the test or fixture fails if it runs past ``seconds``
    (see :func:`_limit`). Limits do not nest: the watchdog is one a
    process."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _limit(seconds, fn.__qualname__):
                return fn(*args, **kwargs)
        return run
    return wrap


def run_python(code, cwd, timeout=120):
    """``python -c code`` in ``cwd``: the ``CompletedProcess``, its output
    as text. Past ``timeout`` the child gets SIGABRT, which its
    faulthandler (``-X faulthandler``) answers with every thread's stack,
    and the test fails with those stacks."""
    proc = subprocess.Popen([sys.executable, "-X", "faulthandler", "-c",
                             code], cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        try:
            out, err = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        raise TimeLimitExceeded(f"python -c ran past its limit of {timeout} "
                                f"s; its stacks:\n{err[-6000:]}") from None
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
