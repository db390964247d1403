"""Child supervision for unattended runs — counterpart of
``mpgan_tpu/utils/supervise.py``.

A supervising parent runs the real work as a child process, restarts it
when it dies, and with a hang timeout kills it when its heartbeat
(:mod:`mpgan_torch.utils.liveness`) goes stale. The training and inference
supervisor of ``python -m mpgan_torch.cli`` (``retryOnError``,
``hangTimeout``) is built on these; :func:`supervise_restartable` serves a
CLI whose restarts are idempotent through a flag of its own.

The parent never touches the card: this module imports only the standard
library, and the parent only spawns ``[sys.executable, "-m", module,
...]``. A parent holding a CUDA context would keep card memory from its
child for the whole run.

Environment: ``MPGAN_HEARTBEAT`` (the file the child touches),
``MPGAN_STARTUP_GRACE_S`` (the deadline before the first touch, default
900 s) and ``MPGAN_RETRY_DELAY_S`` (the pause before a restart, default
30 s).
"""

from __future__ import annotations

import contextlib
import os
import signal
import subprocess
import sys
import time


def _kill_child_group(proc) -> None:
    """Kill the child and everything it spawned (it runs in its own
    session), then reap it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass
    proc.wait()


@contextlib.contextmanager
def _child_in_own_session(cmd, env):
    """Start the child in its own session, so that the supervisor's death
    takes the child's whole tree down with it: SIGTERM or SIGINT to the
    supervisor kills the child's group, then raises ``SystemExit`` so that
    the callers' ``finally`` blocks clean up."""
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)

    def _die(signum, frame):
        _kill_child_group(proc)
        raise SystemExit(128 + signum)

    prev = {s: signal.signal(s, _die)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield proc
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def run_child(cmd, env) -> int:
    """``subprocess.call`` with the death semantics of
    :func:`run_child_watched` (:func:`_child_in_own_session`)."""
    with _child_in_own_session(cmd, env) as proc:
        return proc.wait()


def run_child_watched(cmd, env, hang_timeout: float, heartbeat: str) -> int:
    """Run the child, killing its group if its heartbeat file goes stale.

    The child touches ``heartbeat`` (its ``MPGAN_HEARTBEAT``) on every unit
    of forward progress; a child silent for ``hang_timeout`` seconds is
    killed (rc −9), so that the caller restarts it like any other death.
    Until the first touch the deadline is the larger startup grace
    (``MPGAN_STARTUP_GRACE_S``): imports, data loading and the first
    kernel builds are silent. A stale child gets a drain window before the
    kill, since a child tearing down after its work does not heartbeat.
    """
    with open(heartbeat, "w"):
        pass
    launch_mtime = os.path.getmtime(heartbeat)
    grace = max(hang_timeout,
                float(os.environ.get("MPGAN_STARTUP_GRACE_S", "900")))
    poll_s = max(1.0, min(10.0, hang_timeout / 3))
    with _child_in_own_session(cmd, env) as proc:
        while True:
            try:
                return proc.wait(timeout=poll_s)
            except subprocess.TimeoutExpired:
                pass
            try:
                mtime = os.path.getmtime(heartbeat)
                stale = time.time() - mtime
            except OSError:
                continue
            limit = hang_timeout if mtime != launch_mtime else grace
            if stale > limit:
                drain = max(10.0, min(60.0, hang_timeout))
                try:
                    return proc.wait(timeout=drain)
                except subprocess.TimeoutExpired:
                    pass
                try:
                    if os.path.getmtime(heartbeat) != mtime:
                        continue  # it recovered during the drain: not hung
                except OSError:
                    pass
                print(f"retryOnError: child silent for {stale + drain:.0f}s "
                      f"(limit {limit:g}s); killing it", flush=True)
                _kill_child_group(proc)
                return -9


def supervise_restartable(module: str, argv, retries: int,
                          hang_timeout: float, child_env: str,
                          heartbeat_dir: str, retry_flags=()) -> int:
    """Supervise an idempotently restartable CLI, ``python -m module``:
    relaunch the same argv (plus ``retry_flags`` on a restart, e.g.
    ``("skipExisting", "1")``, unless the argv sets them) until it exits 0
    or the retry budget is spent. The child is marked by ``child_env`` so
    that it does not supervise itself. → the last exit code."""
    env = dict(os.environ, **{child_env: "1"})
    delay = float(os.environ.get("MPGAN_RETRY_DELAY_S", "30"))
    os.makedirs(heartbeat_dir, exist_ok=True)
    heartbeat = None
    if hang_timeout > 0:
        heartbeat = os.path.join(heartbeat_dir, f".heartbeat_{os.getpid()}")
        env["MPGAN_HEARTBEAT"] = heartbeat
    failures = 0
    try:
        while True:
            args = list(argv)
            if failures:
                for i in range(0, len(retry_flags) - 1, 2):
                    flag = retry_flags[i]
                    if not any(t.lower() == flag.lower() for t in args):
                        args += [flag, retry_flags[i + 1]]
            cmd = [sys.executable, "-m", module] + args
            if heartbeat:
                rc = run_child_watched(cmd, env, hang_timeout, heartbeat)
            else:
                rc = run_child(cmd, env)
            if rc == 0:
                return 0
            failures += 1
            if failures > retries:
                print(f"retryOnError: giving up after {failures} failures "
                      f"(last rc={rc})", flush=True)
                return rc
            print(f"retryOnError: child died (rc={rc}); restarting in "
                  f"{delay:g}s [{failures}/{retries}]", flush=True)
            time.sleep(delay)
    finally:
        if heartbeat and os.path.exists(heartbeat):
            os.remove(heartbeat)
