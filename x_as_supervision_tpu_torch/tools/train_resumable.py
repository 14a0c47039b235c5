"""Crash- and hang-resilient training driver of the port: the twin of the
JAX package's scripts/train_resumable.sh, in Python so that its windows can
be short where it is tested (scripts/torch/train_resumable.sh runs it).

    python -m x_as_supervision_tpu_torch.tools.train_resumable \\
        <config> <log_dir> [--poll SECONDS] [train CLI args ...]

It runs the port's train CLI (``python -m x_as_supervision_tpu_torch.train``,
or ``train2d3d`` for a TikTok or MPII config, as scripts/train.sh routes)
with ``--config <config> --log_dir <log_dir>`` and the other args, and if it
dies or wedges, runs it again, up to 12 attempts:

  * resume (``--checkpoint``) from the newest complete checkpoint of the
    newest run directory under <log_dir> (train/checkpoint.py:
    latest_checkpoint, which passes over a save that was cut short);
  * else, while that run has no checkpoint of its own and XAS_INIT_CKPT
    names one, ``--finetune --checkpoint $XAS_INIT_CKPT`` (an S1 -> S2
    stage keeps its S1 initialization when it dies before its first save);
  * else a fresh start.

Hang detection: every ``--poll`` seconds (60) once the attempt is older
than XAS_GRACE_SECS (3000; the first steps' allowance), the newest
``<log_dir>/*/tensorboard/events*`` is checked; when no write to it, and
not the attempt's start either, is younger than XAS_STALL_SECS (1200), the
attempt is killed and the next resumes. An attempt is not charged for a
silence that began before it started: that lets a short grace work, where
the JAX driver needs its grace to cover the next attempt's start-up.

The attempt runs in a session of its own. A kill signals its process group
and every process descended from it (torchrun starts each worker in a
session of its own, so the group alone would miss them and leave ranks
holding the cards): SIGTERM with SIGCONT (a stopped process takes the
SIGTERM only once continued), then SIGKILL to whatever is left after 10 s.
A signal to the driver itself kills the attempt the same way. There are no
Orbax temporary directories to clear: a save cut short leaves a
``_ckpt`` without ``state.pt``, which the next attempt passes over.

Exits 0 when an attempt exits 0, 1 after 12 that did not.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time

from ..train.checkpoint import latest_checkpoint

ATTEMPTS = 12
POLL_SECS = 60.0
RETRY_PAUSE_SECS = 5.0
KILL_WAIT_SECS = 10.0
_PACKAGE = "x_as_supervision_tpu_torch"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def say(line: str) -> None:
    print(f"[resumable] {line}", flush=True)


def cli_module(config_path: str) -> str:
    """The train CLI of a config, routed by its name as scripts/train.sh
    routes it."""
    if "TikTok" in config_path or "MPII" in config_path:
        return f"{_PACKAGE}.train2d3d"
    return f"{_PACKAGE}.train"


def newest_run(log_dir: str) -> str | None:
    """The run directory under `log_dir` modified last, or None."""
    runs = [d for d in glob.glob(os.path.join(log_dir, "*"))
            if os.path.isdir(d)]
    return max(runs, key=os.path.getmtime) if runs else None


def newest_events(log_dir: str) -> str | None:
    files = glob.glob(os.path.join(log_dir, "*", "tensorboard", "events*"))
    return max(files, key=os.path.getmtime) if files else None


def attempt_args(log_dir: str, init_ckpt: str | None) -> tuple[str, list]:
    """(what the attempt does, its checkpoint flags)."""
    run = newest_run(log_dir)
    ckpt = latest_checkpoint(run) if run else None
    if ckpt:
        return f"resuming from {ckpt}", ["--checkpoint", ckpt]
    if init_ckpt:
        return (f"finetune from {init_ckpt}",
                ["--finetune", "--checkpoint", init_ckpt])
    return "fresh start", []


def _children() -> dict:
    """{pid: [child pids]} of every process in /proc."""
    kids: dict = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name may hold spaces and parentheses: fields after
        # its last ')' are state, ppid, ...
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        kids.setdefault(ppid, []).append(int(name))
    return kids


def descendants(pid: int) -> list[int]:
    """Every process descended from `pid` (not `pid` itself)."""
    if not os.path.isdir("/proc"):
        return []
    kids, out, todo = _children(), [], [pid]
    while todo:
        for child in kids.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _signal(pids: list, groups: set, sig) -> None:
    for g in groups:
        try:
            os.killpg(g, sig)
        except OSError:
            pass
    for p in pids:
        try:
            os.kill(p, sig)
        except OSError:
            pass


def kill_tree(proc: subprocess.Popen, wait: float = KILL_WAIT_SECS) -> None:
    """Ends the attempt `proc` (started in a session of its own) and every
    process descended from it: SIGTERM and SIGCONT to their process groups
    and to each, then SIGKILL to those left after `wait` seconds."""
    pids = [proc.pid] + descendants(proc.pid)
    own = os.getpgrp()
    groups = set()
    for p in pids:
        try:
            groups.add(os.getpgid(p))
        except OSError:
            pass
    groups.discard(own)
    _signal(pids, groups, signal.SIGTERM)
    _signal(pids, groups, signal.SIGCONT)
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        proc.poll()  # reaps the attempt itself
        if not any(_alive(p) for p in pids):
            break
        time.sleep(0.1)
    _signal([p for p in pids if _alive(p)], groups, signal.SIGKILL)
    proc.wait()


def run(config: str, log_dir: str, train_args: list, poll: float = POLL_SECS,
        pause: float = RETRY_PAUSE_SECS, python: list | None = None,
        env: dict | None = None) -> int:
    """The driver's loop (module docstring); returns the exit code.
    `python`: the command that runs a module (``python -m`` follows it;
    default this interpreter); `env`: the attempts' environment (default
    this process's), from which XAS_STALL_SECS, XAS_GRACE_SECS and
    XAS_INIT_CKPT are read too."""
    env = dict(os.environ if env is None else env)
    stall = float(env.get("XAS_STALL_SECS") or 1200)
    grace = float(env.get("XAS_GRACE_SECS") or 3000)
    init_ckpt = env.get("XAS_INIT_CKPT") or None
    # the attempts find the package from any working directory
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    module = cli_module(config)
    python = list(python or [sys.executable])
    for attempt in range(1, ATTEMPTS + 1):
        what, ckpt_args = attempt_args(log_dir, init_ckpt)
        cmd = python + ["-m", module, "--config", config, *ckpt_args,
                        "--log_dir", log_dir, *train_args]
        proc = subprocess.Popen(cmd, env=env, start_new_session=True)
        start = time.time()
        say(f"attempt {attempt}: {what} (pid {proc.pid})")
        try:
            while True:
                try:
                    rc = proc.wait(timeout=poll)
                    break
                except subprocess.TimeoutExpired:
                    pass
                now = time.time()
                if now - start < grace:
                    continue
                ev = newest_events(log_dir)
                if ev is None:
                    continue
                age = now - max(os.path.getmtime(ev), start)
                if age > stall:
                    say(f"no TB write for {age:.0f}s - killing hung pid "
                        f"{proc.pid} and its processes")
                    kill_tree(proc)
                    rc = proc.returncode
                    break
        except BaseException:
            kill_tree(proc)
            raise
        if rc == 0:
            say(f"finished after {attempt} attempt(s)")
            return 0
        say(f"train exited rc={rc}; retrying from checkpoint")
        time.sleep(pause)
    say(f"giving up after {ATTEMPTS} attempts")
    return 1


def _terminate(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="crash- and hang-resilient train driver; the args "
                    "after <log_dir> go to the train CLI",
        allow_abbrev=False)
    p.add_argument("config")
    p.add_argument("log_dir")
    p.add_argument("--poll", type=float, default=POLL_SECS,
                   help="seconds between the watchdog's checks")
    opt, train_args = p.parse_known_args(argv)
    signal.signal(signal.SIGTERM, _terminate)
    return run(opt.config, opt.log_dir, train_args, poll=opt.poll)


if __name__ == "__main__":
    sys.exit(main())
