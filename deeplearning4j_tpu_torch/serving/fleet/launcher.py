"""Spawn and supervise replica PROCESSES (smoke, chaos; port of
`deeplearning4j_tpu/serving/fleet/launcher.py`). Each replica is a fresh
interpreter running `replica_main` with a JSON config; the launcher waits
for the `FLEET_REPLICA_READY port=...` rendezvous line and hands back a
ReplicaProcess whose pid a chaos run can kill. Stderr streams to a log
file so a dead replica leaves evidence.

A replica builds its CUDA kernels at first use (`ops/cuda_build.py`), and
two replicas may start at once over one build directory. That is safe:
each `nvcc` writes a temporary file named by its own pid and moves it in
place with `os.replace`, which is atomic, so a process loads either
nothing or a whole library, and the second replace of the same digest's
name puts an identical file there (a process that already loaded the
first keeps its mapping of the old inode)."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional


class ReplicaLaunchError(RuntimeError):
    """The replica process died or never reported ready in time."""


class ReplicaProcess:
    """Handle on one spawned replica: name/role/url for the router,
    pid for the chaos harness, terminate() for clean teardown."""

    def __init__(self, name: str, role: str, port: int,
                 proc: subprocess.Popen, log_path: str):
        self.name = name
        self.role = role
        self.port = port
        self.proc = proc
        self.log_path = log_path

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def handle(self):
        """Router-side record for this process."""
        from deeplearning4j_tpu_torch.serving.fleet.router import ReplicaHandle
        return ReplicaHandle(self.name, self.url, self.role)

    def terminate(self, timeout: float = 10.0) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout)

    def tail(self, n: int = 40) -> str:
        try:
            with open(self.log_path, "r", errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return ""


def launch_replica(config: dict, *, timeout_s: float = 120.0,
                   env: Optional[dict] = None,
                   log_dir: Optional[str] = None) -> ReplicaProcess:
    """Start one replica process from a declarative config and block
    until its HTTP server is up. The child inherits this interpreter (no
    install assumptions) and runs on the card unless
    FLEET_REPLICA_PLATFORM=cpu (in this environment or `env`) asks for
    the CPU."""
    name = config.get("name", "replica")
    log_dir = log_dir or tempfile.mkdtemp(prefix="fleet_")
    log_path = os.path.join(log_dir, f"{name}.log")
    child_env = dict(os.environ)
    child_env.update(env or {})
    child_env["FLEET_REPLICA_CONFIG"] = json.dumps(config)
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.serving.fleet.replica_main"],
        stdout=subprocess.PIPE, stderr=log, env=child_env, text=True)
    deadline = time.monotonic() + timeout_s
    port = None
    try:
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                if proc.poll() is not None:
                    break
                continue
            line = line.strip()
            if line.startswith("FLEET_REPLICA_READY"):
                port = int(line.split("port=", 1)[1])
                break
    finally:
        log.close()
    if port is None:
        rc = proc.poll()
        try:
            with open(log_path, "r", errors="replace") as f:
                tail = "".join(f.readlines()[-20:])
        except OSError:
            tail = ""
        proc.kill()
        raise ReplicaLaunchError(
            f"replica {name!r} never became ready "
            f"(exit={rc}); log tail:\n{tail}")
    return ReplicaProcess(name, config.get("role", "mixed"), port,
                          proc, log_path)
