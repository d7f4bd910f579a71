"""Subprocess supervision for the agent's sidecar processes.

Reference: pkg/launcher (the generic restarting subprocess supervisor
the agent uses for cilium-node-monitor, cilium-health and cilium-envoy)
and pkg/envoy/envoy.go:121-143 (the restart loop: if the child exits
while the agent is running, relaunch it after a pause)."""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..utils.logging import get_logger

log = get_logger("launcher")


class ChildLauncher:
    """Spawn an argv and keep it alive (pkg/launcher role)."""

    name = "child"

    def __init__(
        self,
        argv: List[str],
        restart_backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
    ) -> None:
        self.argv = list(argv)
        self.restart_backoff_s = restart_backoff_s
        self.max_backoff_s = max_backoff_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None
        self.restarts = 0

    def start(self) -> "ChildLauncher":
        self._thread = threading.Thread(target=self._supervise, daemon=True)
        self._thread.start()
        return self

    def _spawn(self) -> subprocess.Popen:
        # NOTE: no preexec_fn — it forces the fork() slow path, which
        # deadlocks under the CUDA runtime's and PyTorch's threads. The
        # children pin themselves to the agent's lifetime instead
        # (utils.procutil.die_with_parent in their mains), so a
        # SIGKILLed agent never leaks sidecars; the env var closes the
        # fork→prctl race for them.
        import os

        env = dict(os.environ)
        env["CILIUM_TPU_PARENT_PID"] = str(os.getpid())
        # _lock guards the child Popen handle; _spawn runs only on
        # start and on crash-restart (rare), and racing spawns would
        # leak sidecars — accepted hold
        return subprocess.Popen(  # policyd-lint: disable=LOCK002
            self.argv,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            env=env,
        )

    def _supervise(self) -> None:
        backoff = self.restart_backoff_s
        first = True
        while not self._stop.is_set():
            with self._lock:
                self._proc = self._spawn()
                proc = self._proc
            if self._stop.is_set():
                # stop() raced the spawn: it saw the PREVIOUS (dead)
                # proc under the lock, so this fresh child is ours to
                # reap or it leaks holding the sockets
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                return
            if not first:
                self.restarts += 1
            first = False
            while not self._stop.is_set():
                try:
                    proc.wait(timeout=0.2)
                    break
                except subprocess.TimeoutExpired:
                    continue
            if self._stop.is_set():
                return
            rc = proc.returncode
            log.warning(
                f"{self.name} exited; restarting",
                fields={"rc": rc, "backoff_s": backoff},
            )
            # interruptible sleep: a stop during backoff must not spawn
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, self.max_backoff_s)

    def pid(self) -> Optional[int]:
        with self._lock:
            return self._proc.pid if self._proc and self._proc.poll() is None else None

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=timeout)
        if self._thread is not None:
            self._thread.join(timeout=timeout)


class ProxyLauncher(ChildLauncher):
    """Supervised ``python -m cilium_tpu_torch.proxy``."""

    name = "external proxy"

    def __init__(
        self,
        xds_socket: str,
        accesslog_socket: Optional[str] = None,
        extra_args: Optional[List[str]] = None,
        **kw,
    ) -> None:
        argv = [sys.executable, "-m", "cilium_tpu_torch.proxy", "--xds", xds_socket]
        if accesslog_socket:
            argv += ["--accesslog", accesslog_socket]
        argv += list(extra_args or ())
        super().__init__(argv, **kw)


class MonitorLauncher(ChildLauncher):
    """Supervised ``python -m cilium_tpu_torch.monitor`` (the
    cilium-node-monitor process the reference's agent launches,
    monitor/monitor.go + pkg/launcher)."""

    name = "node monitor"

    def __init__(self, listen_socket: str, feed_socket: str, **kw) -> None:
        super().__init__(
            [
                sys.executable, "-m", "cilium_tpu_torch.monitor",
                "--listen", listen_socket, "--feed", feed_socket,
            ],
            **kw,
        )


class HealthLauncher(ChildLauncher):
    """Supervised ``python -m cilium_tpu_torch.health`` (the cilium-health
    sidecar the reference's agent launches at boot,
    daemon/main.go:927-945)."""

    name = "health endpoint"

    def __init__(
        self,
        agent_socket: str,
        api_socket: str,
        listen_ip: str = "127.0.0.1",
        port: int = 0,
        interval: float = 60.0,
        **kw,
    ) -> None:
        super().__init__(
            [
                sys.executable, "-m", "cilium_tpu_torch.health",
                "--agent", agent_socket, "--api", api_socket,
                "--listen-ip", listen_ip, "--port", str(port),
                "--interval", str(interval),
            ],
            **kw,
        )
