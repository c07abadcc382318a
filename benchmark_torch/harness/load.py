"""The served process's side of the load process (``harness/client.py``):
start it, send it commands, read its answers."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

from .common import ROOT


def message(d: dict) -> SimpleNamespace:
    """A message as the load process reported it (times in seconds from its
    window's start)."""
    m = SimpleNamespace(**d)
    m.sources = [tuple(s) for s in m.sources]
    m.ok = m.error is None and m.sources_at is not None and bool(m.sources)
    return m


class Load:
    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, "-m", "benchmark_torch.harness.client"], cwd=ROOT,
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)
        self.ollama_port = self.read()["ollama_port"]

    def read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load process ended (code {self.proc.poll()})")
        return json.loads(line)

    def send(self, **cmd) -> None:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()

    def ask(self, **cmd) -> dict:
        self.send(**cmd)
        return self.read()

    def burst(self, texts: list[str]) -> list:
        return [message(d) for d in self.ask(cmd="burst", texts=texts)["messages"]]

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.send(cmd="quit")
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def sleep_until(epoch: float) -> None:
    wait = epoch - time.time()
    if wait > 0:
        time.sleep(wait)
