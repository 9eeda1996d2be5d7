"""Tracing / profiling utilities.

The reference's observability is wall-clock stats and a stderr progress
meter (src/main.c:113-117,315-329; roxmain/cr-coder.c:37-49).  Equivalents
here plus what accelerator work actually needs: stage timers that force device
completion, and an optional ``jax.profiler`` trace context for Perfetto/
TensorBoard inspection.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StageTimers:
    """Named wall-clock accumulators; device-synchronized on stop."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                try:
                    import jax

                    jax.block_until_ready(
                        jax.device_put(0)
                    )  # cheap full-queue sync point
                except Exception:
                    pass
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=sys.stderr) -> None:
        total = sum(self.totals.values()) or 1.0
        for name, secs in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(
                f"  {name:24} {secs:8.3f}s {secs / total:6.1%} "
                f"x{self.counts[name]}",
                file=out,
            )


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``jax.profiler`` trace context; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_info() -> str:
    """The GPU's name and power limit as nvidia-smi reports them (a card
    may be set below its maximum and then runs slower under load, so every
    measurement carries this).  Runs nvidia-smi in a child process, which
    stays off JAX; raises OSError or CalledProcessError without one."""
    r = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return "; ".join(r.stdout.strip().splitlines())


class Progress:
    """The reference's percent meter (roxmain/cr-coder.c:37-49)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._last = -1

    def update(self, done: int, total: int) -> None:
        if not self.enabled or total <= 0:
            return
        pct = done * 100 // total
        if pct != self._last:
            self._last = pct
            print(f"\r{pct:3d}%", end="", file=sys.stderr, flush=True)
            if pct >= 100:
                print("", file=sys.stderr)
