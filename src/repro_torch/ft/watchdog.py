"""Straggler detection: per-step wall-clock EWMA with deviation flagging.

On a real multi-pod deployment each host reports step durations; a host whose
EWMA exceeds ``threshold`` x the fleet median is flagged and the controller
swaps in a hot spare (and excludes the host from the next mesh).  Here the
fleet is simulated (tests inject synthetic clocks), but the policy code is the
deployable part.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HostStat:
    ewma: float = 0.0
    n: int = 0


class StragglerWatchdog:
    def __init__(self, threshold: float = 1.5, alpha: float = 0.3,
                 min_samples: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.min_samples = min_samples
        self.hosts: dict[str, HostStat] = {}

    def report(self, host: str, step_seconds: float) -> None:
        st = self.hosts.setdefault(host, HostStat())
        st.ewma = step_seconds if st.n == 0 else \
            self.alpha * step_seconds + (1 - self.alpha) * st.ewma
        st.n += 1

    def _median_ewma(self) -> float:
        vals = sorted(s.ewma for s in self.hosts.values()
                      if s.n >= self.min_samples)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> list[str]:
        med = self._median_ewma()
        if med <= 0:
            return []
        return sorted(h for h, s in self.hosts.items()
                      if s.n >= self.min_samples and s.ewma > self.threshold * med)

    def healthy_hosts(self) -> list[str]:
        bad = set(self.stragglers())
        return sorted(h for h in self.hosts if h not in bad)


class StepTimer:
    """Context manager reporting wall-clock steps to a watchdog."""

    def __init__(self, watchdog: StragglerWatchdog, host: str):
        self.wd = watchdog
        self.host = host

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.wd.report(self.host, time.monotonic() - self.t0)
        return False
