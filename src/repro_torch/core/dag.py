"""Job DAG with channel serialization and critical-path DP (paper Eq. 4).

Inference is a DAG of jobs; each job is computation or a memory copy and
executes on one *channel* (gpu / cpu / htod / dtoh).  Jobs on the same
channel serialize in submission order (hardware queues), which the builder
encodes as implicit edges.  ``earliest_finish`` computes

    dp[v] = max_{u in preds(v)} dp[u] + cost(v)

over the topological order (nodes are appended in topological order by
construction).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

CHANNELS = ("gpu", "cpu", "htod", "dtoh", "comm")


@dataclass
class Job:
    name: str
    channel: str
    duration: float
    deps: List[int] = field(default_factory=list)
    finish: float = 0.0


class JobDag:
    def __init__(self) -> None:
        self.jobs: List[Job] = []
        self._last_on_channel: Dict[str, int] = {}

    def add(
        self,
        name: str,
        channel: str,
        duration: float,
        deps: Optional[List[int]] = None,
        serialize: bool = True,
    ) -> int:
        """Append a job (topological order).  Returns its id."""
        assert channel in CHANNELS, channel
        deps = list(deps or [])
        if serialize and channel in self._last_on_channel:
            deps.append(self._last_on_channel[channel])
        jid = len(self.jobs)
        self.jobs.append(Job(name, channel, max(duration, 0.0), deps))
        self._last_on_channel[channel] = jid
        return jid

    def earliest_finish(self) -> float:
        """Critical-path DP over the topological (insertion) order."""
        best = 0.0
        for j in self.jobs:
            start = max((self.jobs[d].finish for d in j.deps), default=0.0)
            j.finish = start + j.duration
            best = max(best, j.finish)
        return best

    def channel_busy(self) -> Dict[str, float]:
        busy: Dict[str, float] = {c: 0.0 for c in CHANNELS}
        for j in self.jobs:
            busy[j.channel] += j.duration
        return busy

    def critical_path(self) -> List[str]:
        """Names along the critical path (for diagnostics)."""
        if not self.jobs:
            return []
        self.earliest_finish()
        v = max(range(len(self.jobs)), key=lambda i: self.jobs[i].finish)
        path = []
        while True:
            path.append(self.jobs[v].name)
            deps = self.jobs[v].deps
            if not deps:
                break
            v = max(deps, key=lambda i: self.jobs[i].finish)
        return list(reversed(path))
