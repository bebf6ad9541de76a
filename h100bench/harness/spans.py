"""What the per-layer readers of the program's own tracing share: its spans
(`octave.*` host events of the traced stretch, from `utils.profiling.span`)
clipped to the stretch, and its set-up phases (`utils.profiling.phases()` of
the run's process). A program without them gives nothing to read."""
from __future__ import annotations

from typing import Iterable, List, Optional

from harness.trace import union_seconds


def _clipped(r, names: Iterable[str]) -> List[tuple]:
    names = set(names)
    lo, hi = r.t0, r.t0 + r.window_s
    return [(max(a, lo), min(b, hi)) for n, a, b in r.host if n in names and b > lo and a < hi]


def has(r, names: Iterable[str]) -> bool:
    """Whether the stretch holds a span of any of `names`."""
    names = set(names)
    return any(n in names for n, _, _ in r.host)


def busy_seconds(r, busy: Iterable[str], waits: Iterable[str]) -> Optional[float]:
    """Seconds of the stretch covered by a span of `busy` and by none of
    `waits` (|B u W| - |W|), or None without a `busy` span."""
    busy, waits = tuple(busy), tuple(waits)
    if not has(r, busy):
        return None
    return union_seconds(_clipped(r, busy + waits)) - union_seconds(_clipped(r, waits))


def program(r) -> List[tuple]:
    """The program's spans of the stretch: (name, start s, end s)."""
    return [e for e in r.host if e[0].startswith("octave.")]


def innermost(spans: List[tuple], t: float) -> Optional[str]:
    """Of `spans` (`program(r)`), the one under way at `t` that started
    last: the innermost of those nested there."""
    name, start = None, float("-inf")
    for n, a, b in spans:
        if a <= t < b and a >= start:
            name, start = n, a
    return name


def _recorded(r) -> list:
    """The phases the run's process recorded before the traced stretch
    began (phases and spans share Unix-epoch time); [] where the program
    records none."""
    try:
        from octave_tpu_torch.utils import profiling
    except ImportError:
        return []
    phases = getattr(profiling, "phases", None)
    return [] if phases is None else [p for p in phases() if p.end_ns * 1e-9 <= r.t0]


def setup_phases(r, names: Iterable[str]) -> list:
    """The set-up phases of `names` (`_recorded`)."""
    names = set(names)
    return [p for p in _recorded(r) if p.name in names]


def setup_seconds(r, names: Iterable[str]) -> Optional[float]:
    """The summed self time of the set-up phases of `names`: each one's
    seconds less those of the phases recorded inside it (nvcc's
    `octave.kernels.build` in a checkout's first run), or None without one."""
    names = set(names)
    recorded = _recorded(r)
    chosen = [p for p in recorded if p.name in names]
    if not chosen:
        return None
    return sum(p.seconds - sum(c.seconds for c in recorded if c.parent == p.name
                               and p.start_ns <= c.start_ns and c.end_ns <= p.end_ns)
               for p in chosen)
