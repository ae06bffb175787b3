"""Runtime dispatch/compile contracts: ``dispatch_budget``.

This module pins the *observed* behaviour of the hot paths.  Two signals:

* **compiles** — the port has no JIT: eager PyTorch compiles nothing per
  shape.  Its only compiles are the ``nvcc`` builds of the CUDA sources
  and the loading of a built library into the process
  (:mod:`repro_torch.kernels.build`), which report themselves through
  :func:`record_compile`.  The delta across a scope is the number of
  builds and loads it caused; a warm path counts 0.
* **dispatches** — the repo's own device-program call sites self-report
  through :func:`record_dispatch` (``admission.drain``,
  ``admission.columns``, ``admission.scatter``, ``admission.dev_sync``,
  ``cluster.first_attempt``, ``fleet.engine``, ``serve.batch``, ...).
  The counter is a plain dict increment — nanoseconds against the
  dispatches it counts.

Usage::

    with dispatch_budget(compiles=0, forbid=("admission.dev_sync",)) as b:
        sim.run()
    # raises DispatchBudgetError on exit if the scope built or loaded a
    # kernel library or rebuilt device state; b.compiles / b.tag_counts
    # stay readable.

This module imports nothing of the package, so any module can import it.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

_compile_count = 0
_compile_lock = threading.Lock()  # builds run on several threads at once
_dispatches: Counter = Counter()

# Optional observers installed by repro_torch.obs.trace.enable(): called
# as hook(tag, n) after every record_dispatch and hook(source, event,
# seconds) after every record_compile.  None (one pointer check) whenever
# tracing is off; contracts never imports repro_torch.obs.
_obs_dispatch_hook = None
_obs_compile_hook = None


def record_dispatch(tag: str, n: int = 1) -> None:
    """Self-report ``n`` device-program executions under ``tag``.

    Called by the engine at every site that launches a device program
    (or, for ``*.dev_sync`` tags, re-uploads device state wholesale).
    Unconditional and cheap; budgets read the counter deltas.
    """
    _dispatches[tag] += n
    if _obs_dispatch_hook is not None:
        _obs_dispatch_hook(tag, n)


def record_compile(source: str, event: str, seconds: float) -> None:
    """Self-report one compile: ``event`` is ``"build"`` (``nvcc`` built
    ``source``'s library) or ``"load"`` (a built library was loaded into
    the process).  Called by :mod:`repro_torch.kernels.build` only."""
    global _compile_count
    with _compile_lock:
        _compile_count += 1
    if _obs_compile_hook is not None:
        _obs_compile_hook(source, event, seconds)


def compile_count() -> int:
    """Kernel builds and library loads observed so far."""
    return _compile_count


def dispatch_counts() -> Counter:
    """Copy of the global per-tag dispatch counter."""
    return Counter(_dispatches)


class DispatchBudgetError(AssertionError):
    """A dispatch/compile contract was violated inside a budget scope."""


class Budget:
    """Live view of compile/dispatch activity since scope entry."""

    def __init__(self, compiles, dispatches, tags, forbid):
        self.max_compiles = compiles
        self.max_dispatches = dispatches
        self.tags = tuple(tags) if tags else None
        self.forbid = tuple(forbid)
        self._compiles0 = _compile_count
        self._dispatches0 = Counter(_dispatches)

    @property
    def compiles(self) -> int:
        return _compile_count - self._compiles0

    @property
    def tag_counts(self) -> Counter:
        now = Counter(_dispatches)
        now.subtract(self._dispatches0)
        return +now

    @property
    def dispatches(self) -> int:
        counts = self.tag_counts
        if self.tags is not None:
            return sum(counts[t] for t in self.tags)
        return sum(counts.values())

    def violations(self) -> list[str]:
        out = []
        if self.max_compiles is not None and self.compiles > self.max_compiles:
            out.append(
                f"compiled {self.compiles} new programs "
                f"(budget {self.max_compiles})")
        if (self.max_dispatches is not None
                and self.dispatches > self.max_dispatches):
            scope = f" across tags {list(self.tags)}" if self.tags else ""
            out.append(
                f"launched {self.dispatches} dispatches{scope} "
                f"(budget {self.max_dispatches})")
        counts = self.tag_counts
        for tag in self.forbid:
            if counts[tag]:
                out.append(
                    f"forbidden dispatch tag `{tag}` fired "
                    f"{counts[tag]}x")
        return out


@contextlib.contextmanager
def dispatch_budget(compiles: int | None = None,
                    dispatches: int | None = None,
                    tags=None,
                    forbid=()):
    """Assert compile/dispatch ceilings over a scope.

    ``compiles``   — max NEW kernel builds + library loads allowed (None:
                     untracked).
    ``dispatches`` — max recorded dispatches, optionally restricted to
                     ``tags`` (None: untracked).
    ``forbid``     — dispatch tags that must not fire at all.

    Raises :class:`DispatchBudgetError` on scope exit listing every
    violated ceiling; yields a :class:`Budget` whose ``compiles`` /
    ``dispatches`` / ``tag_counts`` stay readable after exit.
    """
    budget = Budget(compiles, dispatches, tags, forbid)
    yield budget
    problems = budget.violations()
    if problems:
        raise DispatchBudgetError(
            "dispatch budget violated: " + "; ".join(problems))
