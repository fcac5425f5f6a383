"""Observability: package logging, timing, and progress reporting.

The reference has no logging at all — only tqdm bars and stray prints
(SURVEY.md section 5).  This framework routes everything through the standard
``logging`` module (logger name ``euispice_coreg_tpu_torch``) and a pluggable
progress callback, so pipelines can be monitored in production without
stdout scraping.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import time

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("euispice_coreg_tpu_torch")


def enable_console_logging(level=logging.INFO):
    """Attach a simple console handler (idempotent)."""
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)


# Spans (bench attribution).  ``stage`` is the port's one span.  Off (no
# collect_stages() scope and no torch.profiler recording, the production
# default) it costs a flag check and a DEBUG log line when DEBUG is on.
# Inside a collect_stages() scope it adds its host seconds to the scope's
# dict by name and keeps a Span record (parent, file id); a card span also
# records two CUDA events on the current stream, resolved when the scope
# closes.  While a torch.profiler records, it is also a record_function
# range of the same name, on the clock of the card's kernels and copies.
_scope: "Stages | None" = None
_file: int | None = None
_file_ids = itertools.count(1)


def new_file_id() -> int:
    """A fresh id for the spans of one file (``Alignment.__init__``)."""
    return next(_file_ids)


def current_file() -> int | None:
    """The file id the open spans run under, or None."""
    return _file


class Span:
    """One span of a collect_stages() scope: ``name``, ``start_ns`` and
    ``end_ns`` on ``time.perf_counter_ns``, ``parent`` (the index in the
    scope's ``spans`` of the span it opened in, or None), ``file`` (the
    file id or None) and, for a card span on a CUDA device, ``card_s``
    (seconds between its two events on the card's clock)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "file", "card_s")

    def __init__(self, name, start_ns, parent, file):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = None
        self.parent = parent
        self.file = file
        self.card_s = None


class Stages(dict):
    """What a collect_stages() scope yields: ``{span name: host seconds}``,
    summed over repeats, and beside it ``spans`` (every :class:`Span` in
    order of entry), ``counters`` (``{name: total}``, :func:`count`) and
    ``card`` (``{span name: card seconds}`` of the card spans, filled when
    the scope closes)."""

    def __init__(self):
        super().__init__()
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.card: dict = {}
        self._open: list[int] = []   # indices of the spans now open
        self._events: list = []      # (span, start event, end event)

    def _resolve(self):
        """The card extents, after one synchronize."""
        if not self._events:
            return
        torch.cuda.synchronize()
        for span, start, end in self._events:
            span.card_s = start.elapsed_time(end) * 1e-3
            self.card[span.name] = self.card.get(span.name, 0.0) + span.card_s
        self._events.clear()


@contextlib.contextmanager
def collect_stages():
    """Scope that collects the spans of stage()/timed() blocks into the
    yielded :class:`Stages` (re-entrant; inner scopes shadow outer)."""
    global _scope
    prev = _scope
    acc = Stages()
    _scope = acc
    try:
        yield acc
    finally:
        _scope = prev
        acc._resolve()


def stages_active() -> bool:
    """True inside a collect_stages() scope, where stage()/timed() record
    their spans."""
    return _scope is not None


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` of the active collect_stages()
    scope; nothing outside one."""
    if _scope is not None:
        _scope.counters[name] = _scope.counters.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` of the active collect_stages() scope so far; 0
    outside one."""
    return _scope.counters.get(name, 0) if _scope is not None else 0


@contextlib.contextmanager
def stage(label: str, *, card: bool = False, file: int | None = None,
          level=logging.DEBUG):
    """A span named ``label`` over the block, logged at ``level``.

    ``file``: the file id the block and the spans inside it run under
    (default: the enclosing one).  ``card``: the block queues card work it
    does not wait for; inside a collect_stages() scope on a CUDA device its
    card extent is also kept (:class:`Stages`)."""
    global _file
    prev_file = _file
    if file is not None:
        _file = file
    scope = _scope
    t0 = time.perf_counter_ns()
    if scope is None and not _profiler._is_profiler_enabled:
        try:
            yield
        finally:
            _file = prev_file
            if logger.isEnabledFor(level):
                logger.log(level, "%s: %.3f s", label,
                           (time.perf_counter_ns() - t0) * 1e-9)
        return
    with contextlib.ExitStack() as stack:
        if _profiler._is_profiler_enabled:
            stack.enter_context(_profiler.record_function(
                label, f"file={_file}"))
        if scope is not None:
            span = Span(label, t0, scope._open[-1] if scope._open else None,
                        _file)
            scope._open.append(len(scope.spans))
            scope.spans.append(span)
            events = None
            if card and torch.cuda.is_initialized():
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            _file = prev_file
            if scope is not None:
                if events is not None:
                    events[1].record()
                    scope._events.append((span, *events))
                span.end_ns = t1
                scope._open.pop()
                scope[label] = scope.get(label, 0.0) + (t1 - t0) * 1e-9
            if logger.isEnabledFor(level):
                logger.log(level, "%s: %.3f s", label, (t1 - t0) * 1e-9)


def timed(label: str, level=logging.INFO):
    """:func:`stage` logged at INFO: ``with timed('api_submap_s'): ...``"""
    return stage(label, level=level)


# When True, Progress renders a tqdm-style console bar on stderr (in
# addition to any logging handlers).  Toggled by the public API's
# ``display_progress_bar=True`` (the reference shows a tqdm bar per lag
# grid, alignment.py:478).
_console_bar = False


@contextlib.contextmanager
def console_progress_bar(enabled: bool = True):
    """Scope in which Progress draws a console bar (nestable, re-entrant)."""
    global _console_bar
    prev = _console_bar
    _console_bar = bool(enabled)
    try:
        yield
    finally:
        _console_bar = prev


class Progress:
    """Minimal progress reporter: logs every ``every`` steps (and at the
    end), delegates to a user callback ``cb(done, total, label)``, and —
    inside a :func:`console_progress_bar` scope — draws a tqdm-style bar."""

    BAR_WIDTH = 30

    def __init__(self, total: int, label: str = "", every: int | None = None,
                 cb=None, enabled: bool = True):
        self.total = total
        self.label = label
        self.every = every or max(1, total // 10)
        self.cb = cb
        self.enabled = enabled
        self.done = 0
        self._t0 = time.perf_counter()
        self._last_draw = 0.0

    def _draw_bar(self):
        import sys

        now = time.perf_counter()
        finished = self.done >= self.total
        if not finished and now - self._last_draw < 0.1:
            return
        self._last_draw = now
        frac = min(self.done / self.total, 1.0) if self.total else 1.0
        filled = int(self.BAR_WIDTH * frac)
        bar = "#" * filled + "-" * (self.BAR_WIDTH - filled)
        dt = now - self._t0
        rate = self.done / dt if dt > 0 else 0.0
        sys.stderr.write(
            f"\r{self.label}: |{bar}| {self.done}/{self.total} "
            f"[{dt:.1f}s, {rate:.1f}/s]")
        if finished:
            sys.stderr.write("\n")
        sys.stderr.flush()

    def step(self, n: int = 1):
        self.done += n
        if not self.enabled:
            return
        if _console_bar:
            self._draw_bar()
        if self.cb is not None:
            self.cb(self.done, self.total, self.label)
        elif self.done % self.every == 0 or self.done == self.total:
            dt = time.perf_counter() - self._t0
            rate = self.done / dt if dt > 0 else 0.0
            logger.info("%s: %d/%d (%.1f/s)", self.label, self.done,
                        self.total, rate)
