"""Spans and counters of a fit, and a profiler block.

`trace` profiles a block with torch.profiler (phlash_tpu: jax.profiler)
and writes its trace where TensorBoard's profiler plugin, chrome://tracing
or Perfetto read it.

Inside `mcmc.fit` the port records named spans, each with its start and
end on `time.perf_counter_ns()` (system-wide on Linux, so the spawn pool's
workers stamp on the same clock), its parent, the fit's id, the call's
index and counters, in one `FitTrace` a fit: `fit` opens it on entry and
closes it on the way out, also when the callback raises, and
`last_fit()` returns the newest of the process.  A span opened while no
fit is open records nothing.  The spans:

    phlash.fit                    the whole fit (attribute: its id)
      phlash.start                fit's entry to the loop
        phlash.start.ingest       data.init_mcmc_data
          phlash.ingest.pool_start  the pool's creation to its first task's start
          phlash.ingest.read      one per contig, the reader's own stamps
                                  (attributes: contig, parse_s, chunk_s)
          phlash.ingest.concat    the AFS sum and the chunks' concatenation
        phlash.start.build        training.build_training
          phlash.start.upload     a copy of chunk rows or warm-ups to the
                                  device (counter: upload_bytes)
        phlash.start.elpd_setup   mcmc.held_out_elpd (with its uploads)
      phlash.call                 one call of the loop (attributes: call, k)
        phlash.call.draw          the minibatch indices
        phlash.call.launch        training.Caller: the static-buffer
                                  copies and the graph's replay
          phlash.capture          a graph's warm-up and capture (attributes:
                                  key, warmup_s, capture_s)
        phlash.call.finite_check  the finiteness check
        phlash.call.elpd_read     the held-out ELPD's read-back
        phlash.call.checkpoint    a checkpoint's hand-off to its writer
        phlash.call.readback      the cloud's gather, copy to the host and to_dm
        phlash.call.user_callback the callback's body
          phlash.mesh.collective  on a mesh, a collective issued on the host
                                  (parallel/mesh.py), under whichever span issued it
      phlash.checkpoint.write     a checkpoint's write on the writer's thread
                                  (attribute: step), from the worker's stamps,
                                  recorded when the fit joins the worker
                                  (checkpoint.py), under the span open then

The start's spans, `phlash.capture` and `phlash.checkpoint.write` are
always recorded: about ten a fit, one per contig and one per save.  The
call's spans (`phlash.call`, `phlash.call.*` and `phlash.mesh.collective`)
are recorded only while torch's profiler records; a site
then also opens a profiler range of the span's name, so the span sits in
the profiler's trace on the same timeline as the device's work (`trace`
around a fit shows every span).
With the profiler off, a call's span site reads one flag and allocates
nothing.  Counters (`count`) add to the innermost recorded open span and,
when it closes, to its parent: `host_syncs` counts the loop's blocking
reads of the device (the finiteness check, the ELPD read and the
read-back's copy), and on a mesh `collectives` counts every collective
(parallel/mesh.py's tally adds to it, a graph replay what it captured).

The kernels' counters live here too, in one registry that names no kernel.
A module declares a `Tally` (a named set of integer counters on the host:
its launches, its work) where it is defined, and every tally registers
itself, so training.Caller takes a CUDA graph capture's share back and
adds it at each replay (`snapshot`, `since`, `replay`).  The counter sets
made with `fit_record=True`, and the split launches' device counters
(ops/split.DeviceCounters), belong to the fit's record: `records_fit`
zeroes them when a fit opens and reads them into `FitTrace.counts` when
its record closes (the device's once, so no call syncs for them; zeros
where nothing split, as on the CPU).  These are the SMC' kernels' and the
packed kernels' four device counts each (ops/smc.DEVICE_COUNTS,
ops/packed.DEVICE_COUNTS), the SMC' split adjoint's host tallies
(ops/smc.SPLIT_COUNTS: smc_adjoint_split_launches, and
smc_adjoint_split_warps, K times the unsplit grid's warps a launch; their
ratio over the SM count is the warps an SM its plans asked for) and the
packed kernels' host tallies
(ops/packed.WORK_COUNTS: packed_sites, the instance-sites B4 and B5 swept,
and packed_ckpt_bytes, the checkpoint bytes B4 wrote), zeros on a fit of
another backend, and the checkpoint writer's (checkpoint.SAVE_COUNTS:
ckpt_saves, ckpt_bytes, ckpt_waits), zeros on a fit without checkpoints.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import time

_ids = itertools.count(1)
_open: FitTrace | None = None  # the fit being recorded
_last: FitTrace | None = None  # the newest fit of the process
_autograd_profiler = None  # torch.autograd.profiler, once a fit has opened
_tallies: list[Tally] = []  # every host tally, in the order they were made
_fit_record: list = []  # the counter sets a fit's record zeroes and reads


class Tally:
    """A named set of integer counters on the host: `add` one, and
    `counts` / `reset` / `add_counts` the set (a module binds these as its
    own functions).  `keys` are the counters `reset` sets to zero; `add`
    may make others, which `reset` drops.  Every tally registers itself for
    graph replays; with fit_record=True it also belongs to the fit's record."""

    __slots__ = ("keys", "n")

    def __init__(self, keys: tuple = (), fit_record: bool = False):
        self.keys = tuple(keys)
        self.reset()
        _tallies.append(self)
        if fit_record:
            in_fit_record(self)

    def add(self, key: str, n: int = 1) -> None:
        self.n[key] = self.n.get(key, 0) + n

    def counts(self) -> dict:
        return dict(self.n)

    def reset(self) -> None:
        self.n = dict.fromkeys(self.keys, 0)

    def add_counts(self, n: dict) -> None:
        "Add `n`, a dict as counts() gives it (a graph replay's share), to the counters."
        for k, v in n.items():
            self.n[k] = self.n.get(k, 0) + v


def in_fit_record(counters) -> None:
    """Make a counter set (its `reset()` and `counts()`) part of every fit's
    record: zeroed when a fit opens, read into FitTrace.counts when it closes."""
    _fit_record.append(counters)


def snapshot() -> dict:
    "Every tally's counts now (taken before a graph capture)."
    return {t: t.counts() for t in _tallies}


def since(before: dict) -> list:
    """What the tallies counted since `before` (a snapshot): (tally, its
    changed counters and their changes) for each tally that changed."""
    out = []
    for t in _tallies:
        b = before.get(t, {})
        n = {k: v - b.get(k, 0) for k, v in t.n.items() if v != b.get(k, 0)}
        if n:
            out.append((t, n))
    return out


def replay(share: list, sign: int = 1) -> None:
    "Add `share` (since's) to the tallies, once a graph replay; sign=-1 takes it back."
    for t, n in share:
        t.add_counts(n if sign == 1 else {k: -v for k, v in n.items()})


class Span:
    """A span's record and its context manager: `name`, `start` and `end`
    (perf_counter_ns; end None while open), `parent` (index in the fit's
    spans, None at the root), `fit` (the fit's id), `call` (the loop's call
    index, None in the start), `attrs`, `counts` (counters, its children's
    included) and `raised` (it closed on an exception)."""

    __slots__ = ("name", "start", "end", "parent", "fit", "call", "attrs", "counts", "raised",
                 "_trace", "_range", "_index")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name, self.attrs = name, attrs or {}
        self.start = self.end = self.parent = self.fit = self.call = None
        self.counts: dict[str, int] = {}
        self.raised = False
        self._trace = self._range = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> Span:
        tr = _open
        if tr is not None:
            tr._push(self)
            if _autograd_profiler._is_profiler_enabled:
                from torch._C._profiler import _RecordFunctionFast

                # a host op in the profiler's trace (a record_function range
                # would also add a device-side annotation to its events)
                self._range = _RecordFunctionFast(self.name)
                self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end = time.perf_counter_ns()
        self.raised = exc_type is not None
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._trace is not None:
            self._trace._pop(self)


class _NoSpan:
    "What a call's span site opens while the profiler is off."

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NO_SPAN = _NoSpan()


class FitTrace:
    """The spans of one fit, in the order they opened, and the loop's
    throughput: `iterations` (SVGD iterations the loop ran) and `rate`
    (iterations a second between the first call's callback and the last
    call's; where the fit has no callback, the points where it would run);
    `counts`, the kernels' counts of the fit (empty until it closes)."""

    def __init__(self):
        self.id = next(_ids)
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.iterations = 0
        self.closed = False
        self.call: int | None = None  # index of the call running
        self._stack: list[Span] = []
        self._first = self._last = None  # (perf_counter_ns, iterations) at callbacks

    def _push(self, s: Span) -> None:
        s._trace, s.fit, s.call = self, self.id, self.call
        s.parent = self._stack[-1]._index if self._stack else None
        s._index = len(self.spans)
        self.spans.append(s)
        self._stack.append(s)

    def _pop(self, s: Span) -> None:
        self._stack.pop()  # spans close innermost first
        if s.counts and self._stack:
            up = self._stack[-1].counts
            for k, n in s.counts.items():
                up[k] = up.get(k, 0) + n

    def at_callback(self) -> None:
        "Stamp the point where the loop hands a call's cloud to the callback."
        self._last = (time.perf_counter_ns(), self.iterations)
        if self._first is None:
            self._first = self._last

    @property
    def rate(self) -> float:
        "Iterations a second between the first callback and the last (0.0 before a second)."
        if self._first is None or self._last[0] == self._first[0]:
            return 0.0
        return (self._last[1] - self._first[1]) * 1e9 / (self._last[0] - self._first[0])

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> float:
        "Seconds of the closed spans named `name`, summed."
        return sum((s.seconds for s in self.named(name) if s.end is not None), 0.0)

    @property
    def setup_seconds(self) -> float:
        "Host seconds of the graphs' warm-up and capture (phlash.capture, summed; 0 on the CPU)."
        return self.total("phlash.capture")

    def calls(self) -> list[Span]:
        "The phlash.call spans that closed without an exception."
        return [s for s in self.named("phlash.call") if s.end is not None and not s.raised]

    def per_call(self, name: str) -> float | None:
        """Seconds a call of the spans named `name`, over the calls that
        closed whole (None without one)."""
        whole = {s.call for s in self.calls()}
        if not whole:
            return None
        return sum(s.seconds for s in self.named(name) if s.call in whole) / len(whole)

    def count_per_call(self, counter: str) -> float | None:
        "The mean of a counter over the calls that closed whole (None without one)."
        calls = self.calls()
        if not calls:
            return None
        return sum(s.counts.get(counter, 0) for s in calls) / len(calls)

    def summary(self) -> str:
        return (f"{self.iterations} steps, {self.rate:.2f} it/s, "
                f"graph set-up {self.setup_seconds:.3f} s")


def records_fit(fit):
    """Decorator of mcmc.fit: each call records a FitTrace, the root span
    phlash.fit around the call, closed however the call ends."""

    @functools.wraps(fit)
    def recorded(*args, **kwargs):
        global _open, _last, _autograd_profiler
        import torch.autograd.profiler

        _autograd_profiler = torch.autograd.profiler
        tr, outer = FitTrace(), _open
        _open = _last = tr
        for c in _fit_record:
            c.reset()
        returned = False
        try:
            with Span("phlash.fit", {"fit": tr.id}):
                out = fit(*args, **kwargs)
            returned = True
            return out
        finally:
            tr.closed = True
            _open = outer
            for c in _fit_record:
                try:
                    tr.counts.update(c.counts())
                except RuntimeError:  # a device fault: the fit's own exception says more
                    if returned:
                        raise

    return recorded


def last_fit() -> FitTrace | None:
    "The FitTrace of this process's newest fit, the running one inside a fit (None before one)."
    return _last


def span(name: str, **attrs) -> Span:
    "A span recorded whenever a fit is open (the start's spans)."
    return Span(name, attrs)


def spanned(name: str):
    "Decorator: each call of the function is a span `name` (see span)."

    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with Span(name):
                return f(*args, **kwargs)

        return inner

    return wrap


def loop_call(k: int):
    """The span phlash.call of the loop's next call, of k iterations: it
    starts the next call index, and is recorded only while torch's profiler
    records (otherwise a shared no-op context)."""
    tr = _open
    if tr is None:
        return _NO_SPAN
    tr.call = 0 if tr.call is None else tr.call + 1
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span("phlash.call", {"call": tr.call, "k": k})


def call_span(name: str):
    """A span inside a call of the loop, recorded only while torch's
    profiler records (otherwise a shared no-op context)."""
    if _open is None or not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return Span(name)


def count(name: str, n: int = 1) -> None:
    "Add n to counter `name` of the innermost recorded open span (nothing outside a fit)."
    tr = _open
    if tr is not None and tr._stack:
        c = tr._stack[-1].counts
        c[name] = c.get(name, 0) + n


def add(name: str, start: int, end: int, **attrs) -> None:
    """Record a closed span from stamps taken elsewhere (a pool worker's),
    under the innermost open span (nothing outside a fit)."""
    tr = _open
    if tr is not None:
        s = Span(name, attrs)
        tr._push(s)
        s.start, s.end = start, end
        tr._stack.pop()


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the enclosed block with torch.profiler, CPU and (where there
    is a card) CUDA activities, and write a Chrome trace
    `<host>_<pid>.<time>.pt.trace.json` under `log_dir` (default
    phlash_tpu_torch_trace in the temporary directory, /tmp unless TMPDIR
    says otherwise) when the block exits.  Yields log_dir.  Around a fit,
    the trace holds every phlash.* span above beside the device's work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "phlash_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
