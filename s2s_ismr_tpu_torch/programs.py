"""The engine's programs and their process-level memo (port of
s2s_ismr_tpu/programs.py).

JAX runs a lane as one jitted program whose inputs are the data, and keeps
the compiled programs live in `_ProgramMemo`, keyed by everything that
fixes the program: statics, input avals, the mesh's topology. Every lane,
fold, MME model and suite config of the same shape reuses one executable.

Here a program is a `Program`: static buffers and a `body` over them. On a
CUDA device the body is captured once into a CUDA graph and replayed; on
the CPU (the tests' path) the body is called directly. Data, learning
rates, masks, batch orders and initial weights are inputs: the caller
copies them into the program's buffers before a run and copies the result
out after, so trials that differ only in lr share one program, as in JAX.
The memo keys a program by the model's structure (`module_key`), the
shapes of its buffers (`_avals_key`), its statics, the device
(`device_key`) and the cuDNN / TF32 flags in force at capture
(`flags_key`: a replay keeps the algorithms chosen then).

A program is one or more segments (`Program.segments`), each captured
into a graph of its own, and a run launches them in the order its
`schedule` gives; most programs are one segment, the whole body, launched
once a run. A training epoch longer than the engine's chunk is a prologue,
a chunk of steps launched again and again, a single step and an epilogue
(`engine._ChunkedFoldProgram`), so that what is captured stays bounded
whatever the epoch's length. On the CPU each segment is called in the same
order.

Capture (`Program.build`): the body runs once on a side stream, cut to
one minibatch step of weight 0 (the warm-up: it loads the kernel library,
sets the conv kernel's shared-memory attributes and allocates the cuBLAS /
cuDNN workspaces outside the graph; every step has the same kernels and
shapes), then each segment in full under `torch.cuda.CUDAGraph` capture
on that stream, in `thread_local` mode (a mesh's other host threads keep
allocating while one thread captures), one capture at a time in the
process. Every graph of a device shares one memory pool: a program keeps
all it must keep, also what one segment hands the next, in buffers
allocated outside the capture, so nothing in the pool outlives a launch,
and programs never run at once on one device. The conv kernel's launches
during the warm-up count in `conv.WARMUP_LAUNCHES`, those during capture
nowhere; each launch of a graph adds the launches it captured to
`conv.LAUNCHES`. The BatchNorm kernels' count likewise in
`batchnorm.WARMUP_LAUNCHES` and `batchnorm.LAUNCHES`. A program's device
generators (dropout) are registered with each of its graphs: a lane's
generator state is copied into them before its runs and back after, so
run j draws what eager epoch j draws.

Counts: a training program's build adds the minibatch steps its segments
hold (a batched step of L lanes once) to `STATS['captured_steps']` and to
the open call record's counter `captured_steps` (`profiling.count`); on
the CPU, where nothing is captured, the steps its segments run uncaptured.
A run, all the launches of its schedule, is the span
`programs.{kind}_replay`; inside a training program's run each segment's
launch (the segment's call on the CPU) is the span `programs.graph_launch`.
A launch queued behind a graph that still runs waits for it, so in a
chunked epoch that span holds the device time of the graph before it.

There is no fallback: a capture or replay that fails raises. A program
built with capture=False runs its body uncaptured on the card too; only
the engine's private `_uncaptured` test seam builds one.

Not ported: `foreground_compile_priority`, `_fg_*`, `_compile_with_retry`
and `memoized_call`'s background prefetch. They gate and retry XLA compiles
on a remote compile server, which this port does not have: a capture takes
about a second on the card and runs where it is needed. `compile_cache.py`
stays unported too: the nvcc library is cached by `kernels/_build.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict

import torch
from torch import nn

from . import profiling
from .kernels import batchnorm, conv


class _ProgramMemo:
    """Process-level memo of built programs, JAX's `_ProgramMemo`: a bounded
    FIFO, thread-safe, deduplicating a build that two threads ask for at
    once. Keys hold everything that fixes the program; the data are the
    program's inputs."""

    def __init__(self, max_entries: int = 256):
        # a program holds its inputs' buffers (a copy of the images for
        # each bucket shape) beside its graph; the suite's eight configs
        # build ~100 at one fold
        self._d: Dict[tuple, Any] = {}
        self._inflight: Dict[tuple, Future] = {}
        self._lock = threading.Lock()
        self.max_entries = max_entries

    def get(self, key):
        if key is None:
            return None
        with self._lock:
            return self._d.get(key)

    def put(self, key, value):
        if key is None:
            return
        with self._lock:
            if key not in self._d and len(self._d) >= self.max_entries:
                self._d.pop(next(iter(self._d)))
            self._d[key] = value

    def begin(self, key):
        """Claim `key` for a build. Returns (program, None) on a hit,
        (None, future) while another thread builds it (wait on the future),
        or (None, None) when this caller owns the build and must call
        finish(key, ...)."""
        if key is None:
            return None, None
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                return v, None
            f = self._inflight.get(key)
            if f is not None:
                return None, f
            self._inflight[key] = Future()
            return None, None

    def finish(self, key, value=None, error=None):
        """Resolve a begin() claim: publish the program (or hand the build
        error to any waiters) and release the in-flight slot."""
        if key is None:
            return
        if error is None:
            self.put(key, value)
        with self._lock:
            f = self._inflight.pop(key, None)
        if f is not None:
            if error is None:
                f.set_result(value)
            else:
                f.set_exception(error)

    def clear(self):
        with self._lock:
            self._d.clear()
            self._inflight.clear()

    def __len__(self):
        with self._lock:
            return len(self._d)


_program_memo = _ProgramMemo()

# What the programs did in this process (or since reset_stats): memo hits
# and misses, captures (programs captured, whatever their segments), the
# seconds of the captures and of the whole builds (warm-up, checks and
# capture), replays of training epochs and of eval forwards, runs
# uncaptured on a CUDA device (only the engine's test seam makes those),
# and the minibatch steps the training programs built hold.
STATS = {"hits": 0, "misses": 0, "captures": 0, "capture_s": 0.0,
         "build_s": 0.0, "train_replays": 0, "predict_replays": 0,
         "uncaptured_cuda_runs": 0, "captured_steps": 0}
_STATS_LOCK = threading.Lock()


def _add(name, value=1):
    with _STATS_LOCK:
        STATS[name] += value


def reset_stats():
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0.0 if isinstance(STATS[k], float) else 0


def _avals_key(tensors) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def device_key(device) -> tuple:
    """(type, index) of `device`, the current card's index for a bare
    'cuda'. It stands for JAX's `_topology_key`: a program runs on one
    device, and each device of a mesh trains through programs of its own
    (its host thread builds them)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def flags_key() -> tuple:
    """The backend flags that fix what a capture records: cuDNN's
    algorithm choice and TF32 in convs and matmuls."""
    b = torch.backends
    return (b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
            b.cuda.matmul.allow_tf32)


_STATICS = (bool, int, float, str, type(None), torch.dtype)


def _static(v):
    if isinstance(v, _STATICS):
        return True
    if isinstance(v, tuple):
        return all(_static(u) for u in v)
    return (dataclasses.is_dataclass(v) and not isinstance(v, type)
            and v.__dataclass_params__.frozen)


def module_key(model: nn.Module) -> tuple:
    """The structure that fixes what `model` computes: each submodule's
    class and plain attributes (the U-Net's config, dropout rates, conv
    acts, compute dtypes, strides) and the shapes and types of its
    parameters and buffers."""
    mods = tuple(
        (name, type(m).__qualname__,
         tuple(sorted((k, v) for k, v in vars(m).items()
                      if not k.startswith("_") and k != "training"
                      and _static(v))))
        for name, m in model.named_modules())
    tensors = tuple((n, tuple(t.shape), str(t.dtype)) for n, t in
                    [*model.named_parameters(), *model.named_buffers()])
    return mods, tensors


def memoized(key, build):
    """The program of `key` from the memo, built by build() on a miss
    (another thread asking for the same key waits for this build)."""
    prog, fut = _program_memo.begin(key)
    if prog is not None:
        _add("hits")
        return prog
    if fut is not None:
        _add("hits")
        return fut.result()
    _add("misses")
    try:
        prog = build()
    except BaseException as e:
        _program_memo.finish(key, error=e)
        raise
    _program_memo.finish(key, prog)
    return prog


_CAPTURE = threading.Lock()     # one capture at a time in the process
_SIDE: Dict[tuple, Any] = {}    # device key -> (capture stream, pool)
_local = threading.local()


def _side(device):
    """The device's capture stream and graph memory pool, shared by all
    its programs."""
    k = device_key(device)
    if k not in _SIDE:
        with torch.cuda.device(device):
            _SIDE[k] = (torch.cuda.Stream(device),
                        torch.cuda.graph_pool_handle())
    return _SIDE[k]


def last():
    """The program this thread ran last (for diagnostics: its buffers
    hold the end state of the last run until another run loads them)."""
    return getattr(_local, "last", None)


class Program:
    """Static buffers and a body over them. Subclasses allocate their
    buffers, set `generators` (device generators the body draws from) and
    `steps` (the minibatch steps a run holds) and call build(); callers
    hold `lock` while they load inputs, run and read out, since the
    buffers are the program's one set of state. `kind` names what a run
    is ('train': an epoch, 'predict': an eval forward)."""

    kind = "train"
    steps = 0

    def __init__(self, device, capture=True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.lock = threading.Lock()
        self.graphs = []             # per segment: (graph, conv launches,
        # lane-mode launches, BatchNorm kernel launches)
        self.generators = []

    def body(self, steps=None):
        """One run over the buffers; `steps` cuts a training epoch to its
        first `steps` minibatch steps (the warm-up's one)."""
        raise NotImplementedError

    def segments(self):
        """The parts of a run, each captured into a graph of its own:
        [(fn, minibatch steps it holds)]. By default the whole body."""
        return [(self.body, self.steps)]

    def schedule(self):
        """The segments a run launches, by index, in order."""
        return (0,)

    def build(self):
        """On a CUDA device (unless built uncaptured): warm up, then capture
        the segments. The program's state after the warm-up must equal its
        state before it (the body's gates make the warm-up a no-op on
        zero-weight inputs); `warm_state` lists what to check. In the span
        `programs.build`."""
        with profiling.span("programs.build"):
            if self.capture:
                self._capture()
            if self.kind == "train":
                steps = sum(n for _, n in self.segments())
                _add("captured_steps", steps)
                profiling.count("captured_steps", steps)
        return self

    def _capture(self):
        dev = self.device
        stream, pool = _side(dev)
        with _CAPTURE, torch.cuda.device(dev):
            before = [t.clone() for t in self.warm_state()]
            stream.wait_stream(torch.cuda.current_stream(dev))
            t0 = time.perf_counter()
            with torch.cuda.stream(stream), conv.tally(stream) as warm, \
                    batchnorm.tally(stream) as bn_warm:
                self.body(steps=1)
            conv.add_warmup(len(warm))
            batchnorm.add_warmup(len(bn_warm))
            stream.synchronize()
            after = self.warm_state()
            if not all(torch.equal(a, b) for a, b in zip(before, after)):
                raise RuntimeError("program warm-up changed the program's "
                                   "state: a gate let a zero-weight batch "
                                   "through")
            t1 = time.perf_counter()
            graphs = [self._capture_one(fn, stream, pool)
                      for fn, _ in self.segments()]
            torch.cuda.current_stream(dev).wait_stream(stream)
            t2 = time.perf_counter()
        self.graphs = graphs
        _add("captures")
        _add("capture_s", t2 - t1)
        _add("build_s", t2 - t0)

    def _capture_one(self, fn, stream, pool):
        """fn captured into a graph of the shared pool on `stream`: (graph,
        its conv launches, lane-mode launches, BatchNorm launches)."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            if g is not None:
                graph.register_generator_state(g)
        with torch.cuda.stream(stream), conv.tally(stream) as cap, \
                batchnorm.tally(stream) as bn_cap:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                raise
            graph.capture_end()
        return graph, len(cap), sum(n > 1 for n in cap), len(bn_cap)

    def warm_state(self):
        """Tensors the warm-up must leave as they were."""
        return []

    def _launch(self):
        """A segment's launch: the span programs.graph_launch in a
        training program."""
        return (profiling.span("programs.graph_launch")
                if self.kind == "train" else contextlib.nullcontext())

    def run(self):
        """One run: the segments of its schedule, each a launch of its
        graph, or the segment itself (on the CPU, or uncaptured on the
        card), in the span `programs.{kind}_replay`."""
        _local.last = self
        with profiling.span(f"programs.{self.kind}_replay"):
            if not self.graphs:
                if self.device.type == "cuda":
                    _add("uncaptured_cuda_runs")
                parts = self.segments()
                for i in self.schedule():
                    with self._launch():
                        parts[i][0]()
                return
            with torch.cuda.device(self.device):
                for i in self.schedule():
                    graph, n, lanes, bn = self.graphs[i]
                    with self._launch():
                        graph.replay()
                    conv.replayed(n, lanes)
                    batchnorm.replayed(bn)
            _add(f"{self.kind}_replays")

    def bind(self, generators):
        """Before a lane's runs: a captured program copies each lane
        generator's state into its own registered generator; an uncaptured
        one draws from the lane's generators themselves."""
        if not self.graphs:
            self.generators = list(generators)
            return
        for own, g in zip(self.generators, generators):
            if own is not None and g is not None:
                own.set_state(g.get_state())

    def unbind(self, generators):
        """After a lane's runs: the lane generators take the states their
        draws left in the program's generators."""
        if not self.graphs:
            return
        for own, g in zip(self.generators, generators):
            if own is not None and g is not None:
                g.set_state(own.get_state())
