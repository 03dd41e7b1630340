"""Captured programs: the port's counterpart of the JAX package's jitted
programs (``models/pipeline.py`` there compiles each ``jax.jit`` body
once per static key and replays it).

A program is a body, a function of tensors and static values, under a
key: the shapes, dtypes and device of its tensors and the static values
themselves (the frozen ``StitchConfig``, a window's width and flag, a
chain's widths), as ``static_argnames`` keys a ``jax.jit`` program.
What varies between calls of one key (the inputs, a window's roll) is a
tensor.

On a CUDA device

1. a key's first call runs the body eagerly and returns what it
   returns: this warm run builds the kernels, fills the card-side
   constants (``device_constant``: resize taps, pad indices, search
   offsets) and sets each kernel's shared-memory attribute.  A key used
   once costs what an eager run costs;
2. its second call captures the body with ``torch.cuda.graph`` into
   static input tensors and the static outputs the capture returns, and
   replays the graph;
3. every later call copies its inputs into the static inputs, replays
   the graph and returns a copy of the static outputs: the next replay
   overwrites them.

A failed capture or replay raises ``ProgramError`` with the body's name;
nothing falls back to an eager run.

On the CPU a body runs as it is, as a kernel wrapper runs its plain
version there: the CPU has no graphs.  ``disable()`` runs bodies eagerly
on any device, the counterpart of ``jax.disable_jit()``.

A captured graph reads the card-side constants through raw pointers, so
a program holds every constant its warm run read (by the arguments it
was made from) and its capture reads those same tensors: a constant
cache may evict or be cleared without touching a held graph.

A captured graph keeps its private memory pool, the body's peak
allocation, for as long as it is cached.  At most ``MAX_PROGRAMS``
programs are held; a new capture releases the least recently used one
first (its key starts over with an eager call), and ``clear()`` releases
them all (``torch.cuda.empty_cache()`` then returns the memory to the
device).

Python does not run on a replay, so the kernel wrappers' launch counters
(``ops.kernels``) would not see it.  A program records what each counter
counted while it was captured, takes that back (nothing ran), and adds it
on every replay: the counters count the launches that ran on the card,
each call's once.  For the same reason a program keeps the boundaries of
its body's stage spans (``utils.trace``), captured as event nodes, with
what the tracer's counters counted while it was captured, and hands them
to the tracer after each replay, which counts them again.  A key's eager
call, a capture (with the graph's instantiation) and a replay (copy-in,
replay, copy-out) are the spans ``program.eager``, ``program.capture``
and ``program.replay``.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

from panorama_opticalflow_tpu_torch.utils import trace

# programs held at once, each with its body's peak allocation: a 6-photo
# chain's five pair programs (a width and gather flag each, at worst) and
# the chain's own
MAX_PROGRAMS = 6
# keys called once and not captured, remembered for their second call
SEEN_KEYS = 64
# card-side constants a cache keeps (a program holds its own besides)
CONSTANTS = 512

_cache: collections.OrderedDict = collections.OrderedDict()
# key -> the card-side constants its eager first call read
_seen: collections.OrderedDict = collections.OrderedDict()
_disabled = 0
# the constants of the body being run on a card (None: no body runs)
_constants: dict | None = None


class ProgramError(RuntimeError):
    """A program's capture or replay failed on the card."""


@contextlib.contextmanager
def disable():
    """Run every body eagerly while the context is open (the counterpart
    of ``jax.disable_jit()``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def clear() -> None:
    """Release every cached program (its graph, memory pool, static
    tensors and constants) and forget the keys called once."""
    _cache.clear()
    _seen.clear()


def keys() -> list[tuple]:
    """The keys of the captured programs, least recently used first."""
    return list(_cache)


def info() -> list[dict]:
    """Each captured program's name, its replays, the card-side constants
    it holds and the kernel launches one replay adds; least recently used
    first."""
    return [p.info() for p in _cache.values()]


def key(body, tensors, static: tuple) -> tuple:
    """A program's key: the body, the shape, dtype and device of each
    tensor, and the static values."""
    return (body.__module__, body.__qualname__,
            tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
            tuple(static))


def device_constant(maker):
    """A cached maker of card-side constants (``lru_cache`` of
    ``CONSTANTS`` entries) whose values a program keeps: while a body runs
    on a card, every value it reads is recorded by its arguments, and a
    capture reads the recorded value, not the cache.  A maker copies from
    the host, so it runs in a key's eager first call, never in a
    capture."""
    cached = functools.lru_cache(maxsize=CONSTANTS)(maker)

    @functools.wraps(maker)
    def get(*args):
        if _constants is None:
            return cached(*args)
        k = (maker.__module__, maker.__qualname__, args)
        if k not in _constants:
            _constants[k] = cached(*args)
        return _constants[k]

    get.cache_clear = cached.cache_clear
    get.cache_info = cached.cache_info
    return get


@contextlib.contextmanager
def _reading(constants: dict):
    global _constants
    outer, _constants = _constants, constants
    try:
        yield constants
    finally:
        _constants = outer


def run(body, tensors, *static):
    """``body(*tensors, *static)`` as a program: on a CUDA device called
    eagerly on its key's first call, captured and replayed on the second,
    replayed after; on the CPU, or under ``disable()``, called as it is.
    The body returns a tensor or a tuple of tensors."""
    tensors = tuple(tensors)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{body.__qualname__}: tensors on {devices}, "
                         f"expected one device")
    if not _captures(devices.pop()):
        return body(*tensors, *static)
    k = key(body, tensors, static)
    prog = _cache.pop(k, None)
    if prog is None:
        constants = _seen.pop(k, None)
        if constants is None:
            with trace.span("program.eager"), _reading({}) as constants:
                out = body(*tensors, *static)
            _seen[k] = constants
            while len(_seen) > SEEN_KEYS:
                _seen.popitem(last=False)
            return out
        while len(_cache) >= MAX_PROGRAMS:
            _cache.popitem(last=False)
        with trace.span("program.capture"):
            prog = _Program(body, tensors, static, constants)
    with trace.span("program.replay"):
        out = prog(tensors)
    _cache[k] = prog
    return out


def _captures(device: torch.device) -> bool:
    """Whether a body runs as a program on ``device``: on a CUDA device,
    unless ``disable()`` is in force."""
    return not _disabled and device.type == "cuda"


def _launch_counts() -> dict:
    from panorama_opticalflow_tpu_torch.ops import kernels

    return {k: k.launches for k in kernels.KERNELS}


def _clone(out):
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


class _Program:
    """One captured body: capture and instantiation on construction (the
    key's eager warm run came before, and read ``constants``), replays on
    call."""

    def __init__(self, body, tensors: tuple, static: tuple,
                 constants: dict):
        self.name = body.__qualname__
        self.constants = constants
        self.inputs = tuple(
            torch.empty_like(t, memory_format=torch.contiguous_format)
            .copy_(t) for t in tensors)
        self.replays = 0
        torch.cuda.synchronize(tensors[0].device)
        self.graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with _reading(constants), \
                    trace.capturing() as self.boundaries, \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                self.outputs = body(*self.inputs, *static)
        except Exception as e:
            raise ProgramError(f"program {self.name}: capture failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            after = _launch_counts()
            for k, n in before.items():
                k.launches = n
        self.launches = {k: after[k] - n for k, n in before.items()}

    def __call__(self, tensors: tuple):
        trace.settle(self.boundaries)
        for static, t in zip(self.inputs, tensors):
            static.copy_(t)
        try:
            self.graph.replay()
        except Exception as e:
            raise ProgramError(f"program {self.name}: replay failed: "
                               f"{type(e).__name__}: {e}") from e
        for k, n in self.launches.items():
            k.launches += n
        self.replays += 1
        trace.replayed(self.name, self.boundaries)
        return _clone(self.outputs)

    def info(self) -> dict:
        return {"name": self.name, "replays": self.replays,
                "constants": len(self.constants),
                "launches_a_replay": {k.__name__: n
                                      for k, n in self.launches.items()}}
