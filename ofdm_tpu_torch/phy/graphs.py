"""CUDA graphs of the batched decoder's fixed-shape stages (``phy/rx.py``).

On a card, a ``decode_frame`` call enqueues some thirty launches, most of
them small torch ops of the front half, and at a batch of 2,048 frames the
host's enqueue takes about as long as the card's work.  Calls that repeat
are therefore captured once and replayed.  A call's key is its input's
address, shape, strides, dtype and device, the current stream and every
selector.  The first call with a key runs eager, as it always did; the
second runs its stages once on a side stream, captures each stage into a
CUDA graph of its own and replays them; later calls replay.  A graph reads
the input where it lies, with no copy, so a replay decodes what that memory
holds now: what the caller passed.

Calls run eager, and capture nothing, while a ``torch.profiler`` session
records (the replays of graphs captured earlier still run, each stage
inside its span), while the current stream is itself being captured, and
where the input is not on the current device.  CPU tensors never reach
this module.

The graphs of one device, stream and input shape share one memory pool, so
the intermediates of distinct inputs of one shape are allocated once; a key
keeps only its last stage's outputs.  Sharing is safe because a call
replays its stages back to back on one stream, and only the stages read what
they leave in the pool.  At most ``MAX_GRAPHS`` keys keep graphs, the least
recently used going first; ``release()`` forgets them all.

The hand kernels' ``launches`` counters advance on every replay by what the
capture launched, so they count device launches whichever way a call ran.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import torch
from torch.autograd import profiler as _autograd_profiler

from ..kernels import counters
from ..obs import profiler

MAX_GRAPHS = 8      # keys that keep their graphs
MAX_SEEN = 64       # keys seen once, waiting for a second call


def key(x: torch.Tensor, stream_id: int, selectors: tuple) -> tuple:
    """The key of a call on ``x`` from the stream ``stream_id``."""
    return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device,
            stream_id, selectors)


def pool_key(k: tuple) -> tuple:
    """The graphs of one device, stream and input shape share a pool."""
    _, shape, _, dtype, device, stream_id, _ = k
    return device, stream_id, shape, dtype


class Cache:
    """Which call captures, replays or runs eager: the keys seen once and
    the keys with graphs, each least recently used first."""

    def __init__(self, max_graphs: int = MAX_GRAPHS,
                 max_seen: int = MAX_SEEN):
        self.max_graphs, self.max_seen = max_graphs, max_seen
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: collections.OrderedDict = collections.OrderedDict()

    def find(self, k):
        """The graphs kept for ``k`` (now its most recent use), or None."""
        got = self.graphs.get(k)
        if got is not None:
            self.graphs.move_to_end(k)
        return got

    def second_sight(self, k) -> bool:
        """Whether ``k`` was seen once before: then it is forgotten here and
        its call captures.  Else it is remembered and its call runs eager."""
        if k in self.seen:
            del self.seen[k]
            return True
        self.seen[k] = None
        if len(self.seen) > self.max_seen:
            self.seen.popitem(last=False)
        return False

    def keep(self, k, graphs) -> None:
        """Keep ``graphs`` for ``k``, evicting the least recently used keys
        beyond ``max_graphs`` (a graph in flight finishes first)."""
        self.graphs[k] = graphs
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)

    def pool_of(self, pk):
        """A pool handle of graphs already kept under the pool key ``pk``."""
        for g in self.graphs.values():
            if g.pool_key == pk:
                return g.graphs[0].pool()
        return None


@dataclasses.dataclass(eq=False)
class Graphs:
    """One key's captured stages."""
    graphs: list            # a torch.cuda.CUDAGraph per stage
    out: object             # the last stage's output, rewritten by each replay
    launches: list          # (kernel wrapper, launches the capture made)
    pool_key: tuple


_cache = Cache()
_lock = threading.Lock()
_side: dict = {}        # device -> the stream captures run on


def release() -> None:
    """Forget every captured graph and every key seen.  A graph still in
    flight on the card finishes first; its memory then returns."""
    with _lock:
        _cache.graphs.clear()
        _cache.seen.clear()


def entry_point(fn):
    """Give the entry point ``fn`` the counters ``run`` advances:
    ``graph_captures``, ``graph_replays`` and ``eager_calls``."""
    fn.graph_captures = fn.graph_replays = fn.eager_calls = 0
    return fn


def _chain(stages, x):
    for _, fn in stages:
        x = fn(x)
    return x


def _capture(stages, x, stream, pool, pk) -> Graphs:
    """Run the stages once on the side stream, then capture each into its
    own graph there; the kernels' counters are left as they were."""
    wrappers = list(counters().values())
    before = [fn.launches for fn in wrappers]
    side = _side.get(x.device)
    if side is None:
        side = _side[x.device] = torch.cuda.Stream(x.device)
    side.wait_stream(stream)
    graphs = []
    try:
        with torch.cuda.stream(side):
            _chain(stages, x)   # lazily made state (workspaces, plans) first
            at = [fn.launches for fn in wrappers]
            out = x
            for _, fn in stages:
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn(out)
                finally:
                    g.capture_end()
                pool = g.pool()
                graphs.append(g)
        launches = [(fn, fn.launches - a) for fn, a in zip(wrappers, at)
                    if fn.launches != a]
    finally:
        stream.wait_stream(side)
        for fn, b in zip(wrappers, before):
            fn.launches = b
    return Graphs(graphs, out, launches, pk)


def _replay(g: Graphs, stages, x):
    for (name, _), graph in zip(stages, g.graphs):
        with profiler.span(name, x):
            graph.replay()
    for fn, n in g.launches:
        fn.launches += n
    return g.out


def run(entry, x: torch.Tensor, selectors: tuple, stages):
    """The output of ``stages`` on the CUDA tensor ``x`` for a call of the
    entry point ``entry``: eager, or by capturing or replaying its graphs
    (see the module's docstring).  ``stages``: (span name, function)
    pairs, the first function taking ``x``, each next one the output of the
    one before; each function opens its own span.  After a replay the
    output is the graphs' own tensors, which the key's next replay
    overwrites: the caller reads them before it returns, on this stream.
    Counts the call in ``entry.graph_captures``, ``entry.graph_replays`` or
    ``entry.eager_calls``."""
    if (x.device.index != torch.cuda.current_device()
            or torch.cuda.is_current_stream_capturing()):
        entry.eager_calls += 1
        return _chain(stages, x)
    stream = torch.cuda.current_stream(x.device)
    k = key(x, stream.cuda_stream, selectors)
    with _lock:
        g = _cache.find(k)
        if g is not None:
            entry.graph_replays += 1
        elif (not _autograd_profiler._is_profiler_enabled
              and _cache.second_sight(k)):
            pk = pool_key(k)
            g = _capture(stages, x, stream, _cache.pool_of(pk), pk)
            _cache.keep(k, g)
            entry.graph_captures += 1
    if g is None:
        entry.eager_calls += 1
        return _chain(stages, x)
    return _replay(g, stages, x)
