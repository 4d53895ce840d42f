"""The classifier's evaluation replayed from one CUDA graph.

``PSVI._evaluate_fn`` walks the padded test set in batches of B: per batch
a noise draw, the forward over cat(u, x_b), the importance log-weights, the
predictive mixture and three on-device sums, then the IW diagnostics of
the last batch. On the card that is about 400 launches a batch, and the
host's enqueue sets the evaluation's time while the card idles.
``EvalGraph`` captures the whole loop once in a ``torch.cuda.CUDAGraph``
and replays it:

- capture: the state's leaves (params, u, z, v, α) are cloned into static
  buffers, and the loop runs once, eagerly, on a side stream (cuDNN,
  cuBLAS and the allocator meet every shape there); that run is the call's
  result. The loop is then captured on that stream, drawing from a
  generator the graph owns and has registered;
- replay: the new state's leaves are copied into the buffers in a few
  launches (``torch._foreach_copy_``), the caller's generator state is
  copied into the graph's generator, the graph is replayed, and the
  advanced state is copied back (both copies touch only the host). A
  replay draws the numbers the eager loop would draw from the caller's
  generator and leaves it where the eager loop would, whichever generator
  the engine holds (its own, or a trial's that ``_drawing_from`` swaps in).

An engine keeps one graph, keyed on what changes its launches
(``graph_key``): the shapes and dtypes of the state's leaves (M moves
under prune and increment), the class count, the net object, the padded
test set, S, the IW correction (``retrain_on_coreset`` evaluates without
it), N and M. A new key frees the old graph and its memory pool and
captures again.

The eager loop is the one body the capture records, and it runs as it is
wherever the graph cannot serve: off the card, under ``shard_mc`` (the
loop holds a collective), or where the capture itself failed (an
operation that a stream capture refuses, or no memory for the graph's
pool), which warns. Any other error is raised. ``EVAL_GRAPH`` counts
captures, replays and eager calls, ``last_eager_reason`` says why the last
eager call was one. The kernels' launch counters
(``utils.resource.LAUNCH_COUNTERS``) count what ran: the capture's
launches are taken back, and each replay adds them again, so a replay's
counts are the capture's and not counted where the kernels launch.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from psvi_torch.utils.resource import LAUNCH_COUNTERS, span
from psvi_torch.utils.tree import tree_leaves, tree_unflatten

EVAL_GRAPH = {"captures": 0, "replays": 0, "eager": 0}
#: Why the last evaluation ran its eager loop ("" until one did).
last_eager_reason = ""


def reset_eval_graph():
    global last_eager_reason
    for k in EVAL_GRAPH:
        EVAL_GRAPH[k] = 0
    last_eager_reason = ""


def ineligible(eng):
    """Why ``eng``'s evaluation cannot be a graph, or None where it can."""
    if eng.mc_shard is not None:
        return "shard_mc: the loop's sums over the mc axis are collectives"
    if eng.device.type != "cuda":
        return f"device {eng.device.type}: a CUDA graph needs a CUDA device"
    return None


def capture_failed(e: BaseException) -> bool:
    """Whether ``e``, raised while the loop was captured, is the capture's
    own failure: an operation that a stream capture refuses (CUDA's and
    torch's messages all name the capture), or no memory for the graph's
    pool. A kernel's fault or a fault of the loop is not."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        isinstance(e, RuntimeError) and "captur" in str(e).lower())


def _leaves(state):
    return tree_leaves(state.params) + [state.u, state.z, state.v, state.alpha]


def _with_leaves(state, leaves):
    n = len(leaves) - 4
    u, z, v, alpha = leaves[n:]
    return state._replace(params=tree_unflatten(state.params, leaves[:n]),
                          u=u, z=z, v=v, alpha=alpha)


def graph_key(eng, state, correction, test):
    """What a captured evaluation depends on besides the values of the
    state's leaves and the generator's state."""
    return (tuple((tuple(x.shape), x.dtype, x.device) for x in _leaves(state)), eng.nc,
            id(eng.net), id(test), eng.mc_samples_eval, bool(correction), eng.N,
            eng.num_pseudo)


def _counts():
    return {id(c): dict(c) for c in LAUNCH_COUNTERS}


def _added(counter, before):
    return {k: n - before.get(k, 0) for k, n in counter.items() if n != before.get(k, 0)}


@dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph, or None where the capture failed
    gen: torch.Generator  # the generator the graph draws from
    keep: tuple  # what the key names by id: the net and the padded test set
    static: list
    out: tuple = None
    launches: list = ()  # (counter, {kernel: launches a replay adds})
    reason: str = ""


class EvalGraph:
    """One engine's captured evaluation; ``__call__`` is the evaluation."""

    def __init__(self):
        self.key = self.g = None

    def __call__(self, eng, state, correction, test):
        reason = ineligible(eng)
        if reason is None:
            key = graph_key(eng, state, correction, test)
            if key != self.key:
                self.key = self.g = None  # the old graph and its pool go
                with span("psvi.evaluate.capture"):
                    g, out = self._capture(eng, state, correction, test)
                self.key, self.g = key, g
                if g.graph is None:
                    _eager(g.reason)
                return out
            if self.g.graph is not None:
                return self._replay(eng, state)
            reason = self.g.reason
        _eager(reason)
        return eng._evaluate_batches(state, correction, test)

    def _replay(self, eng, state):
        g = self.g
        with span("psvi.evaluate.replay"):
            torch._foreach_copy_(g.static, _leaves(state))
            g.gen.set_state(eng.gen.get_state())
            g.graph.replay()
            eng.gen.set_state(g.gen.get_state())
            for counter, n in g.launches:
                for k, c in n.items():
                    counter[k] = counter.get(k, 0) + c
            EVAL_GRAPH["replays"] += 1
            return tuple(x.clone() for x in g.out)

    @staticmethod
    def _capture(eng, state, correction, test):
        """The eager loop on a side stream, then its capture there; returns
        the graph (without one where the capture failed) and the eager
        loop's values. The caller's generator advances once, as in an
        eager call; the capture's launches are taken off the counters."""
        dev, stream = eng.device, torch.cuda.current_stream(eng.device)
        static = [x.detach().clone() for x in _leaves(state)]
        st = _with_leaves(state, static)
        gen = torch.Generator(device=dev)
        gen.set_state(eng.gen.get_state())
        g = _Graph(None, gen, (eng.net, test), static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side), eng._drawing_from(gen):
            out = eng._evaluate_batches(st, correction, test)
        stream.wait_stream(side)
        for x in out:
            x.record_stream(stream)
        eng.gen.set_state(gen.get_state())
        warm = _counts()
        try:
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(gen)
            # not torch.cuda.graph: its gc.collect and empty_cache cost set-up
            # 0.1-0.2 s, and the steps after it must allocate afresh
            with torch.cuda.stream(side), eng._drawing_from(gen):
                graph.capture_begin()
                try:
                    g.out = eng._evaluate_batches(st, correction, test)
                finally:
                    graph.capture_end()
            g.launches = [(c, _added(c, warm.get(id(c), {}))) for c in LAUNCH_COUNTERS]
            g.graph = graph
            EVAL_GRAPH["captures"] += 1
        except RuntimeError as e:
            if not capture_failed(e):
                raise
            g.static = g.out = None
            g.reason = f"capture failed: {type(e).__name__}: {e}"
            warnings.warn(f"the evaluation runs its eager loop: {g.reason}", RuntimeWarning,
                          stacklevel=3)
        finally:
            for c in LAUNCH_COUNTERS:  # a counter made since started at zero
                b = warm.get(id(c), dict.fromkeys(c, 0))
                c.clear()
                c.update(b)
        return g, out


def _eager(reason):
    global last_eager_reason
    EVAL_GRAPH["eager"] += 1
    last_eager_reason = reason
