"""Engine calls replayed from one CUDA graph: the fused LeNet step
(``StepGraph``) and the classifier's evaluation (``EvalGraph``).

On the card each body is hundreds of launches or more, and the host's
enqueue of them sets the call's time while the card idles. A
``GraphedCall`` captures the body once in a ``torch.cuda.CUDAGraph`` and
replays it:

- capture: the leaves the body reads are cloned into static buffers, and
  the body runs once, eagerly, on a side stream (cuDNN, cuBLAS, autograd
  and the allocator meet every shape there); that run is the call's
  result. The body is then captured on that stream;
- replay: the new leaves are copied into the buffers in a few launches
  (``torch._foreach_copy_``), the caller's ``before`` runs, the graph is
  replayed, and its outputs are copied into fresh tensors, so that no
  later replay touches what a call returned; the caller's ``after`` makes
  the call's result of them.

An engine keeps one graph a caller, keyed on what changes its launches
(the caller's ``graph_key``). A new key frees the old graph and its memory
pool and captures again.

The body runs as it is, eagerly, wherever the graph cannot serve: off the
card, where the engine's sharding puts a collective in the body (each
caller names its own), or where the capture itself failed
(``capture_failed``), which warns. Any other error is raised. Each
caller's counter (``STEP_GRAPH``, ``EVAL_GRAPH``) counts captures, replays
and eager calls, and ``last_eager_reason`` says why the last eager call was
one. The kernels' launch counters (``utils.resource.LAUNCH_COUNTERS``)
count what ran: the capture's launches are taken back, and each replay
adds them again, so a replay's counts are the capture's and not counted
where the kernels launch.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import torch

from psvi_torch.ops import optim as O
from psvi_torch.utils.resource import (add_launches, launch_counts, launches_since,
                                       restore_launch_counts, span)
from psvi_torch.utils.tree import tree_leaves, tree_unflatten


def _counter():
    return {"captures": 0, "replays": 0, "eager": 0, "last_eager_reason": ""}


STEP_GRAPH, EVAL_GRAPH = _counter(), _counter()


def reset_counts(counts):
    counts.update(_counter())


def capture_failed(e: BaseException) -> bool:
    """Whether ``e``, raised while a body was captured, is the capture's own
    failure: an operation that a stream capture refuses (CUDA's and torch's
    messages all name the capture), or no memory for the graph's pool. A
    kernel's fault or a fault of the body is not."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        isinstance(e, RuntimeError) and "captur" in str(e).lower())


@dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph, or None where the capture failed
    static: list  # the buffers the leaves are copied into
    own: object  # what the caller's hooks keep with the graph
    out: list = None
    launches: list = ()  # (counter, {kernel: launches a replay adds})
    reason: str = ""


class GraphedCall:
    """One engine's captured call; ``__call__(eng, *args)`` is the call. A
    caller names its spans, its warning, its collectives and its counter,
    and gives the hooks: ``graph_key``; ``leaves`` (the tensors copied into
    the buffers) and ``with_leaves`` (``args`` made of them); ``own`` (what
    the graph keeps beside its buffers, made at the capture); ``register``
    (the generators the body draws from, with the graph); ``body`` (the
    tensors the graph computes); ``before`` and ``after`` a replay, and
    ``after`` the capture's eager run; ``eager`` (the call off the graph)."""

    spans: tuple  # the capture's span, a replay's
    warning: str  # what a failed capture's warning says runs instead
    collectives: tuple  # the engine's shards that put a collective in the body
    sharded: str  # the reason where one is set
    counts: dict

    def __init__(self):
        self.key = self.g = None

    def ineligible(self, eng):
        """Why ``eng``'s call cannot be a graph, or None where it can."""
        if any(getattr(eng, s) is not None for s in self.collectives):
            return self.sharded
        if eng.device.type != "cuda":
            return f"device {eng.device.type}: a CUDA graph needs a CUDA device"
        return None

    def __call__(self, eng, *args):
        reason = self.ineligible(eng)
        if reason is None:
            key = self.graph_key(eng, *args)
            if key != self.key:
                self.key = self.g = None  # the old graph and its pool go
                with span(self.spans[0]):
                    g, out = self._capture(eng, args)
                self.key, self.g = key, g
                if g.graph is None:
                    self._eager(g.reason)
                return out
            if self.g.graph is not None:
                return self._replay(eng, args)
            reason = self.g.reason
        self._eager(reason)
        return self.eager(eng, *args)

    def static(self, eng, args):
        """Clones of the leaves (the graph's buffers), and ``args`` made of
        them."""
        static = [x.detach().clone() for x in self.leaves(eng, *args)]
        return static, self.with_leaves(eng, args, static)

    def register(self, graph, own):
        pass

    def _replay(self, eng, args):
        g = self.g
        with span(self.spans[1]):
            torch._foreach_copy_(g.static, self.leaves(eng, *args))
            self.before(eng, g.own, *args)
            g.graph.replay()
            add_launches(g.launches)
            self.counts["replays"] += 1
            outs = [torch.empty_like(x) for x in g.out]
            torch._foreach_copy_(outs, g.out)
            return self.after(eng, g.own, outs, *args)

    def _capture(self, eng, args):
        """The body on a side stream, then its capture there; returns the
        graph (without one where the capture failed) and the eager body's
        result. The capture's launches are taken off the counters."""
        dev, stream = eng.device, torch.cuda.current_stream(eng.device)
        static, ins = self.static(eng, args)
        g = _Graph(None, static, self.own(eng, *args))
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = self.body(eng, g.own, *ins)
        stream.wait_stream(side)
        for x in out:
            x.record_stream(stream)
        result = self.after(eng, g.own, out, *args)
        warm = launch_counts()
        try:
            graph = torch.cuda.CUDAGraph()
            self.register(graph, g.own)
            # not torch.cuda.graph: its gc.collect and empty_cache cost set-up
            # 0.1-0.2 s, and the calls after it must allocate afresh
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    g.out = self.body(eng, g.own, *ins)
                finally:
                    graph.capture_end()
            g.launches = launches_since(warm)
            g.graph = graph
            self.counts["captures"] += 1
        except RuntimeError as e:
            if not capture_failed(e):
                raise
            g.static = g.out = None
            g.reason = f"capture failed: {type(e).__name__}: {e}"
            warnings.warn(f"{self.warning}: {g.reason}", RuntimeWarning, stacklevel=3)
        finally:
            restore_launch_counts(warm)
        return g, result

    def _eager(self, reason):
        self.counts["eager"] += 1
        self.counts["last_eager_reason"] = reason


# ----------------------------------------------------------------------
# the fused LeNet step


def _state_leaves(state, names):
    """What the body reads of the state: the net, u, z, v, α, and the
    moments of each learned hyperparameter's Adam."""
    moments = [x for n in names for x in getattr(state, "opt_" + n)[1:]]
    return tree_leaves(state.params) + [state.u, state.z, state.v, state.alpha] + moments


def _with_state_leaves(state, names, leaves):
    n = len(leaves) - 4 - 2 * len(names)
    u, z, v, alpha = leaves[n:n + 4]
    fields = {"opt_" + k: O.AdamState(getattr(state, "opt_" + k).count, *leaves[m:m + 2])
              for k, m in zip(names, range(n + 4, len(leaves), 2))}
    return state._replace(params=tree_unflatten(state.params, leaves[:n]), u=u, z=z, v=v,
                          alpha=alpha, **fields)


def write_corrections(bc, state, names, opts):
    """The bias corrections of each hyper-Adam's next count into ``bc``
    (one row a name), from pinned memory on a card: no synchronise."""
    if not names:
        return
    vals = []
    for n, opt in zip(names, opts):
        hp = dict(opt.hyper)
        vals.append(O.bias_corrections(getattr(state, "opt_" + n).count + 1, hp["b1"], hp["b2"]))
    bc.copy_(torch.tensor(vals, dtype=bc.dtype, pin_memory=bc.is_cuda), non_blocking=True)


@contextlib.contextmanager
def _reading_corrections(eng, names, bc):
    """The engine's hyper-Adams swapped for twins that read their bias
    corrections from ``bc``."""
    saved = {n: getattr(eng, "opt_" + n) for n in names}
    try:
        for i, n in enumerate(names):
            setattr(eng, "opt_" + n, O.adam(**dict(saved[n].hyper), corrections=bc[i]))
        yield
    finally:
        for n, opt in saved.items():
            setattr(eng, "opt_" + n, opt)


class _Corrections(NamedTuple):
    names: list  # the learned hyperparameters
    opts: list  # the engine's hyper-Adams, one a name
    bc: torch.Tensor  # (names, 2): each hyper-Adam's bias corrections
    net: object  # what the key names by id


class StepGraph(GraphedCall):
    """``PSVI._nested_step_fused_lenet`` from its drawn inputs: the call is
    ``(eng, state, cfg, (xb, yb, e_in, eps_outer))``.

    The step draws its minibatch and noise (or takes them from its seam),
    then runs ``_fused_lenet_body``: the B2 pair's unroll, the outer IW-ELBO
    and its gradient through ``torch.autograd``, and the hyper-Adam, about
    1,300 launches. The buffers hold the state's leaves the body reads (the
    net, u, z, v, α and the hyper-Adam's moments) and the drawn inputs (the
    minibatch, the flat inner noise, the outer noise tree). The body draws
    nothing, so the engine's generator is left where the eager step leaves
    it, and the seam's steps (``PSVI._step(state, batch=..., eps=...)``)
    replay the same graph as drawn ones.

    The hyper-Adam takes its bias corrections from the host's integer count
    (``ops/optim.py::bias_corrections``, rounded to float32), which a
    capture would freeze. Inside the graph the engine's hyper-Adams are
    swapped for twins (``optim.adam(..., corrections=...)``) that read them
    from a device buffer of the step's dtype, written before each replay,
    and divide by them as the eager step divides by the host scalars: a
    replay equals the eager step bit for bit.

    The key holds the shapes and dtypes of the leaves and inputs (M moves
    under prune and increment, B, S and T with the inputs), the kernels'
    configuration (T, S, M, the class count, N, f(v)'s form, α), the
    hyperparameter names, the hyper-Adams' arguments, the net and the inner
    learning rate, which the pair takes by value (a StepLR tick with γ ≠ 1
    captures again). ``shard_mc`` and ``shard_batch`` put collectives in the
    step; the fused gate refuses both, and the trial runner's vmap, before
    the step is chosen."""

    spans = ("psvi.step.capture", "psvi.step.replay")
    warning = "the LeNet step runs eagerly"
    collectives = ("mc_shard", "data_shard")
    sharded = "shard_mc/shard_batch: the step's sums over the mesh are collectives"
    counts = STEP_GRAPH

    def graph_key(self, eng, state, cfg, inputs):
        names = eng._hyper_names()
        leaves = self.leaves(eng, state, cfg, inputs)
        return (tuple((tuple(x.shape), x.dtype, x.device) for x in leaves), cfg, tuple(names),
                tuple(getattr(eng, "opt_" + n).hyper for n in names), id(eng.net),
                eng.lr_net_sched(state.net_step))

    def leaves(self, eng, state, cfg, inputs):
        xb, yb, e_in, eps_outer = inputs
        return _state_leaves(state, eng._hyper_names()) + [xb, yb, e_in] + tree_leaves(eps_outer)

    def with_leaves(self, eng, args, leaves):
        state, cfg, inputs = args
        names = eng._hyper_names()
        n = len(_state_leaves(state, names))
        return (_with_state_leaves(state, names, leaves[:n]), cfg,
                (*leaves[n:n + 3], tree_unflatten(inputs[3], leaves[n + 3:])))

    def own(self, eng, state, cfg, inputs):
        names = eng._hyper_names()
        own = _Corrections(names, [getattr(eng, "opt_" + n) for n in names],
                           torch.empty((len(names), 2), dtype=state.u.dtype, device=eng.device),
                           eng.net)
        self.before(eng, own, state, cfg, inputs)
        return own

    def before(self, eng, own, state, cfg, inputs):
        write_corrections(own.bc, state, own.names, own.opts)

    def body(self, eng, own, state, cfg, inputs):
        """The body with the hyper-Adams reading ``own.bc``; the tensors a
        step returns: the unrolled flat net, the losses, the stepped
        hyperparameters and their Adam moments."""
        names = own.names
        with _reading_corrections(eng, names, own.bc):
            state, pT, aux = eng._fused_lenet_body(state, cfg, *inputs)
        return ([pT, aux["outer_loss"], aux["inner_losses"]] + [getattr(state, n) for n in names]
                + [x for n in names for x in getattr(state, "opt_" + n)[1:]])

    def after(self, eng, own, outs, state, cfg, inputs):
        """The step's (state, aux) from ``state`` and the body's outputs."""
        pT, loss, inner = outs[:3]
        k = len(own.names)
        fields = {}
        for i, n in enumerate(own.names):
            fields[n] = outs[3 + i]
            m = 3 + k + 2 * i
            fields["opt_" + n] = O.AdamState(getattr(state, "opt_" + n).count + 1,
                                             *outs[m:m + 2])
        state = eng._with_unrolled_net(state._replace(**fields), pT, cfg)
        return state, {"outer_loss": loss, "inner_losses": inner}

    def eager(self, eng, state, cfg, inputs):
        st, pT, aux = eng._fused_lenet_body(state, cfg, *inputs)
        return eng._with_unrolled_net(st, pT, cfg), aux


# ----------------------------------------------------------------------
# the evaluation


class _Draws(NamedTuple):
    gen: torch.Generator  # the generator the graph draws from
    keep: tuple  # what the key names by id: the net and the padded test set


class EvalGraph(GraphedCall):
    """``PSVI._evaluate_fn``'s loop (``_evaluate_batches``): the call is
    ``(eng, state, correction, test)``.

    The loop walks the padded test set in batches of B: per batch a noise
    draw, the forward over cat(u, x_b), the importance log-weights, the
    predictive mixture and three on-device sums, then the IW diagnostics of
    the last batch, about 400 launches a batch. The buffers hold the state's
    leaves (params, u, z, v, α). The loop draws from a generator the graph
    owns and has registered: the caller's generator state is copied into it
    before a replay and back after it (both copies touch only the host). A
    replay draws the numbers the eager loop would draw from the caller's
    generator and leaves it where the eager loop would, whichever generator
    the engine holds (its own, or a trial's that ``_drawing_from`` swaps
    in).

    The key holds the shapes and dtypes of the state's leaves (M moves
    under prune and increment), the class count, the net object, the padded
    test set, S, the IW correction (``retrain_on_coreset`` evaluates without
    it), N and M. ``shard_mc`` puts collectives in the loop."""

    spans = ("psvi.evaluate.capture", "psvi.evaluate.replay")
    warning = "the evaluation runs its eager loop"
    collectives = ("mc_shard",)
    sharded = "shard_mc: the loop's sums over the mc axis are collectives"
    counts = EVAL_GRAPH

    def graph_key(self, eng, state, correction, test):
        leaves = self.leaves(eng, state, correction, test)
        return (tuple((tuple(x.shape), x.dtype, x.device) for x in leaves), eng.nc,
                id(eng.net), id(test), eng.mc_samples_eval, bool(correction), eng.N,
                eng.num_pseudo)

    def leaves(self, eng, state, correction, test):
        return tree_leaves(state.params) + [state.u, state.z, state.v, state.alpha]

    def with_leaves(self, eng, args, leaves):
        state, correction, test = args
        n = len(leaves) - 4
        u, z, v, alpha = leaves[n:]
        return (state._replace(params=tree_unflatten(state.params, leaves[:n]),
                               u=u, z=z, v=v, alpha=alpha), correction, test)

    def own(self, eng, state, correction, test):
        own = _Draws(torch.Generator(device=eng.device), (eng.net, test))
        self.before(eng, own, state, correction, test)
        return own

    def register(self, graph, own):
        graph.register_generator_state(own.gen)

    def before(self, eng, own, *args):
        own.gen.set_state(eng.gen.get_state())

    def body(self, eng, own, state, correction, test):
        with eng._drawing_from(own.gen):
            return eng._evaluate_batches(state, correction, test)

    def after(self, eng, own, outs, *args):
        eng.gen.set_state(own.gen.get_state())
        return tuple(outs)

    def eager(self, eng, state, correction, test):
        return eng._evaluate_batches(state, correction, test)
