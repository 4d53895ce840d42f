"""The fused LeNet nested step replayed from one CUDA graph.

``PSVI._nested_step_fused_lenet`` draws its minibatch and noise (or takes
them from its seam), then runs ``_fused_lenet_body``: the B2 pair's
unroll, the outer IW-ELBO and its gradient through ``torch.autograd``, and
the hyper-Adam. On the card that body is about 1,300 launches, and the
host's enqueue of them sets the step's time while the card idles.
``StepGraph`` captures the body once in a ``torch.cuda.CUDAGraph`` and
replays it:

- capture: the state's leaves the body reads (the net, u, z, v, α and the
  hyper-Adam's moments) and the drawn inputs (the minibatch, the flat inner
  noise, the outer noise tree) are cloned into static buffers, and the body
  runs once, eagerly, on a side stream (cuDNN, cuBLAS, autograd and the
  allocator meet every shape there); that run is the call's result. The
  body is then captured on that stream;
- replay: the new state's leaves and the step's inputs are copied into
  the buffers in a few launches (``torch._foreach_copy_``), the hyper-Adam's
  bias corrections of the step's count are written to the device from
  pinned memory, the graph is replayed, and its outputs are copied into
  fresh tensors, so that no later replay touches a state or ``aux`` a step
  returned.

The body draws nothing, so the engine's generator is left where the eager
step leaves it, and the seam's steps (``PSVI._step(state, batch=...,
eps=...)``) replay the same graph as drawn ones.

The hyper-Adam takes its bias corrections from the host's integer count
(``ops/optim.py::bias_corrections``, rounded to float32), which a capture
would freeze. Inside the graph the engine's hyper-Adams are swapped for
twins (``optim.adam(..., corrections=...)``) that read them from a device
buffer of the step's dtype, written before each replay, and divide by them
as the eager step divides by the host scalars: a replay equals the eager
step bit for bit.

An engine keeps one graph, keyed on what changes its launches
(``graph_key``): the shapes and dtypes of the leaves and inputs (M moves
under prune and increment, B, S and T with the inputs), the kernels'
configuration (T, S, M, the class count, N, f(v)'s form, α), the
hyperparameter names, the hyper-Adams' arguments, the net and the inner
learning rate, which the pair takes by value (a StepLR tick with γ ≠ 1
captures again). A new key frees the old graph and its memory pool.

The body runs as it is, eagerly, wherever the graph cannot serve: off
the card, under ``shard_mc`` or ``shard_batch`` (its sums over the mesh are
collectives; the fused gate refuses both, and the trial runner's vmap,
before the step is chosen), or where the capture itself failed
(``eval_graph.capture_failed``), which warns. Any other error is raised.
``STEP_GRAPH`` counts captures, replays and eager steps;
``last_eager_reason`` says why the last eager step was one. The kernels'
launch counters count what ran: the capture's launches are taken back, and
each replay adds them again.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass

import torch

from psvi_torch.inference.eval_graph import capture_failed
from psvi_torch.ops import optim as O
from psvi_torch.utils.resource import (add_launches, launch_counts, launches_since,
                                       restore_launch_counts, span)
from psvi_torch.utils.tree import tree_leaves, tree_unflatten

STEP_GRAPH = {"captures": 0, "replays": 0, "eager": 0, "last_eager_reason": ""}


def reset_step_graph():
    STEP_GRAPH.update(captures=0, replays=0, eager=0, last_eager_reason="")


def ineligible(eng):
    """Why ``eng``'s step cannot be a graph, or None where it can."""
    if eng.mc_shard is not None or eng.data_shard is not None:
        return "shard_mc/shard_batch: the step's sums over the mesh are collectives"
    if eng.device.type != "cuda":
        return f"device {eng.device.type}: a CUDA graph needs a CUDA device"
    return None


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


def _input_leaves(inputs):
    xb, yb, e_in, eps_outer = inputs
    return [xb, yb, e_in] + tree_leaves(eps_outer)


def _with_input_leaves(inputs, leaves):
    return (*leaves[:3], tree_unflatten(inputs[3], leaves[3:]))


def graph_key(eng, state, cfg, inputs):
    """What a captured step depends on besides the values of the state's
    leaves and of its inputs."""
    names = eng._hyper_names()
    leaves = _state_leaves(state, names) + _input_leaves(inputs)
    return (tuple((tuple(x.shape), x.dtype, x.device) for x in leaves), cfg, tuple(names),
            tuple(getattr(eng, "opt_" + n).hyper for n in names), id(eng.net),
            eng.lr_net_sched(state.net_step))


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


def _static(state, names, inputs):
    """Clones of the state's leaves and the inputs (the graph's buffers),
    and the state and inputs made of them."""
    leaves = _state_leaves(state, names)
    static = [x.detach().clone() for x in leaves + _input_leaves(inputs)]
    return (static, _with_state_leaves(state, names, static[:len(leaves)]),
            _with_input_leaves(inputs, static[len(leaves):]))


def _run_body(eng, state, cfg, inputs, names, bc):
    """The body with the hyper-Adams reading ``bc``; the tensors a step
    returns: the unrolled flat net, the losses, the stepped
    hyperparameters and their Adam moments."""
    with _reading_corrections(eng, names, bc):
        state, pT, aux = eng._fused_lenet_body(state, cfg, *inputs)
    return ([pT, aux["outer_loss"], aux["inner_losses"]] + [getattr(state, n) for n in names]
            + [x for n in names for x in getattr(state, "opt_" + n)[1:]])


def _assemble(eng, state, cfg, names, outs):
    """The step's (state, aux) from ``state`` and the body's outputs."""
    pT, loss, inner = outs[:3]
    k = len(names)
    fields = {}
    for i, n in enumerate(names):
        fields[n] = outs[3 + i]
        m = 3 + k + 2 * i
        fields["opt_" + n] = O.AdamState(getattr(state, "opt_" + n).count + 1, *outs[m:m + 2])
    state = eng._with_unrolled_net(state._replace(**fields), pT, cfg)
    return state, {"outer_loss": loss, "inner_losses": inner}


@dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph, or None where the capture failed
    keep: object  # what the key names by id: the net
    static: list  # the state's leaves, then the inputs'
    bc: torch.Tensor  # (names, 2): each hyper-Adam's bias corrections
    opts: list  # the engine's hyper-Adams, one a name
    out: list = None
    launches: list = ()  # (counter, {kernel: launches a replay adds})
    reason: str = ""


class StepGraph:
    """One engine's captured LeNet step; ``__call__`` is the step from its
    drawn inputs ``(xb, yb, e_in, eps_outer)``."""

    def __init__(self):
        self.key = self.g = None

    def __call__(self, eng, state, cfg, inputs):
        reason = ineligible(eng)
        if reason is None:
            key = graph_key(eng, state, cfg, inputs)
            if key != self.key:
                self.key = self.g = None  # the old graph and its pool go
                with span("psvi.step.capture"):
                    g, out = self._capture(eng, state, cfg, inputs)
                self.key, self.g = key, g
                if g.graph is None:
                    _eager(g.reason)
                return out
            if self.g.graph is not None:
                return self._replay(eng, state, cfg, inputs)
            reason = self.g.reason
        _eager(reason)
        st, pT, aux = eng._fused_lenet_body(state, cfg, *inputs)
        return eng._with_unrolled_net(st, pT, cfg), aux

    def _replay(self, eng, state, cfg, inputs):
        g, names = self.g, eng._hyper_names()
        with span("psvi.step.replay"):
            torch._foreach_copy_(g.static, _state_leaves(state, names) + _input_leaves(inputs))
            write_corrections(g.bc, state, names, g.opts)
            g.graph.replay()
            add_launches(g.launches)
            STEP_GRAPH["replays"] += 1
            outs = [torch.empty_like(x) for x in g.out]
            torch._foreach_copy_(outs, g.out)
            return _assemble(eng, state, cfg, names, outs)

    @staticmethod
    def _capture(eng, state, cfg, inputs):
        """The body on a side stream, then its capture there; returns the
        graph (without one where the capture failed) and the eager body's
        step. The capture's launches are taken off the counters."""
        dev, stream = eng.device, torch.cuda.current_stream(eng.device)
        names = eng._hyper_names()
        static, st, ins = _static(state, names, inputs)
        opts = [getattr(eng, "opt_" + n) for n in names]
        g = _Graph(None, eng.net, static, torch.empty((len(names), 2), dtype=state.u.dtype,
                                                      device=dev), opts)
        write_corrections(g.bc, state, names, opts)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            out = _run_body(eng, st, cfg, ins, names, g.bc)
        stream.wait_stream(side)
        for x in out:
            x.record_stream(stream)
        warm = launch_counts()
        try:
            graph = torch.cuda.CUDAGraph()
            # not torch.cuda.graph: its gc.collect and empty_cache cost set-up
            # 0.1-0.2 s, and the steps after it must allocate afresh
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    g.out = _run_body(eng, st, cfg, ins, names, g.bc)
                finally:
                    graph.capture_end()
            g.launches = launches_since(warm)
            g.graph = graph
            STEP_GRAPH["captures"] += 1
        except RuntimeError as e:
            if not capture_failed(e):
                raise
            g.static = g.out = None
            g.reason = f"capture failed: {type(e).__name__}: {e}"
            warnings.warn(f"the LeNet step runs eagerly: {g.reason}", RuntimeWarning,
                          stacklevel=3)
        finally:
            restore_launch_counts(warm)
        return g, _assemble(eng, state, cfg, names, out)


def _eager(reason):
    STEP_GRAPH["eager"] += 1
    STEP_GRAPH["last_eager_reason"] = reason
