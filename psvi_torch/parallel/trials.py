"""Trial-parallel PSVI: independent trials as a vmapped leading axis.

Counterpart of ``psvi_tpu/parallel/trials.py``. The reference runs
``num_trials`` seeds as separate processes; JAX stacks the trials' states
along a leading axis and advances them with one ``jax.vmap`` of the step.
Here the same: one engine builds every trial's state (``reseed(t)``), the
states are stacked along a leading trial axis (a Python int of the state,
an Adam step count or ``net_step``, is the same in every trial and stays
one int), and each step advances every trial of this rank as one
``torch.func.vmap`` of the engine's step resolved under ``_in_trial_vmap``
(the plain step with every gradient through ``torch.func``; the fused
kernels refuse it, as JAX's gates do).

``vmap`` draws nothing, so each trial's batch and noise are drawn outside
it, from the trial's own generator ``trial_generator(1000, t)`` in the
order the plain step draws them, and stacked; its evaluations draw from a
second stream of the trial, one trial at a time. A trial's numbers do not
depend on how many trials or ranks share the run. Over a mesh whose
``trial`` axis spans ranks, each rank runs its slice of the (padded)
trials and the evaluations are summed over the axis, so every rank
returns every trial's results. ``run(chain_steps=True)`` draws each
``log_every`` block's inputs before its steps; it equals
``chain_steps=False``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from psvi_torch.data.datasets import DataBundle
from psvi_torch.inference.psvi import PSVI, PSVIRegressor
from psvi_torch.parallel.mesh import axis_rank, axis_size, make_mesh
from psvi_torch.utils.config import METHOD_SPECS
from psvi_torch.utils.prng import trial_generator

# the stream of a trial's evaluation draws (JAX folds 0x5EED into the key)
EVAL_STREAM = 0x5EED


def stack_trees(trees):
    """Trees of one structure stacked leafwise along a new leading axis; a
    non-tensor leaf must be equal in every tree and stays one value."""
    def stack(*xs):
        if torch.is_tensor(xs[0]):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs[1:]):
            raise ValueError(f"trials disagree on a shared value: {xs}")
        return xs[0]

    return pytree.tree_map(stack, trees[0], *trees[1:])


def index_tree(tree, i: int):
    """Entry ``i`` of every tensor leaf of a stacked tree."""
    return pytree.tree_map(lambda x: x[i] if torch.is_tensor(x) else x, tree)


class TrialParallelPSVI:
    def __init__(self, data: DataBundle, num_trials: int, method: str = "psvi_learn_v",
                 mesh=None, **engine_kwargs):
        for flag in ("reset", "prune", "increment"):
            if engine_kwargs.get(flag):
                raise ValueError(
                    f"{flag}=True is not supported in trial-parallel mode "
                    "(lifecycle runs mutate static shapes mid-run; run "
                    "them through the single-engine path)")
        cls = PSVIRegressor if METHOD_SPECS[method].regressor else PSVI
        self.mesh = mesh if mesh is not None else make_mesh(trial=1)
        # pad the trial count up to a multiple of the trial axis (the extra
        # seeds run as real trials; run() returns only the requested ones)
        self.axis = axis_size(self.mesh, "trial")
        self.num_trials = num_trials
        self._padded_trials = -(-num_trials // self.axis) * self.axis
        per = self._padded_trials // self.axis
        first = axis_rank(self.mesh, "trial") * per
        self.trials = list(range(first, first + per))  # this rank's
        self.base = cls(data, method=method, seed=0, **engine_kwargs)
        states = []
        for t in self.trials:
            self.base.reseed(t)
            states.append(self.base.state)
        self.base.reseed(0)
        self.states = stack_trees(states)
        # the flag is set only while the step is resolved, so that the base
        # engine keeps its fused path when used directly afterwards
        self.base._in_trial_vmap = True
        try:
            self._step, self._draw_eps = self.base._trainer_fn()
        finally:
            self.base._in_trial_vmap = False
        dev = self.base.device
        self.gens = [trial_generator(1000, t, dev) for t in self.trials]
        self.eval_gens = [trial_generator(1000, t, dev, stream=EVAL_STREAM) for t in self.trials]

    def draw(self):
        """Every local trial's batch and noise for one step, each from its
        own generator in the plain step's order, stacked: ((xb, yb), eps)."""
        draws = []
        for gen in self.gens:
            with self.base._drawing_from(gen):
                draws.append((self.base._sample_batch(), self._draw_eps()))
        return stack_trees([b for b, _ in draws]), stack_trees([e for _, e in draws])

    def vstep(self, states, batches, eps):
        """One step of every stacked trial as one ``torch.func.vmap`` call:
        (new stacked states, outer losses (trials,))."""
        in_dims = pytree.tree_map(lambda x: 0 if torch.is_tensor(x) else None, states)
        shared = {}

        def one(state, batch, e):
            new, aux = self._step(state, batch=batch, eps=e)
            leaves, spec = pytree.tree_flatten(new)
            shared["spec"] = spec
            shared["ints"] = [None if torch.is_tensor(x) else x for x in leaves]
            return [x for x in leaves if torch.is_tensor(x)], aux["outer_loss"]

        tensors, losses = torch.func.vmap(one, in_dims=(in_dims, 0, 0))(states, batches, eps)
        it = iter(tensors)
        leaves = [next(it) if x is None else x for x in shared["ints"]]
        return pytree.tree_unflatten(leaves, shared["spec"]), losses

    def _eval_now(self, results, times0):
        base = self.base
        vals = torch.zeros((self._padded_trials, 3), dtype=torch.float64, device=base.device)
        for i, t in enumerate(self.trials):
            with base._drawing_from(self.eval_gens[i]):
                acc, nll, _, ness, _ = base._evaluate_fn(index_tree(self.states, i))
            vals[t] = torch.stack([acc, nll, ness]).to(torch.float64)
        if self.axis > 1:
            dist.all_reduce(vals, group=self.mesh.get_group("trial"))
        vals = vals.cpu().tolist()
        for t in range(self.num_trials):
            results[t]["accs"].append(vals[t][0])
            results[t]["nlls"].append(vals[t][1])
            results[t]["ness"].append(vals[t][2])
            results[t]["csizes"].append(base.num_pseudo)
            results[t]["times"].append(time.time() - times0)

    def run(self, chain_steps: bool = True):
        """Advance all trials to ``num_epochs``, evaluating every
        ``log_every``; the requested trials' results dicts.

        chain_steps=True draws each ``log_every`` block's inputs before its
        steps run; False draws them step by step. Both give the same
        numbers: the draws come from the same streams in the same order."""
        base = self.base
        results = [{"accs": [], "nlls": [], "csizes": [], "times": [], "ness": []}
                   for _ in range(self.num_trials)]
        times0 = time.time()
        slots = 1 if not chain_steps else max(1, min(base.log_every, base.num_epochs))
        it = 0
        while it < base.num_epochs:
            if it % base.log_every == 0:
                self._eval_now(results, times0)
            n = min(slots - (it % slots), base.num_epochs - it)
            block = [self.draw() for _ in range(n)]
            for batches, eps in block:
                self.states, _ = self.vstep(self.states, batches, eps)
            it += n
        return results


def run_trials(data: DataBundle, num_trials: int, mesh=None, **kwargs):
    return TrialParallelPSVI(data, num_trials, mesh=mesh, **kwargs).run()
