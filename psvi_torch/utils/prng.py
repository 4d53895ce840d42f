"""Generator discipline: one ``torch.Generator`` per trial and purpose.

Counterpart of ``psvi_tpu/utils/prng.py``. JAX threads explicit keys:
``trial_key(seed, trial) = fold_in(PRNGKey(seed), trial)``, then a fold of
the step index per step. The port's engine draws from one generator
instead, in a fixed order (a step's batch, then its noise); what JAX's
folding buys, a stream that depends only on (seed, trial) and not on how
many trials, processes or devices share the run, comes here from seeding
each generator by a hash of the numbers that name it (NumPy's
``SeedSequence``): the trial runner gives trial t the generator
``trial_generator(1000, t)`` for its steps and another stream of it for its
evaluations, whichever rank holds the trial.
"""

from __future__ import annotations

import numpy as np
import torch


def trial_seed(seed: int, trial: int, stream: int = 0) -> int:
    """A 63-bit seed that depends on (seed, trial, stream) alone."""
    words = np.random.SeedSequence([int(seed), int(trial), int(stream)]).generate_state(2)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2**63 - 1)


def trial_generator(seed: int, trial: int, device, stream: int = 0) -> torch.Generator:
    """The counterpart of ``trial_key``: a generator on ``device`` seeded from
    (seed, trial) and, for a second stream of the same trial, ``stream``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(trial_seed(seed, trial, stream))
    return gen


def step_keys(gen: torch.Generator, it: int, n: int) -> list:
    """The counterpart of ``step_keys(key, it, n)``: ``n`` generators for step
    ``it`` (one per purpose), seeded from ``gen``'s initial seed, ``it`` and
    the purpose's index, so that a step's streams do not depend on what was
    drawn before it. The engine itself needs none: a step draws its batch,
    then its noise, from the engine's one generator in that order, and a
    chained block draws them in the same order as single steps."""
    return [trial_generator(gen.initial_seed(), it, gen.device, stream=i) for i in range(n)]
