"""Frequentist (non-Bayesian) models for coreset scoring.

Counterpart of ``psvi_tpu/models/frequentist.py``: a plain logistic
regression, or one linear layer with cross-entropy, trained by Adam
(``ops/optim.py::adam``) on minibatches, for the EL2N scores (Paul et al.
2021) of the selection baselines. The initial weights (U(±1/√D)) and the
minibatches come from a generator seeded with ``seed``, through
``utils/draws``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from psvi_torch.device import resolve_device
from psvi_torch.ops import optim as O
from psvi_torch.utils import draws
from psvi_torch.utils.tree import value_and_grad


def _init_linear(gen, din, dout):
    bound = 1.0 / np.sqrt(din)
    return {"w": draws.uniform(gen, (dout, din), -bound, bound),
            "b": draws.uniform(gen, (dout,), -bound, bound)}


class RunFrequentistModel:
    """Train, test and score a frequentist model (JAX ``RunFrequentistModel``).

    ``is_logreg=True``: binary logistic regression with the BCE loss;
    otherwise one linear layer D → num_classes with cross-entropy (ref
    ``FreqOneLayer``). The parameters are ``{"out": {"w", "b"}}``.
    """

    def __init__(self, x, y, xt, yt, num_classes=2, n_hidden=100, is_logreg=True,
                 data_minibatch=128, num_epochs=20, lr=1e-3, seed=0, device=None):
        dev = self.device = resolve_device(device)

        def t(a, flat=False):
            a = np.asarray(a, np.float32)
            return torch.as_tensor(a.reshape(len(a), -1) if flat else a, device=dev)

        self.x, self.y = t(x, flat=True), t(y)
        self.xt, self.yt = t(xt, flat=True), t(yt)
        self.nc = num_classes
        self.is_logreg = is_logreg
        self.B = min(data_minibatch, len(x))
        self.num_epochs = num_epochs
        self.gen = draws.generator(seed, dev)
        D = self.x.shape[1]
        self.params = {"out": _init_linear(self.gen, D, 1 if is_logreg else num_classes)}
        self.opt = O.adam(lr)
        self.opt_state = self.opt.init(self.params)

    def _forward(self, params, x):
        return x @ params["out"]["w"].T + params["out"]["b"]

    def _loss(self, params, xb, yb):
        out = self._forward(params, xb)
        if self.is_logreg:
            logits = out[:, 0]
            return -torch.mean(yb * F.logsigmoid(logits) + (1 - yb) * F.logsigmoid(-logits))
        logp = torch.log_softmax(out, dim=-1)
        return -torch.mean(torch.gather(logp, 1, yb.long()[:, None]))

    def _train_step(self, params, opt_state, idx=None):
        """One Adam step on a minibatch (``idx``: its indices, else drawn)."""
        if idx is None:
            idx = draws.choice(self.gen, self.x.shape[0], self.B)
        loss, g = value_and_grad(lambda p: self._loss(p, self.x[idx], self.y[idx]), params)
        params, opt_state = self.opt.step(params, g, opt_state)
        return params, opt_state, loss

    def train(self):
        steps_per_epoch = max(1, self.x.shape[0] // self.B)
        for _ in range(self.num_epochs * steps_per_epoch):
            self.params, self.opt_state, _ = self._train_step(self.params, self.opt_state)

    @torch.no_grad()
    def test(self):
        out = self._forward(self.params, self.xt)
        if self.is_logreg:
            p = torch.sigmoid(out[:, 0])
            acc = torch.mean(((p > 0.5).float() == self.yt).float())
            pc = torch.clamp_min(torch.where(self.yt > 0.5, p, 1 - p), 1e-38)
            nll = -torch.mean(torch.log(pc))
        else:
            acc = torch.mean((torch.argmax(out, -1).float() == self.yt).float())
            logp = torch.log_softmax(out, dim=-1)
            nll = -torch.mean(torch.gather(logp, 1, self.yt.long()[:, None]))
        return float(acc), float(nll)

    @torch.no_grad()
    def get_el2n_scores(self) -> np.ndarray:
        """‖p(x) − onehot(y)‖₂ per training point (ref :148-181)."""
        out = self._forward(self.params, self.x)
        if self.is_logreg:
            p1 = torch.sigmoid(out)
            probs = torch.cat([1 - p1, p1], dim=1)
        else:
            probs = torch.softmax(out, dim=-1)
        onehot = F.one_hot(self.y.long(), self.nc).to(probs.dtype)
        return torch.linalg.norm(probs - onehot, dim=1).cpu().numpy()

    def get_largest_el2n_indices(self, coreset_size: int):
        scores = self.get_el2n_scores()
        if coreset_size <= 0:
            return []
        return list(np.argsort(-scores)[:coreset_size])
