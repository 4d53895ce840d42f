"""The port's AlexNet against the benchmark's plain reference
(``portbench/reference/alexnet.py``, plain ``torch`` with nothing of the
port), at the published widths (conv 3→64→64 5×5, fc 4096-384-192-10) in
float64 on the CPU: S=2, T=2, M=4, B=8, seeded weights.

- the forward over sampled weights;
- one plain ``PSVI._nested_step`` (the autograd unroll that trains every
  conv net of the zoo but LeNet): the hypergradients of u and v as the hyper-Adam takes them,
  the unrolled net, u and v after the step. The port rounds Adam's bias
  corrections and the net's learning rate to float32, as the JAX package
  does; the reference computes them in float64. So the test hands the
  reference the port's learning rate and the port exact bias corrections,
  and holds the rest at float64's precision: relative 1e-10 on the
  hypergradients (the largest gap, 2e-13 here, is on g_u: the first inner
  Adam step divides by |g| + 1e-8, which magnifies a parameter's rounding
  where its inner gradient is small), the net, u and v;
- the step's counter ``UNROLL``: T differentiated iterations a step, no
  remat, 0 bytes off the card;
- the step's spans: with the recorder on, ``psvi.unroll.fwd``,
  ``psvi.outer.fwd`` and ``psvi.outer.bwd`` close in that order inside the
  step; off, nothing is recorded.
"""

import numpy as np
import pytest
import torch

from portbench.reference import alexnet as RA
from portbench.reference import common as R
from psvi_torch.data.datasets import DataBundle
from psvi_torch.inference import psvi as P
from psvi_torch.ops import optim as O
from psvi_torch.utils import resource as RES

S, T, M, B = 2, 2, 4, 8


def _exact_bias_corrections(t, b1, b2):
    return 1.0 - b1 ** t, float(np.sqrt(1.0 - b2 ** t))


@pytest.fixture
def f64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _engine():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((20, 3, 32, 32)).astype(np.float32)
    y = (np.arange(20) % 10).astype(np.float32)
    data = DataBundle(x, y, x[:10], y[:10], 20, 32 * 32, 10, channels=3)
    return P.PSVI(data, method="psvi_learn_v", architecture="alexnet", num_pseudo=M,
                  mc_samples=S, inner_it=T, data_minibatch=B, init_sd=1e-3, num_epochs=1,
                  log_every=1000, seed=0, device="cpu", fused_inner=False)


def _draws(eng):
    g = torch.Generator().manual_seed(1)
    xb = torch.randn(B, 3, 32, 32, generator=g)
    yb = (torch.arange(B) % 10).to(torch.get_default_dtype())
    return (xb, yb), ([eng._sample_eps(S) for _ in range(T)], eng._sample_eps(S))


def _noise(eng, eps_tree):
    return [(e["w"], e["b"]) for i, e in enumerate(eps_tree) if i in eng.net.variational_layers]


def test_forward_matches_reference(f64):
    eng = _engine()
    vi = eng.net.variational_layers
    eps = eng._sample_eps(S)
    x = torch.randn(5, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    ours = eng.net.apply(eng.state.params, eps, x)
    thetas = [eng.net.layers[i]._theta(eng.state.params[i], eps[i]) for i in vi]
    ref = RA.forward(thetas, x)
    assert ours.shape == ref.shape == (S, 5, 10)
    torch.testing.assert_close(ours, ref, rtol=1e-12, atol=1e-12)


def test_nested_step_matches_reference(f64, monkeypatch):
    monkeypatch.setattr(O, "bias_corrections", _exact_bias_corrections)
    eng = _engine()
    vi = eng.net.variational_layers
    state = eng.state
    batch, (e_in, e_out) = _draws(eng)
    grads = {}
    apply = eng._apply_hyper_updates

    def capture(st, g):
        grads.update(g)
        return apply(st, g)

    eng._apply_hyper_updates = capture
    new, aux = eng._nested_step(state, batch=batch, eps=(e_in, e_out))

    hp = R.Hyper(N=float(eng.N), T=T, lr_net=eng.lr_net_sched(0), lr_u=1e-4, lr_v=1e-3)
    zero = lambda t: R.HyperAdam(0, torch.zeros_like(t), torch.zeros_like(t))  # noqa: E731
    layers, u, v, _, _, rec = R.nested_step(
        RA.MODEL, [state.params[i] for i in vi], state.u, state.z, state.v, zero(state.u),
        zero(state.v), *batch, [_noise(eng, e) for e in e_in], _noise(eng, e_out), hp)

    assert float(aux["outer_loss"]) == pytest.approx(float(rec["outer_loss"]), rel=1e-12)
    torch.testing.assert_close(aux["inner_losses"], rec["inner_losses"], rtol=1e-12, atol=0)
    for k in ("u", "v"):
        ref = rec[f"g_{k}"]
        assert float((grads[k] - ref).abs().max() / ref.abs().max()) < 1e-10, k
    for j, i in enumerate(vi):
        for key in R.KEYS:
            torch.testing.assert_close(new.params[i][key], layers[j][key], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(new.u, u, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(new.v, v, rtol=1e-10, atol=1e-12)


def test_unroll_counter_and_spans():
    eng = _engine()
    batch, eps = _draws(eng)
    P.reset_unroll()
    RES.take_spans()
    eng._nested_step(eng.state, batch=batch, eps=eps)
    assert P.UNROLL == {"iterations": T, "remat": False, "resident_bytes": 0,
                        "resident_bytes_max": 0}
    assert RES.take_spans() == []
    RES.enable_spans()
    try:
        eng._nested_step(eng.state, batch=batch, eps=eps)
    finally:
        RES.disable_spans()
    recs = RES.take_spans()
    assert [r[0] for r in recs] == ["psvi.unroll.fwd", "psvi.outer.fwd", "psvi.outer.bwd"]
    assert all(t0 <= t1 for _, _, t0, t1 in recs)
    assert recs[0][3] <= recs[1][2] and recs[1][3] <= recs[2][2]
    assert P.UNROLL["iterations"] == 2 * T
