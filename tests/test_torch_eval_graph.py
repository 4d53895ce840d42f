"""The classifier's evaluation as one CUDA graph
(``psvi_torch/inference/eval_graph.py``) and the NKL's prior scale made on
the device.

On the CPU (tier 1):

- ``_MeanField.nkl`` and ``VILinearFullCov.nkl`` give the old formula's
  values bit for bit at prior_sd 1.0 and 0.3, and call no ``torch.tensor``
  (the host-to-device copy that synchronised the card's stream);
- the eligibility decision sends a CPU engine and a ``shard_mc`` engine to
  the eager loop with its reason, and ``EVAL_GRAPH["eager"]`` counts them;
- the eager loop over the padded test set, built once per test set, gives
  the old loop's values bit for bit from one generator state;
- ``graph_key`` moves with M, the IW correction, the net, the test set and
  S, and not with a new state of the same shapes;
- every launch counter of the ``ops`` modules is registered, so that a
  replay adds to it;
- only a capture's own failures (refused operations, no memory) send the
  evaluation to its eager loop.

On the card (``-m card``; skipped without one): the graphed evaluation of
a small LeNet and an ``fn`` engine against the eager loop from the same
generator state, across a changed state, a prune (one recapture),
``correction=False``, a restored checkpoint and ten generators swapped in
as the trial runner does (no recapture), with the counts; the kernels'
launch counters through replays; a capture that runs out of memory falls
back with a warning, and a kernel's fault during the capture is raised. On
the card machine, which has no JAX:
``python -m pytest --noconftest -m card tests/test_torch_eval_graph.py``.
"""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.data.datasets import DataBundle
from psvi_torch.data.synthetic import make_synth_images
from psvi_torch.inference import eval_graph as EG
from psvi_torch.inference.psvi import PSVI, _count_pad
from psvi_torch.models.layers import (_HALF_LOG_2PI, VIConv2d, VILinear, VILinearFullCov,
                                     _normal_logpdf, softplus)
from psvi_torch.ops import elbo as E
from psvi_torch.parallel.mesh import make_mesh


def _lenet(device="cpu", **kw):
    # 50 test points in batches of 8: the last batch padded by 6 repeats
    x, y, xt, yt = make_synth_images(n_per_class=3, n_test_per_class=5,
                                     rng=np.random.default_rng(0))
    data = DataBundle(x, y, xt, yt, len(x), 28 * 28, 10, channels=1)
    return PSVI(data, **{**dict(method="psvi_learn_v", architecture="lenet", num_pseudo=10,
                                mc_samples=2, inner_it=2, data_minibatch=8, init_sd=1e-3,
                                seed=0, device=device, fused_inner=False), **kw})


def _fn(device="cpu", **kw):
    return PSVI(read_dataset("four_blobs"), **{**dict(
        method="psvi_learn_v", architecture="fn", n_hidden=40, num_pseudo=16, mc_samples=4,
        inner_it=2, data_minibatch=64, seed=0, device=device, fused_inner=False), **kw})


def _moved(params, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {k: p + 0.1 * torch.randn(p.shape, generator=g) for k, p in params.items()}


# ----------------------------------------------------------------------
# the NKL's prior scale


def _old_mean_field_nkl(layer, params, eps):
    w, b = layer._theta(params, eps)
    sp = torch.tensor(layer.prior_sd, dtype=w.dtype, device=w.device)
    axes = tuple(range(1, w.dim()))
    out = (torch.sum(_normal_logpdf(w, 0.0, sp), dim=axes)
           - torch.sum(_normal_logpdf(w, params["mu_w"], softplus(params["rho_w"])), dim=axes))
    return out + (torch.sum(_normal_logpdf(b, 0.0, sp), dim=-1)
                  - torch.sum(_normal_logpdf(b, params["mu_b"], softplus(params["rho_b"])),
                              dim=-1))


def _old_fullcov_nkl(layer, params, eps):
    theta, L = layer._theta_flat(params, eps)
    lq = (-0.5 * torch.sum(torch.square(eps["e"]), dim=-1)
          - torch.sum(torch.log(torch.diagonal(L))) - layer.num_params * _HALF_LOG_2PI)
    sp = torch.tensor(layer.prior_sd, dtype=theta.dtype, device=theta.device)
    return torch.sum(_normal_logpdf(theta, 0.0, sp), dim=-1) - lq


LAYERS = {
    "dense": (lambda sd: VILinear(5, 3, init_sd=0.1, prior_sd=sd), _old_mean_field_nkl),
    "conv": (lambda sd: VIConv2d(2, 3, 3, init_sd=0.1, prior_sd=sd), _old_mean_field_nkl),
    "fullcov": (lambda sd: VILinearFullCov(4, 3, init_sd=0.1, prior_sd=sd), _old_fullcov_nkl),
}


@pytest.mark.parametrize("prior_sd", [1.0, 0.3])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_nkl_prior_scale_on_device_bit_identical(kind, prior_sd, monkeypatch):
    make, old = LAYERS[kind]
    layer = make(prior_sd)
    gen = torch.Generator().manual_seed(0)
    params = _moved(layer.init(gen))
    eps = layer.sample_eps(gen, 4)
    want = old(layer, params, eps)

    def no_host_tensor(*a, **k):
        raise AssertionError("nkl made a tensor from a host value")

    monkeypatch.setattr(torch, "tensor", no_host_tensor)
    got = layer.nkl(params, eps)
    assert got.shape == (4,) and got.dtype == want.dtype
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# eligibility, the eager loop, the key


@pytest.mark.parametrize("case", ["cpu", "shard_mc"])
def test_eager_loop_where_no_graph_serves(case):
    eng = _lenet() if case == "cpu" else _fn(mesh=make_mesh(), shard_mc=True)
    EG.reset_eval_graph()
    reason = EG.ineligible(eng)
    assert reason.startswith("device cpu" if case == "cpu" else "shard_mc")
    out = eng._evaluate_fn(eng.state)
    eng._evaluate_fn(eng.state, correction=False)
    assert len(out) == 5 and all(torch.isfinite(x) for x in out)
    assert EG.EVAL_GRAPH == {"captures": 0, "replays": 0, "eager": 2}
    assert EG.last_eager_reason == reason
    assert eng._eval_graph.g is None


def _old_evaluate(eng, state, correction):
    """The loop as it was before the padded test set was kept: padded and
    masked on every call."""
    S = eng.mc_samples_eval
    n_test = int(eng.x_test.shape[0])
    B = min(eng.data_minibatch, n_test)
    pad = _count_pad(n_test, B)
    xt = torch.cat([eng.x_test, eng.x_test[:pad]]) if pad else eng.x_test
    yt = torch.cat([eng.y_test, eng.y_test[:pad]]) if pad else eng.y_test
    mask = torch.cat([torch.ones(n_test), torch.zeros(pad)])
    cw, fv = eng._core_weights(state.v, state.alpha)
    M = state.u.shape[0]
    corrects = nll_sum = total = 0.0
    for b0 in range(0, n_test + pad, B):
        xb, yb, m = xt[b0:b0 + B], yt[b0:b0 + B], mask[b0:b0 + B]
        eps = eng._sample_eps(S)
        logits = eng.net.apply(state.params, eps, torch.cat([state.u, xb]))
        lw = E.importance_log_weights(eng.net, state.params, eps, state.u, state.z, cw,
                                      nc=eng.nc, pseudo_out=logits[:, :M])
        probs, weights = E.predictive_mixture(logits[:, M:], lw, correction=correction)
        pred = torch.argmax(probs, dim=-1).to(torch.float32)
        corrects = corrects + torch.sum((pred == yb) * m)
        p_true = torch.gather(probs, 1, yb.long()[:, None])[:, 0]
        nll_sum = nll_sum - torch.sum(torch.log(torch.clamp_min(p_true, 1e-38)) * m)
        total = total + torch.sum(m)
    iw_ent, ness, vent = E.iw_diagnostics(weights, fv, eng.num_pseudo)
    return corrects / total, nll_sum / total, iw_ent, ness, vent


@pytest.mark.parametrize("correction", [True, False])
def test_eager_loop_matches_the_old_loop(correction):
    eng = _lenet()
    st = eng.state._replace(params=tuple(_moved(p) if p else p for p in eng.state.params))
    g0 = eng.gen.get_state()
    with torch.no_grad():
        want = _old_evaluate(eng, st, correction)
    g1 = eng.gen.get_state()
    eng.gen.set_state(g0)
    got = eng._evaluate_fn(st, correction)
    assert torch.equal(eng.gen.get_state(), g1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_padded_test_set_built_once_per_test_set():
    eng = _lenet()
    t = eng._padded_test()
    assert eng._padded_test() is t
    B, xt, yt, mask = t
    assert B == 8 and xt.shape[0] == 56 and float(mask.sum()) == 50.0
    eng.x_test, eng.y_test = eng.x_test[:40], eng.y_test[:40]
    t2 = eng._padded_test()
    assert t2 is not t and t2[1].shape[0] == 40 and t2[1] is eng.x_test
    eng.data_minibatch = 16
    assert eng._padded_test()[0] == 16


KEY_CHANGES = {
    "new state, same shapes": (lambda e: e.weight_reset(), False),
    "prune": (lambda e: e.prune_coreset(6), True),
    "rebuilt net": (lambda e: e._build_model(), True),
    "new test set": (lambda e: setattr(e, "x_test", e.x_test.clone()), True),
    "mc_samples_eval": (lambda e: setattr(e, "mc_samples_eval", 3), True),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_graph_key_follows_what_the_launches_depend_on(change):
    eng = _lenet()
    key = lambda c=True: EG.graph_key(eng, eng.state, c, eng._padded_test())  # noqa: E731
    k0 = key()
    assert key() == k0 and key(False) != k0
    act, moves = KEY_CHANGES[change]
    act(eng)
    assert (key() != k0) == moves


def test_every_ops_launch_counter_is_registered():
    import psvi_torch.ops as ops
    from psvi_torch.utils.resource import LAUNCH_COUNTERS

    counters = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"psvi_torch.ops.{info.name}")
        counters += [getattr(mod, n) for n in ("LAUNCHES", "LAUNCH_SHAPES") if hasattr(mod, n)]
    assert len(counters) >= 5
    registered = {id(c) for c in LAUNCH_COUNTERS}
    assert all(id(c) in registered for c in counters)


FAULTS = {
    "out of memory": (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"), True),
    "refused in capture": (RuntimeError(
        "CUDA error: operation not permitted when stream is capturing"), True),
    "invalidated": (RuntimeError(
        "CUDA error: operation failed due to a previous error during capture"), True),
    "torch refuses": (RuntimeError(
        "Cannot call CUDAGeneratorImpl::current_seed during CUDA graph capture."), True),
    "illegal address": (torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"), False),
    "kernel's own error": (RuntimeError("fused_lenet: launch failed (status 700)"), False),
    "not a torch error": (ValueError("capture"), False),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_only_the_captures_own_failures_fall_back(fault):
    e, falls_back = FAULTS[fault]
    assert EG.capture_failed(e) == falls_back


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _against_eager(eng, state, correction=True):
    """The graphed evaluation and then the eager loop from the generator
    state it started from: the accuracy equal, the NLL and the IW
    diagnostics within 1e-6 relative, the generator's state after each
    the same. Returns the graphed values."""
    g0 = eng.gen.get_state()
    got = eng._evaluate_fn(state, correction)
    g1 = eng.gen.get_state()
    eng.gen.set_state(g0)
    with torch.no_grad():
        want = eng._evaluate_batches(state, correction, eng._padded_test())
    assert torch.equal(eng.gen.get_state(), g1)
    assert float(got[0]) == float(want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
    return [float(x) for x in got]


@pytest.mark.card
@pytest.mark.parametrize("make", [_lenet, _fn], ids=["lenet", "fn"])
def test_graphed_evaluation_matches_eager(card, make, tmp_path):
    eng = make(card)
    EG.reset_eval_graph()

    def counts(c, r):
        assert EG.EVAL_GRAPH == {"captures": c, "replays": r, "eager": 0}, EG.last_eager_reason

    _against_eager(eng, eng.state)  # the capture's call: its eager run is the result
    counts(1, 0)
    eng.state, _ = eng._step(eng.state)  # a new state: the graph reads it
    _against_eager(eng, eng.state)
    counts(1, 1)
    for seed in range(10):  # the trial runner's generators: no recapture
        with eng._drawing_from(torch.Generator(card).manual_seed(seed)):
            _against_eager(eng, eng.state)
    counts(1, 11)
    eng.prune_coreset(eng.num_pseudo // 2)  # M changes: one recapture
    _against_eager(eng, eng.state)
    _against_eager(eng, eng.state)
    counts(2, 12)
    _against_eager(eng, eng.state, correction=False)
    counts(3, 12)
    path = str(tmp_path / "ckpt.npz")
    eng.save_checkpoint(path)
    first = _against_eager(eng, eng.state, correction=False)
    eng.state, _ = eng._step(eng.state)
    eng.load_checkpoint(path)
    again = _against_eager(eng, eng.state, correction=False)
    counts(3, 14)
    assert again == first


def _failing_capture(eng, error):
    """``eng``'s loop, raising ``error`` when run inside a capture."""
    loop = eng._evaluate_batches

    def batches(*a):
        if torch.cuda.is_current_stream_capturing():
            raise error
        return loop(*a)

    eng._evaluate_batches = batches


@pytest.mark.card
def test_capture_out_of_memory_falls_back_with_a_warning(card):
    eng = _fn(card)
    _failing_capture(eng, torch.cuda.OutOfMemoryError("CUDA out of memory in the capture"))
    EG.reset_eval_graph()
    with pytest.warns(RuntimeWarning, match="eager loop: capture failed: OutOfMemoryError"):
        _against_eager(eng, eng.state)
    _against_eager(eng, eng.state)  # no second capture, no second warning
    assert EG.EVAL_GRAPH == {"captures": 0, "replays": 0, "eager": 2}
    assert EG.last_eager_reason.startswith("capture failed: OutOfMemoryError")


@pytest.mark.card
def test_kernel_fault_in_the_capture_is_raised(card):
    eng = _fn(card)
    _failing_capture(eng, torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"))
    EG.reset_eval_graph()
    with pytest.raises(torch.AcceleratorError, match="illegal memory access"):
        eng._evaluate_fn(eng.state)
    assert EG.EVAL_GRAPH == {"captures": 0, "replays": 0, "eager": 0}


@pytest.mark.card
def test_replays_count_the_kernels_launches(card):
    """Kernel B3 inside the evaluation (``backend="pallas"``; the batched
    dense layers): after the capture's evaluation and two replays its
    counters read what three eager evaluations launch."""
    from psvi_torch.ops import sampled_linear as SL

    eng = _fn(card, trainer="joint", backend="pallas")
    SL.reset_launches()
    with torch.no_grad():
        eng._evaluate_batches(eng.state, True, eng._padded_test())
    per_eval, shapes = SL.LAUNCHES["sampled_linear"], dict(SL.LAUNCH_SHAPES)
    assert per_eval > 0
    EG.reset_eval_graph()
    SL.reset_launches()
    for _ in range(3):
        eng._evaluate_fn(eng.state)
    assert EG.EVAL_GRAPH == {"captures": 1, "replays": 2, "eager": 0}, EG.last_eager_reason
    assert SL.LAUNCHES["sampled_linear"] == 3 * per_eval
    assert dict(SL.LAUNCH_SHAPES) == {k: 3 * n for k, n in shapes.items()}
