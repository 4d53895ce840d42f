"""The fused LeNet nested step as one CUDA graph
(``psvi_torch/inference/cuda_graph.py::StepGraph``).

On the CPU (tier 1):

- a CPU engine steps eagerly, with its reason in ``STEP_GRAPH``, and so
  would a sharded one;
- ``graph_key`` moves with M (a prune), a StepLR tick at γ = 0.5 (not at
  γ = 1), the hyperparameter names, S, T, B and the net, and not with a new
  state of the same shapes;
- the hyper-Adam's bias corrections written to the buffer equal the host
  scalars bit for bit over 50 counts, and the Adam that reads them takes
  the same 50 steps bit for bit;
- the LeNet step is the step of the tree before it became a graph's body,
  bit for bit, from one generator state, drawn and fed through the seam;
- the graph's plumbing (static buffers, the body with the buffer's
  corrections written at the capture and before each replay, the step put
  together from its outputs) gives the eager step bit for bit, for each set
  of hyperparameter names.

On the card (``-m card``; skipped without one): 14 graphed steps of a small
LeNet engine, drawn and fed through the seam, against the eager step from
the same state and generator state, bit for bit, with the counts; the
states and ``aux`` it returned unchanged by later replays; a recapture on a
StepLR tick and after a prune; a profiler window over replays that names
the pair's kernels. The capture's failures are checked for the step and the
evaluation in ``tests/test_torch_eval_graph.py``. On the card's machine,
which has no JAX:
``python -m pytest --noconftest -m card tests/test_torch_step_graph.py``.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import dataclasses
import types

import numpy as np
import pytest
import torch

from psvi_torch.data.datasets import DataBundle
from psvi_torch.data.synthetic import make_synth_images
from psvi_torch.inference import cuda_graph as CG
from psvi_torch.inference.psvi import PSVI, FlatEps, _flat_eps
from psvi_torch.ops import fused_lenet as FL
from psvi_torch.ops import optim as O
from psvi_torch.parallel.mesh import make_mesh
from psvi_torch.utils.tree import tree_leaves, tree_map


def _lenet(device="cpu", n_per_class=3, **kw):
    x, y, xt, yt = make_synth_images(n_per_class=n_per_class, n_test_per_class=2,
                                     rng=np.random.default_rng(0))
    data = DataBundle(x, y, xt, yt, len(x), 28 * 28, 10, channels=1)
    return PSVI(data, **{**dict(method="psvi_learn_v", architecture="lenet", num_pseudo=10,
                                mc_samples=2, inner_it=2, data_minibatch=8, init_sd=1e-3,
                                seed=0, device=device, fused_inner=True), **kw})


def _inputs(eng):
    """A step's drawn inputs, as ``_nested_step_fused_lenet`` draws them."""
    cfg = FL.cfg_from_engine(eng)
    xb, yb = eng._sample_batch()
    e_in, eps_outer = eng._fused_lenet_eps(cfg.n_eps)
    return cfg, (xb, yb, e_in, eps_outer)


def _seam(eng):
    """A batch and the noise trees, drawn from a generator of their own,
    for the step's seam."""
    with eng._drawing_from(torch.Generator(eng.device).manual_seed(99)):
        return eng._sample_batch(), eng._stream_eps()


def _tensors(tree):
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if torch.is_tensor(x) else x == y) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
# eligibility and the key


@pytest.mark.parametrize("case", ["cpu", "shard_mc"])
def test_eager_step_where_no_graph_serves(case):
    if case == "cpu":
        eng = _lenet()
        CG.reset_counts(CG.STEP_GRAPH)
        for _ in range(2):
            eng.state, aux = eng._step(eng.state)
            assert torch.isfinite(aux["outer_loss"])
        reason = eng._step_graph.ineligible(eng)
        assert CG.STEP_GRAPH == {"captures": 0, "replays": 0, "eager": 2,
                                 "last_eager_reason": reason}
        assert reason.startswith("device cpu")
        assert eng._step_graph.g is None
    else:  # the fused gate refuses sharding before the step is chosen
        eng = _lenet(fused_inner="auto", mesh=make_mesh(), shard_mc=True, mc_samples=2)
        assert eng._step_graph.ineligible(eng).startswith("shard_mc/shard_batch")


def _at_quarter(e):
    e.state = e.state._replace(net_step=(e.N // e.data_minibatch) // 4)


KEY_CHANGES = {
    "new state, same shapes": (dict(), lambda e: e.weight_reset(), False),
    "prune": (dict(), lambda e: e.prune_coreset(6), True),
    "StepLR tick, gamma 0.5": (dict(gamma=0.5, n_per_class=7), _at_quarter, True),
    "StepLR quarter, gamma 1": (dict(n_per_class=7), _at_quarter, False),
    "hyperparameter names": (
        dict(), lambda e: setattr(e, "spec", dataclasses.replace(e.spec, learn_alpha=True)),
        True),
    "S": (dict(), lambda e: setattr(e, "mc_samples", 3), True),
    "T": (dict(), lambda e: setattr(e, "inner_it", 3), True),
    "B": (dict(), lambda e: setattr(e, "data_minibatch", 6), True),
    "rebuilt net": (dict(), lambda e: e._build_model(), True),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_graph_key_follows_what_the_launches_depend_on(change):
    kw, act, moves = KEY_CHANGES[change]
    eng = _lenet(**kw)

    def key():
        cfg, inputs = _inputs(eng)
        return eng._step_graph.graph_key(eng, eng.state, cfg, inputs)

    k0 = key()
    assert key() == k0
    act(eng)
    assert (key() != k0) == moves


# ----------------------------------------------------------------------
# the hyper-Adam's bias corrections


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bias_corrections_from_the_buffer_equal_the_host_scalars(dtype):
    opt = O.adam(1e-3)
    bc = torch.empty((1, 2), dtype=dtype)
    twin = O.adam(**dict(opt.hyper), corrections=bc[0])
    g = torch.Generator().manual_seed(0)
    p = torch.randn(7, 5, generator=g, dtype=dtype)
    host, dev = (p, opt.init(p)), (p, twin.init(p))
    for count in range(50):
        CG.write_corrections(bc, types.SimpleNamespace(opt_u=dev[1]), ["u"], [opt])
        assert dev[1].count == count
        # the host scalars are float32 values, held exactly in either dtype
        assert bc[0].tolist() == list(O.bias_corrections(count + 1, 0.9, 0.999))
        grad = torch.randn(7, 5, generator=g, dtype=dtype)
        host = opt.step(host[0], grad, host[1])
        dev = twin.step(dev[0], grad, dev[1])
        assert dev[1].count == host[1].count == count + 1
        assert torch.equal(dev[0], host[0])
        assert torch.equal(dev[1].mu, host[1].mu) and torch.equal(dev[1].nu, host[1].nu)


# ----------------------------------------------------------------------
# the step against the tree before it


def _parent_step(eng, state, batch=None, eps=None):
    """``_nested_step_fused_lenet`` as it was before its body became a
    graph's (spans left out)."""
    xb, yb = batch if batch is not None else eng._sample_batch()
    cfg = FL.cfg_from_engine(eng)
    didx = eng.net.variational_layers
    if eps is None:
        eps = eng._fused_lenet_eps(cfg.n_eps)
    if isinstance(eps, FlatEps):
        e_in, eps_outer = eps
    else:
        eps_inner, eps_outer = eps
        e_in = torch.stack([FL.pack_eps([e[i] for i in didx]) for e in eps_inner])
    lr_now = eng.lr_net_sched(state.net_step)
    names = eng._hyper_names()
    p0 = FL.pack_params([state.params[i] for i in didx])
    with torch.enable_grad():
        hyper = {k: getattr(state, k).detach().clone().requires_grad_(True) for k in names}
        u = hyper.get("u", state.u)
        v = hyper.get("v", state.v)
        alpha = hyper.get("alpha", state.alpha)
        pT, inner_losses = FL.lenet_unroll(p0, u, v, alpha, state.z, e_in, lr_now, cfg)
        paramsT = list(state.params)
        for i, layer in zip(didx, FL.unpack_params(pT, cfg)):
            paramsT[i] = layer
        loss = eng._outer_loss(tuple(paramsT), eps_outer, u, state.z, v, alpha, xb, yb)
        grads = (dict(zip(names, torch.autograd.grad(loss, list(hyper.values()))))
                 if names else {})
    state = eng._apply_hyper_updates(state, grads)
    state = state._replace(params=tree_map(lambda x: x.detach(), tuple(paramsT)),
                           net_step=state.net_step + 1)
    return state, {"outer_loss": loss.detach(), "inner_losses": inner_losses.detach()}


@pytest.mark.parametrize("fed", [False, True], ids=["drawn", "seam"])
def test_lenet_step_unchanged_from_the_tree_before(fed):
    eng = _lenet(method="psvi_alpha_v")
    assert eng._step.__name__ == "_nested_step_fused_lenet"
    st = eng.state
    for _ in range(3):
        batch, eps = _seam(eng) if fed else (None, None)
        g0 = eng.gen.get_state()
        want = _parent_step(eng, st, batch, eps)
        g1 = eng.gen.get_state()
        eng.gen.set_state(g0)
        got = eng._step(st, batch=batch, eps=eps)
        assert torch.equal(eng.gen.get_state(), g1)
        assert _same(got, want) and got[0].net_step == want[0].net_step
        st = got[0]


@pytest.mark.parametrize("method", ["psvi", "psvi_free_v", "psvi_alpha_v", "psvi_fixed_u"])
def test_graph_plumbing_gives_the_eager_step(method):
    """What a capture and a replay do around the graph, on the CPU: the
    body on the static buffers with the hyper-Adams reading the buffer's
    corrections (written at the capture, then before each replay), and the
    step put together from its outputs."""
    eng = _lenet(method=method)
    G, names, own = eng._step_graph, eng._hyper_names(), None
    st = eng.state
    for _ in range(3):
        cfg, inputs = _inputs(eng)
        want_st, pT, aux = eng._fused_lenet_body(st, cfg, *inputs)
        want = (eng._with_unrolled_net(want_st, pT, cfg), aux)
        static, ins = G.static(eng, (st, cfg, inputs))
        assert not any(x is y for x, y in zip(static, G.leaves(eng, st, cfg, inputs)))
        if own is None:
            own = G.own(eng, st, cfg, inputs)
        else:
            G.before(eng, own, st, cfg, inputs)
        outs = G.body(eng, own, *ins)
        got = G.after(eng, own, [x.clone() for x in outs], st, cfg, inputs)
        assert _same(got, want)
        assert all(getattr(got[0], "opt_" + n).count == getattr(st, "opt_" + n).count + 1
                   for n in names)
        assert got[0].z is st.z and got[0].opt_z is st.opt_z
        assert all(type(getattr(eng, "opt_" + n).hyper) is tuple for n in names)
        st = got[0]


# ----------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _eager_step(eng, state, batch=None, eps=None):
    """The step as it runs off the graph: its draws, then the body with the
    engine's own hyper-Adams."""
    cfg = FL.cfg_from_engine(eng)
    xb, yb = batch if batch is not None else eng._sample_batch()
    if eps is None:
        eps = eng._fused_lenet_eps(cfg.n_eps)
    e_in, eps_outer = _flat_eps(eps, FL.pack_eps, eng.net.variational_layers)
    st, pT, aux = eng._fused_lenet_body(state, cfg, xb, yb, e_in, eps_outer)
    return eng._with_unrolled_net(st, pT, cfg), aux


def _against_eager(eng, state, batch=None, eps=None):
    """The graphed step, then the eager step from the generator state it
    started from: every leaf, the aux and the generator's state after each
    the same, bit for bit. Returns the graphed step."""
    g0 = eng.gen.get_state()
    got = eng._step(state, batch=batch, eps=eps)
    g1 = eng.gen.get_state()
    eng.gen.set_state(g0)
    want = _eager_step(eng, state, batch, eps)
    assert torch.equal(eng.gen.get_state(), g1)
    assert _same(got, want), [k for k, (a, b) in enumerate(zip(tree_leaves(got),
                                                             tree_leaves(want)))
                              if torch.is_tensor(a) and not torch.equal(a, b)]
    return got


def _counts(c, r):
    assert CG.STEP_GRAPH == {"captures": c, "replays": r, "eager": 0,
                             "last_eager_reason": ""}, CG.STEP_GRAPH


@pytest.mark.card
@pytest.mark.parametrize("method", ["psvi_learn_v", "psvi_alpha_v"])
def test_graphed_steps_match_eager_and_stay_put(card, method):
    eng = _lenet(card, method=method)
    CG.reset_counts(CG.STEP_GRAPH)
    st, kept = eng.state, []
    for k in range(14):
        batch, eps = _seam(eng) if k % 3 == 1 else (None, None)
        if k % 3 == 2:  # the flat noise through the seam
            cfg = FL.cfg_from_engine(eng)
            batch, eps = eng._sample_batch(), eng._fused_lenet_eps(cfg.n_eps)
        out = _against_eager(eng, st, batch, eps)
        kept.append((out, [x.clone() for x in _tensors(out)]))
        st = out[0]
    _counts(1, 13)
    for out, copy in kept:  # no later replay touched what a step returned
        assert all(torch.equal(a, b) for a, b in zip(_tensors(out), copy))


@pytest.mark.card
def test_recapture_on_a_steplr_tick_and_a_prune(card):
    eng = _lenet(card, gamma=0.5, n_per_class=7)  # N = 70, B = 8: a tick every 2 steps
    assert (eng.N // eng.data_minibatch) // 4 == 2
    CG.reset_counts(CG.STEP_GRAPH)
    for _ in range(4):
        eng.state = _against_eager(eng, eng.state)[0]
    _counts(2, 2)
    eng.prune_coreset(6)
    for _ in range(2):  # the lr ticks again at net_step 6: the same capture
        eng.state = _against_eager(eng, eng.state)[0]
    _counts(3, 3)


@pytest.mark.card
def test_profiler_names_the_pairs_kernels_in_replays(card):
    from torch.profiler import ProfilerActivity, profile

    eng = _lenet(card)
    for _ in range(2):
        eng.state, _ = eng._step(eng.state)
    CG.reset_counts(CG.STEP_GRAPH)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.state, _ = eng._step(eng.state)
        torch.cuda.synchronize(card)
    _counts(0, 3)
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for kernel in ("k_gemm", "k_conv2_back", "k_conv2_wpart", "k_conv1", "k_ubar_part"):
        assert any(kernel in n for n in names), (kernel, sorted(names)[:40])
