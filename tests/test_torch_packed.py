"""The packed flat-parameter nets (``psvi_torch/models/packed.py``) against
the unpacked nets and the JAX package.

- ``init`` bitwise the unpacked net's from the same generator; ``apply``
  bitwise the unpacked net's on the same noise (packed by ``pack_eps``);
  KL and NKL within 1e-5 of it; the ``count_kl`` mask (LeNet's convs out);
  ``unpack``/``unpack_eps`` invert the packing; ``pack_net`` refuses what
  it cannot pack, and so does the engine.
- The port's packed forward, KL and NKL against JAX's ``PackedMeanField``
  on JAX's parameters and flat ε.
- A packed nested step on JAX's flat ε against JAX's packed step, the JAX
  state carried across by ``state_from_jax``.
- Packed engines under the lifecycle: a pruned and an incremental run, a
  checkpoint resume bit for bit, and a scoring run (embeddings through
  ``unpack``) with the grid predictions.
"""

import torch_threads  # noqa: F401  (torch on this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from psvi_torch.data import read_dataset
from psvi_torch.inference import psvi as TP
from psvi_torch.inference.psvi import PSVI
from psvi_torch.models import layers as TL
from psvi_torch.models.networks import make_fcnet, make_lenet
from psvi_torch.models.packed import PackedMeanField, pack_net
from psvi_torch.utils.convert import params_from_jax, state_from_jax
from psvi_tpu.data import read_dataset as jax_read_dataset
from psvi_tpu.inference.psvi import PSVI as JPSVI
from psvi_tpu.models import networks as JN
from psvi_tpu.models.packed import pack_net as jax_pack_net
from test_torch_engine import KW, _capture_hypergrads, _cos, _jax_nested_step, _np_tree

S = 3
NETS = {
    "fn": (lambda: make_fcnet(2, 6, 3, n_layers=2, init_sd=0.05, prior_sd=0.8), (7, 2),
           lambda: JN.make_fcnet(2, 6, 3, n_layers=2, init_sd=0.05, prior_sd=0.8)),
    "lenet": (lambda: make_lenet(init_sd=0.05), (4, 1, 28, 28),
              lambda: JN.make_lenet(init_sd=0.05)),
}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", sorted(NETS))
def test_packed_matches_unpacked(name):
    make, xshape, _ = NETS[name]
    net = make()
    packed = pack_net(net)
    assert isinstance(packed, PackedMeanField)
    params, flat = net.init(_gen(0)), packed.init(_gen(0))
    assert torch.equal(flat["mu"], torch.cat([params[s.layer_idx]["mu_" + s.key].reshape(-1)
                                              for s in packed.segments]))
    # unpack inverts the packing, bit for bit
    for a, b in zip(packed.unpack(flat), params):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    eps = net.sample_eps(_gen(1), S)
    e_flat = packed.pack_eps(eps)
    assert e_flat.shape == (S, packed.num_params)
    for a, b in zip(packed.unpack_eps(e_flat), eps):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    x = torch.randn(xshape, generator=_gen(2))
    assert torch.equal(packed.apply(flat, e_flat, x), net.apply(params, eps, x))
    torch.testing.assert_close(packed.kl(flat), net.kl(params), rtol=1e-5, atol=0)
    torch.testing.assert_close(packed.nkl(flat, e_flat), net.nkl(params, eps), rtol=1e-5, atol=0)
    # the KL mask: dense layers count, convs (count_kl=False) do not
    for s in packed.segments:
        seg = packed.kl_mask[s.offset:s.offset + s.size]
        assert bool((seg == float(net.layers[s.layer_idx].count_kl)).all())
    if name == "lenet":
        assert not all(bool(s.count_kl) for s in packed.segments)


@pytest.mark.parametrize("name", sorted(NETS))
def test_packed_forward_kl_nkl_match_jax(name):
    _, xshape, jmake = NETS[name]
    jpacked = jax_pack_net(jmake())
    packed = pack_net(NETS[name][0]())
    jp = _np_tree(jpacked.init(jax.random.PRNGKey(0)))
    je = np.asarray(jpacked.sample_eps(jax.random.PRNGKey(1), S))
    x = np.random.default_rng(2).standard_normal(xshape).astype(np.float32)
    tp, te = params_from_jax(jp, device="cpu"), torch.tensor(je)
    np.testing.assert_allclose(packed.apply(tp, te, torch.tensor(x)).numpy(),
                               np.asarray(jpacked.apply(jp, je, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(packed.kl(tp)), float(jpacked.kl(jp)), rtol=1e-5)
    np.testing.assert_allclose(packed.nkl(tp, te).numpy(), np.asarray(jpacked.nkl(jp, je)),
                               rtol=1e-5)


class _Scale(TL.Layer):
    """A parameterized layer that is not variational: not packable."""

    def init(self, generator):
        return {"g": torch.ones(2)}

    def apply(self, params, eps, x):
        return x * params["g"]


def test_pack_net_refuses_and_engine_raises(monkeypatch):
    assert pack_net(TL.Sequential([TL.ReLU()])) is None  # nothing to pack
    assert pack_net(TL.Sequential([TL.VILinear(2, 2), _Scale()])) is None
    assert pack_net(pack_net(make_fcnet(2, 4, 2))) is None  # not a Sequential
    monkeypatch.setattr(TP, "set_up_model",
                        lambda *a, **k: TL.Sequential([TL.VILinear(2, 2), _Scale()]))
    with pytest.raises(ValueError, match="packed=True unsupported"):
        PSVI(read_dataset("halfmoon"), packed=True, device="cpu", **KW)


def test_packed_nested_step_matches_jax():
    kw = dict(method="psvi_alpha_v", architecture="fn", packed=True, **KW)
    jeng = JPSVI(jax_read_dataset("four_blobs"), fused_inner=False, **kw)
    key = jax.random.PRNGKey(3)
    k_batch, k_inner, k_outer = jax.random.split(key, 3)
    xb, yb = jeng._sample_batch(k_batch)
    keys = jax.random.split(k_inner, jeng.inner_it)
    eps = ([torch.tensor(np.asarray(jeng._sample_eps(k, jeng.mc_samples))) for k in keys],
           torch.tensor(np.asarray(jeng._sample_eps(k_outer, jeng.mc_samples))))
    assert eps[1].dim() == 2  # JAX's one flat draw
    jstate0 = _np_tree(jeng.state)
    jstate1, jaux, jgrads = _jax_nested_step(jeng, key, (xb, yb))
    peng = PSVI(read_dataset("four_blobs"), device="cpu", **kw)
    assert isinstance(peng.net, PackedMeanField) and peng._step.__name__ == "_nested_step"
    pgrads = _capture_hypergrads(peng)
    s0 = state_from_jax(jstate0, device="cpu")
    assert set(s0.params) == {"mu", "rho"}
    s1, aux = peng._nested_step(s0, batch=(torch.tensor(np.asarray(xb)),
                                           torch.tensor(np.asarray(yb))), eps=eps)
    assert set(pgrads) == set(jgrads) == {"u", "v", "alpha"}
    for k in ("u", "v"):
        assert _cos(pgrads[k], jgrads[k]) > 0.9999, k
        assert np.abs(pgrads[k] - jgrads[k]).max() <= 1e-3 * np.abs(jgrads[k]).max(), k
    np.testing.assert_allclose(pgrads["alpha"], jgrads["alpha"], rtol=0.05)
    np.testing.assert_allclose(float(aux["outer_loss"]), float(jaux["outer_loss"]), rtol=1e-5)
    np.testing.assert_allclose(aux["inner_losses"].numpy(), np.asarray(jaux["inner_losses"]),
                               rtol=2e-5)
    np.testing.assert_allclose(s1.u.numpy(), np.asarray(jstate1.u), atol=1e-6)
    np.testing.assert_allclose(s1.v.numpy(), np.asarray(jstate1.v), atol=1e-5)
    for k in ("mu", "rho"):
        np.testing.assert_allclose(s1.params[k].numpy(), np.asarray(jstate1.params[k]),
                                   rtol=2e-4, atol=1e-6)


def _packed_engine(**kw):
    return PSVI(read_dataset("four_blobs"), method="psvi_learn_v", architecture="fn",
                num_pseudo=12, mc_samples=3, inner_it=2, data_minibatch=32, log_every=5,
                packed=True, device="cpu", **kw)


def test_packed_engine_prune_and_increment():
    eng = _packed_engine(num_epochs=8, prune=True, prune_interval=4, prune_sizes=(6,))
    res = eng.run_psvi()
    assert res["csizes"] == [12, 6] and tuple(eng.state.u.shape) == (6, 2)
    assert isinstance(eng.net, PackedMeanField) and all(np.isfinite(res["accs"]))
    inc = _packed_engine(num_epochs=7, increment=True, increment_sizes=(6, 9),
                         increment_interval=3)
    res = inc.run_psvi()
    assert isinstance(inc.net, PackedMeanField) and inc.nc == 3
    assert tuple(inc.state.u.shape) == (9, 2) and all(np.isfinite(res["accs"]))
    assert inc.state.params["mu"].shape == (inc.net.num_params,)


def test_packed_engine_checkpoint_and_scoring(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    a = _packed_engine(num_epochs=3)
    a.run_psvi()
    a.save_checkpoint(path)
    a.num_epochs = 2
    a.run_psvi()
    b = _packed_engine(num_epochs=2)
    b.load_checkpoint(path)
    b.run_psvi()
    for k in ("mu", "rho"):
        assert torch.equal(a.state.params[k], b.state.params[k])
    assert torch.equal(a.state.u, b.state.u)
    sc = _packed_engine(num_epochs=2, scoring_run=True, log_pseudodata=True,
                        data_folder=str(tmp_path), dnm="blobs")
    res = sc.run_psvi()
    emb = np.loadtxt(tmp_path / "embedding_blobs_0.csv", delimiter=",")
    assert emb.shape == (sc.n_train_now, sc.n_hidden)
    assert res["grid_preds"][0].shape == (4, 250 * 250)
