"""The port's k-means, its native build and the submodular selection
against the JAX package's.

- Lloyd from JAX's own k-means++ centroids: the centroids within 1e-5
  relative, the labels equal (separated blobs; no ties in argmin);
- ``KmeansCluster`` (balanced, global, cosine) and ``KmeansOnDevice`` on
  separated blobs with JAX's k-means++ fed: the same members, centers and
  picks;
- the port's native library (its own copy of the C++ source, built with
  g++) against ``psvi_tpu.native``: equal centroids, labels and inertia at
  one seed, bit for bit, and equal nearest indices and distances;
- the submodular similarity matrices within 1e-6 of JAX's (of the largest
  distance for the euclidean one), and every
  function × optimizer on JAX's matrix picks JAX's indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvi_torch import native as PN
from psvi_torch.inference import submodular as PSM
from psvi_torch.ops import kmeans as PK
from psvi_tpu import native as JN
from psvi_tpu.inference import submodular as JSM
from psvi_tpu.ops import kmeans as JK
from torch_jax_tape import feed, record


def blobs(n_per=40, k=4, d=3, seed=0):
    """k well-separated Gaussian blobs, labels alternating over 2 classes by blob."""
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.standard_normal((k, d))
    x = np.concatenate([c + 0.3 * rng.standard_normal((n_per, d)) for c in centers])
    y = np.repeat(np.arange(k) % 2, n_per).astype(np.float32)
    return x.astype(np.float32), y


def test_lloyd_from_jax_seeding_matches_jax():
    x, _ = blobs()
    key = jax.random.PRNGKey(3)
    c0 = np.asarray(JK._kmeans_pp_init(key, jnp.asarray(x), 4))
    jc, jl = JK.kmeans_fit(key, jnp.asarray(x), 4, iters=25)
    pc, pl = PK.kmeans_fit(None, torch.tensor(x), 4, iters=25, init=torch.tensor(c0))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(PK.pairwise_sq_dists(torch.tensor(x), pc).numpy(),
                               np.asarray(JK.pairwise_sq_dists(jnp.asarray(x), jc)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(PK.nearest_index(torch.tensor(x), pc).numpy(),
                                  np.asarray(JK.nearest_index(jnp.asarray(x), jc)))
    np.testing.assert_allclose(PK._l2_normalize(torch.tensor(x)).numpy(),
                               np.asarray(JK._l2_normalize(jnp.asarray(x))), rtol=1e-6)


def test_kmeans_pp_draws_real_points():
    x, _ = blobs()
    c = PK._kmeans_pp_init(torch.Generator().manual_seed(0), torch.tensor(x), 4)
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in c.numpy())
    # one seed in each blob: k-means++ draws far points
    assert len({int(i) // 40 for i in PK.nearest_index(torch.tensor(x), c)}) == 4


@pytest.mark.parametrize("cls,balance,dist", [("KmeansCluster", True, "euclidean"),
                                              ("KmeansCluster", False, "euclidean"),
                                              ("KmeansCluster", True, "cosine"),
                                              ("KmeansOnDevice", True, "euclidean"),
                                              ("KmeansOnDevice", False, "euclidean")])
def test_kmeans_cluster_matches_jax(monkeypatch, cls, balance, dist):
    x, y = blobs(seed=1)
    x = x + 20.0  # cosine: away from the origin
    kw = dict(num_classes=2, balance=balance, seed=4, dist=dist)
    with monkeypatch.context() as mp:
        tape = record(mp)
        jc = getattr(JK, cls)(x, y, **kw)
        jc.set_num_clusters(4)
        jc.run_kmeans()
        jpts = jc.get_arbitrary_pts(6)
    with monkeypatch.context() as mp:
        feed(mp, tape)
        pc = getattr(PK, cls)(x, y, **kw, device="cpu")
        pc.set_num_clusters(4)
        pc.run_kmeans()
        ppts = pc.get_arbitrary_pts(6)
    assert [list(m) for m in pc.cluster_members] == [list(m) for m in jc.cluster_members]
    assert [int(i) for i in ppts] == [int(i) for i in jpts]
    if cls == "KmeansCluster":
        for a, b in zip(pc.cluster_centers, jc.cluster_centers):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert [int(i) for i in pc.cluster_centers] == [int(i) for i in jc.cluster_centers]


def test_arbitrary_pts_shortfall_redistributes():
    """A cluster smaller than its quota: the count asked for is honoured."""
    x, y = blobs(n_per=3)
    c = PK.KmeansCluster(x, y, num_classes=2, seed=0, device="cpu")
    c.set_num_clusters(4)
    c.run_kmeans()
    pts = c.get_arbitrary_pts(11)
    assert len(pts) == len(set(pts)) == 11


def test_native_build_matches_jax_native():
    x, _ = blobs(n_per=60, k=5, d=6, seed=2)
    pc, pl, pi = PN.kmeans_fit(x, 5, iters=20, seed=7)
    jc, jl, ji = JN.kmeans_fit(x, 5, iters=20, seed=7)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pl, jl)
    assert pi == ji
    np.testing.assert_array_equal(PN.nearest_index(x, pc), JN.nearest_index(x, jc))
    np.testing.assert_array_equal(PN.pairwise_sq_dists(x, pc), JN.pairwise_sq_dists(x, jc))
    labels, inertia = PN.assign_labels(x, pc)
    np.testing.assert_array_equal(labels, pl)
    assert inertia == pytest.approx(pi, rel=1e-12)
    # the native backend of KmeansCluster
    y = np.zeros(len(x), np.float32)
    kc = PK.KmeansCluster(x, y, num_classes=1, seed=7, iters=20, backend="native",
                          device="cpu")
    kc.set_num_clusters(5)
    kc.run_kmeans()
    np.testing.assert_array_equal(kc.cluster_centers[0], pc)


def test_backend_and_dist_refused():
    x, y = blobs()
    with pytest.raises(ValueError, match="backend"):
        PK.KmeansCluster(x, y, backend="faiss", device="cpu")
    with pytest.raises(ValueError, match="dist"):
        PK.KmeansCluster(x, y, dist="manhattan", device="cpu")


def test_similarity_matrices_match_jax():
    x, _ = blobs(n_per=10)
    ref = JSM.euclidean_dist_pair(x)
    np.testing.assert_allclose(PSM.euclidean_dist_pair(x, device="cpu"), ref,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(PSM.cossim_pair(x, device="cpu"), JSM.cossim_pair(x), atol=1e-6)


@pytest.mark.parametrize("opt", ["NaiveGreedy", "LazyGreedy", "StochasticGreedy",
                                 "ApproximateLazyGreedy"])
@pytest.mark.parametrize("fn", ["FacilityLocation", "GraphCut", "LogDeterminant"])
def test_submodular_picks_match_jax(fn, opt):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    sim = JSM.cossim_pair(x)
    index = np.arange(100, 130)
    picks = []
    for SM in (JSM, PSM):
        f = getattr(SM, fn)(index=index, similarity_matrix=sim, already_selected=[3])
        o = SM.OPTIMIZERS[opt](index=index, budget=6, already_selected=[3])
        picks.append(list(o.select(gain_function=f.calc_gain, update_state=f.update_state)))
    assert picks[1] == picks[0] and len(picks[1]) == 6 and 103 in picks[1]
