"""The port's data readers against the JAX package's.

- The generated sets (normal_mvn, synth_mnist_hard, synth_cifar) and
  scikit-learn's bundled ones (digits, digits28, breast_cancer; the
  regression set diabetes) give JAX's arrays bit for bit at seeds 0 and 1,
  and the generators themselves (``make_synthetic_normal``,
  ``make_synth_images_hard``, ``nearest_template_accuracy``) at small sizes.
- Each file-gated reader raises ``FileNotFoundError`` with JAX's message
  when its file is absent, and reads a small file of the right layout,
  written to ``tmp_path``, as JAX's reader reads it: the vision npz files
  (MNIST, FashionMNIST, Cifar10; uint8 pixels, channels last), the binary
  benchmarks' npz files (with and without a test split), adult's and
  webspam's raw files, and every UCI regression file. No Excel writer is
  installed here, so for the spreadsheet sets (concrete, energy, power) both
  packages' ``pandas.read_excel`` reads a CSV written under the
  spreadsheet's name.
"""

import os

import numpy as np
import pytest

from psvi_torch.data import datasets as TD
from psvi_torch.data import synthetic as TS
from psvi_tpu.data import datasets as JD
from psvi_tpu.data import synthetic as JS

BUNDLE_KEYS = ("x", "y", "xt", "yt", "xv", "yv")


def _same_bundle(a, b):
    for k in BUNDLE_KEYS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k
    for k in ("N", "D", "nc", "channels", "y_mean", "y_std", "taus"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["normal_mvn", "synth_mnist_hard", "synth_cifar", "digits",
                                  "digits28", "breast_cancer"])
def test_generated_and_sklearn_readers_match_jax_bitwise(name, seed):
    _same_bundle(TD.read_dataset(name, seed=seed), JD.read_dataset(name, seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_diabetes_matches_jax_bitwise(seed):
    _same_bundle(TD.read_regression_dataset("diabetes", seed=seed),
                 JD.read_regression_dataset("diabetes", seed=seed))
    (X, Y), split = TD.get_regression_benchmark("diabetes", seed=seed)
    (JX, JY), jsplit = JD.get_regression_benchmark("diabetes", seed=seed)
    assert np.array_equal(X, JX) and np.array_equal(Y, JY)
    assert all(np.array_equal(split[k], jsplit[k]) for k in jsplit)


def test_generators_match_jax_bitwise():
    a = TS.make_synthetic_normal(50, np.random.default_rng(3))
    b = JS.make_synthetic_normal(50, np.random.default_rng(3))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    kw = dict(n_per_class=6, n_test_per_class=3, nc=4, side=12, channels=2, sep=0.7,
              noise_sd=0.5, max_shift=1, label_noise=0.2)
    a = TS.make_synth_images_hard(**kw, rng=np.random.default_rng(5))
    b = JS.make_synth_images_hard(**kw, rng=np.random.default_rng(5))
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    x, y, _, _, templates = a
    assert TS.nearest_template_accuracy(x, y, templates, max_shift=1, batch=7) == \
        JS.nearest_template_accuracy(x, y, templates, max_shift=1, batch=7)


def _raises_like_jax(fn_t, fn_j):
    with pytest.raises(FileNotFoundError) as et:
        fn_t()
    with pytest.raises(FileNotFoundError) as ej:
        fn_j()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "Cifar10"])
def test_vision_npz(name, tmp_path):
    folder = str(tmp_path)
    _raises_like_jax(lambda: TD.read_dataset(name, data_folder=folder),
                     lambda: JD.read_dataset(name, data_folder=folder))
    rng = np.random.default_rng(0)
    side, ch = (32, 3) if name == "Cifar10" else (28, None)
    shape = (lambda n: (n, side, side, ch)) if ch else (lambda n: (n, side, side))
    np.savez(os.path.join(folder, f"{name.lower()}.npz"),
             x_train=rng.integers(0, 256, shape(12), dtype=np.uint8),
             y_train=rng.integers(0, 10, 12), x_test=rng.integers(0, 256, shape(5), dtype=np.uint8),
             y_test=rng.integers(0, 10, 5))
    a = TD.read_dataset(name, data_folder=folder)
    _same_bundle(a, JD.read_dataset(name, data_folder=folder))
    assert a.x.shape == (12, ch or 1, side, side)


@pytest.mark.parametrize("name,split", [("phishing", False), ("adult", True),
                                        ("webspam", False)])
def test_binary_benchmark_npz(name, split, tmp_path):
    folder = str(tmp_path)
    if name == "phishing":  # adult and webspam look for their raw files first
        _raises_like_jax(lambda: TD.read_dataset(name, data_folder=folder),
                         lambda: JD.read_dataset(name, data_folder=folder))
    rng = np.random.default_rng(1)
    arrays = dict(X=rng.standard_normal((20, 4)), y=rng.choice([-1.0, 1.0], 20))
    if split:
        arrays.update(Xt=rng.standard_normal((6, 4)), yt=rng.choice([-1.0, 1.0], 6))
    np.savez(os.path.join(folder, f"{name}.npz"), **arrays)
    _same_bundle(TD.read_dataset(name, data_folder=folder),
                 JD.read_dataset(name, data_folder=folder))


_ADULT_CATS = {
    "workClass": ["Private", "State-gov", "Self-emp-not-inc"],
    "education": ["Bachelors", "HS-grad", "Masters"],
    "marital-status": ["Never-married", "Divorced", "Married-civ-spouse"],
    "occupation": ["Sales", "Tech-support", "Exec-managerial", "Craft-repair"],
    "relationship": ["Husband", "Not-in-family", "Own-child"],
    "race": ["White", "Black", "Asian-Pac-Islander"],
    "sex": ["Male", "Female"],
    "native-country": ["United-States", "Mexico", "India"],
}


def _adult_rows(rng, n, dot):
    rows = []
    for i in range(n):
        c = {k: v[i % len(v)] if i < 12 else v[rng.integers(len(v))]
             for k, v in _ADULT_CATS.items()}
        if i == 5:
            c["occupation"] = "?"  # a missing value: the row is dropped
        income = (">50K" if rng.random() < 0.4 else "<=50K") + dot
        rows.append(", ".join(str(x) for x in (
            rng.integers(17, 80), c["workClass"], rng.integers(10000, 400000), c["education"],
            rng.integers(1, 16), c["marital-status"], c["occupation"], c["relationship"],
            c["race"], c["sex"], rng.integers(0, 5000), rng.integers(0, 300),
            rng.integers(10, 60), c["native-country"], income)))
    return "\n".join(rows) + "\n"


def test_adult_and_webspam_raw(tmp_path):
    folder = str(tmp_path)
    for name in ("adult", "webspam"):
        _raises_like_jax(lambda: TD.read_dataset(name, data_folder=folder),
                         lambda: JD.read_dataset(name, data_folder=folder))
    rng = np.random.default_rng(2)
    (tmp_path / "adult.data").write_text(_adult_rows(rng, 40, ""))
    (tmp_path / "adult.test").write_text("|1x3 Cross validator\n" + _adult_rows(rng, 15, "."))
    a = TD.read_dataset("adult", data_folder=folder)
    _same_bundle(a, JD.read_dataset("adult", data_folder=folder))
    assert a.D == 11 and a.N == 39
    from sklearn.datasets import dump_svmlight_file

    X = rng.standard_normal((30, 7)) * (rng.random((30, 7)) < 0.5)
    dump_svmlight_file(X[:20], rng.choice([-1, 1], 20), str(tmp_path / "webspam_train.svm"))
    dump_svmlight_file(X[20:], rng.choice([-1, 1], 10), str(tmp_path / "webspam_test.svm"))
    _same_bundle(TD.read_dataset("webspam", data_folder=folder),
                 JD.read_dataset("webspam", data_folder=folder))


def _uci_text(name, data):
    """``data`` in the layout ``_parse_uci`` reads for ``name``."""
    if name in ("protein", "concrete", "energy", "power"):
        header = ",".join(f"c{i}" for i in range(data.shape[1]))
        return header + "\n" + "\n".join(",".join(repr(float(v)) for v in r) for r in data) + "\n"
    if name == "wine":
        header = ";".join(f"c{i}" for i in range(data.shape[1]))
        return header + "\n" + "\n".join(";".join(repr(float(v)) for v in r) for r in data) + "\n"
    return "\n".join(" ".join(repr(float(v)) for v in r) for r in data) + "\n"


@pytest.mark.parametrize("name", sorted(JD._UCI_FILES))
def test_uci_regression_files(name, tmp_path, monkeypatch):
    assert TD._UCI_FILES == JD._UCI_FILES
    folder = str(tmp_path) + "/"
    _raises_like_jax(lambda: TD.read_regression_dataset(name, data_dir=folder),
                     lambda: JD.read_regression_dataset(name, data_dir=folder))
    data = np.round(np.random.default_rng(3).standard_normal((40, 6)), 4)
    path = tmp_path / JD._UCI_FILES[name]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_uci_text(name, data))
    import pandas as pd

    monkeypatch.setattr(pd, "read_excel", pd.read_csv)  # no Excel writer here
    a = TD.read_regression_dataset(name, data_dir=folder, num_test=8)
    _same_bundle(a, JD.read_regression_dataset(name, data_dir=folder, num_test=8))
    assert a.D == (4 if name in ("energy", "naval") else 5)
