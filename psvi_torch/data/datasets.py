"""Dataset registry for the port.

Counterpart of ``psvi_tpu/data/datasets.py``, every name JAX's
``read_dataset`` and ``get_regression_benchmark`` accept: full datasets
live in host NumPy arrays; the engine moves them to its device once and
draws one minibatch per outer step there.

- Generated: halfmoon, four_blobs, synth_lr_<D>, normal_mvn, synth_mnist,
  synth_mnist_hard, synth_cifar; the regression set sinus.
- Bundled with scikit-learn: digits, digits28 (bilinear 28×28 by scipy's
  ``zoom``), breast_cancer; the regression set diabetes.
- File-gated, from ``data_folder`` (``data_dir`` for regression): MNIST,
  FashionMNIST, Cifar10 (``{name}.npz``), phishing, adult, webspam (a
  ``{name}.npz``, or the raw files adult and webspam are read from), the UCI
  regression sets (``_UCI_FILES``). Each raises ``FileNotFoundError`` when
  its file is absent; nothing is downloaded.

scikit-learn, scipy and pandas are imported inside the readers that need
them, never at module import.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from psvi_torch.data import synthetic

# normalisation and shape stats of the vision sets (ref experiments_utils.py:42-78)
DATASET_NORMALIZATION = {
    "MNIST": ((0.1307,), (0.3081,)),
    "FashionMNIST": ((0.2861,), (0.3530,)),
    "Cifar10": ((0.4914, 0.4822, 0.4465), (0.247, 0.243, 0.261)),
}
DATASET_STATS = {  # channels, side, classes, n_train
    "MNIST": (1, 28, 10, 60000),
    "FashionMNIST": (1, 28, 10, 60000),
    "Cifar10": (3, 32, 10, 50000),
    "synth_mnist": (1, 28, 10, 6000),
    "synth_mnist_hard": (1, 28, 10, 6000),
    "synth_cifar": (3, 32, 10, 6000),
}
VISION_DATASETS = tuple(DATASET_STATS)


@dataclasses.dataclass
class DataBundle:
    x: np.ndarray  # train inputs
    y: np.ndarray  # train targets (float labels, reference convention)
    xt: np.ndarray  # test inputs
    yt: np.ndarray
    N: int
    D: int  # flat feature dim (vision: side*side, as the JAX package)
    nc: int
    channels: int = 0  # >0 for image data (x is (N, C, H, W))
    xv: Optional[np.ndarray] = None  # validation (regression)
    yv: Optional[np.ndarray] = None
    y_mean: float = 0.0  # regression: train-target normalisation
    y_std: float = 1.0
    taus: Tuple[float, ...] = ()  # regression: the tau grid of the dataset


def _split_train_test(X, Y, test_ratio):
    """Split from the end (ref experiments_utils.py:797-804)."""
    Y = np.where(Y == -1, 0, Y)
    test_size = int(test_ratio * X.shape[0])
    return X[:-test_size], Y[:-test_size], X[-test_size:], Y[-test_size:]


def _load_vision_npz(dnm, data_folder):
    """``{data_folder}/{dnm.lower()}.npz`` with keys x_train (N, H, W[, C],
    uint8 or float), y_train, x_test, y_test; None when absent."""
    path = os.path.join(data_folder, f"{dnm.lower()}.npz")
    if not os.path.exists(path):
        return None
    d = np.load(path)
    return d["x_train"], d["y_train"], d["x_test"], d["y_test"]


def _normalize_images(x, dnm, channels):
    """Pixels to [0, 1] when they are counts, channels first, then each
    channel normalised by ``DATASET_NORMALIZATION``."""
    x = x.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    if x.ndim == 3:
        x = x[:, None]  # (N, 1, H, W)
    elif x.ndim == 4 and x.shape[-1] in (1, 3):
        x = np.transpose(x, (0, 3, 1, 2))
    mean, std = DATASET_NORMALIZATION.get(dnm, ((0.0,) * channels, (1.0,) * channels))
    mean = np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    std = np.asarray(std, np.float32).reshape(1, -1, 1, 1)
    return (x - mean) / std


def read_dataset(dnm: str, test_ratio: float = 0.2, data_folder: str = "data",
                 seed: int = 0) -> DataBundle:
    rng = np.random.default_rng(seed)
    if dnm == "halfmoon":
        X, Y = synthetic.make_halfmoon(1000, 0.1, 42)
        nc = 2
    elif dnm == "four_blobs":
        X, Y = synthetic.make_four_class_dataset(250, rng)
        nc = 4
    elif dnm.startswith("synth_lr"):
        X, Y = synthetic.make_synthetic(1000, D=int(dnm.split("_")[-1]), rng=rng)
        nc = 2
    elif dnm == "normal_mvn":
        X, Y = synthetic.make_synthetic_normal(1000)
        nc = 2
    elif dnm in ("phishing", "adult", "webspam"):
        return _read_binary_benchmark(dnm, data_folder, test_ratio)
    elif dnm in ("digits", "digits28", "breast_cancer"):
        return _read_sklearn_real(dnm, test_ratio, rng)
    elif dnm in VISION_DATASETS:
        return _read_vision(dnm, data_folder, rng)
    else:
        raise ValueError(f"unknown dataset {dnm!r}")
    x, y, xt, yt = _split_train_test(X, Y, test_ratio)
    N, D = x.shape
    return DataBundle(x, y, xt, yt, N, D, nc)


def _read_vision(dnm, data_folder, rng):
    channels, side, nc, n_train = DATASET_STATS[dnm]
    if dnm == "synth_mnist_hard":
        # Bayes ceiling near 0.90 at the defaults (nearest_template_accuracy)
        x, y, xt, yt, _ = synthetic.make_synth_images_hard(
            n_per_class=n_train // nc, nc=nc, side=side, channels=channels, rng=rng)
    elif dnm.startswith("synth_"):
        x, y, xt, yt = synthetic.make_synth_images(
            n_per_class=n_train // nc, nc=nc, side=side, channels=channels, rng=rng)
    else:
        loaded = _load_vision_npz(dnm, data_folder)
        if loaded is None:
            raise FileNotFoundError(
                f"{dnm} requires {data_folder}/{dnm.lower()}.npz "
                "(keys x_train,y_train,x_test,y_test); network download is "
                "unavailable in this environment. Use 'synth_mnist' / "
                "'synth_cifar' for a shape-compatible synthetic stand-in.")
        x, y, xt, yt = loaded
        x = _normalize_images(x, dnm, channels)
        xt = _normalize_images(xt, dnm, channels)
        y, yt = y.astype(np.float32), yt.astype(np.float32)
    return DataBundle(x, y, xt, yt, len(x), side * side, nc, channels=channels)


def _read_sklearn_real(dnm, test_ratio, rng):
    """Real datasets bundled with scikit-learn: the UCI handwritten digits
    (1797 8×8 images, 10 classes; ``digits`` flat 64-d, ``digits28``
    bilinearly upsampled to (1, 28, 28) for LeNet) and the Wisconsin
    breast-cancer binary set (569×30). A seeded shuffle, then the split
    from the end; digits normalised by the whole set's mean and sd, breast
    cancer standardised by the train split's."""
    from sklearn.datasets import load_breast_cancer, load_digits

    if dnm.startswith("digits"):
        d = load_digits()
        X = d.images.astype(np.float32) / 16.0  # pixel counts 0..16
        Y = d.target.astype(np.float32)
        perm = rng.permutation(len(X))
        X, Y = X[perm], Y[perm]
        if dnm == "digits28":
            from scipy.ndimage import zoom

            X = zoom(X, (1, 3.5, 3.5), order=1)  # 8×8 → 28×28 bilinear
        mean, std = float(X.mean()), float(X.std())
        X = (X - mean) / std
        side = X.shape[-1]
        test_size = int(test_ratio * len(X))
        x, xt = X[:-test_size], X[-test_size:]
        y, yt = Y[:-test_size], Y[-test_size:]
        if dnm == "digits28":
            return DataBundle(x[:, None], y, xt[:, None], yt, len(x), side * side, 10,
                              channels=1)
        return DataBundle(x.reshape(len(x), -1), y, xt.reshape(len(xt), -1), yt, len(x),
                          side * side, 10)
    d = load_breast_cancer()
    X = d.data.astype(np.float32)
    Y = d.target.astype(np.float32)
    perm = rng.permutation(len(X))
    X, Y = X[perm], Y[perm]
    x, y, xt, yt = _split_train_test(X, Y, test_ratio)
    mu, sd = x.mean(0), x.std(0)
    sd = np.where(sd == 0, 1.0, sd)
    x, xt = (x - mu) / sd, (xt - mu) / sd
    return DataBundle(x.astype(np.float32), y, xt.astype(np.float32), yt, len(x),
                      X.shape[1], 2)


def _read_binary_benchmark(dnm, data_folder, test_ratio):
    """phishing, adult and webspam: a preprocessed ``{dnm}.npz`` (keys X, y
    and optionally Xt, yt; labels −1 become 0), else adult's and webspam's
    raw files (``_read_adult_raw``, ``_read_webspam_raw``)."""
    path = os.path.join(data_folder, f"{dnm}.npz")
    if os.path.exists(path):
        d = np.load(path)
        if "Xt" in d:
            x, y, xt, yt = d["X"], d["y"], d["Xt"], d["yt"]
            y, yt = np.where(y == -1, 0, y), np.where(yt == -1, 0, yt)
        else:
            x, y, xt, yt = _split_train_test(d["X"], d["y"], test_ratio)
    elif dnm == "adult":
        x, y, xt, yt = _read_adult_raw(data_folder)
    elif dnm == "webspam":
        x, y, xt, yt = _read_webspam_raw(data_folder)
    else:
        raise FileNotFoundError(
            f"{dnm} requires {path} (keys X, y [, Xt, yt]) or the raw files "
            "the reference downloads at run time (unavailable here: zero "
            "network egress).")
    N, D = x.shape
    return DataBundle(np.asarray(x, np.float32), np.asarray(y, np.float32),
                      np.asarray(xt, np.float32), np.asarray(yt, np.float32), N, D, 2)


def _read_adult_raw(data_folder):
    """Adult's UCI files (ref experiments_utils.py:447-525): numeric columns
    standardised, categorical ones one-hot, PCA to 10 dims, a bias column."""
    train_path = os.path.join(data_folder, "adult.data")
    test_path = os.path.join(data_folder, "adult.test")
    if not (os.path.exists(train_path) and os.path.exists(test_path)):
        raise FileNotFoundError(f"adult requires {train_path} and {test_path} (UCI raw files).")
    import pandas as pd
    from sklearn.decomposition import PCA
    from sklearn.preprocessing import OneHotEncoder, StandardScaler

    columns = ["age", "workClass", "fnlwgt", "education", "education-num", "marital-status",
               "occupation", "relationship", "race", "sex", "capital-gain", "capital-loss",
               "hours-per-week", "native-country", "income"]

    def read(p, skip):
        return pd.read_csv(p, names=columns, sep=r" *, *", na_values="?", engine="python",
                           skiprows=skip).dropna()

    X, Xt = read(train_path, 0), read(test_path, 1)
    Y = np.array([0 if s == "<=50K" else 1 for s in X["income"]])
    Yt = np.array([0 if s == "<=50K." else 1 for s in Xt["income"]])
    numcols = ["age", "education-num", "capital-gain", "capital-loss", "hours-per-week"]
    catcols = ["workClass", "marital-status", "occupation", "relationship", "race", "sex",
               "native-country"]
    ss = StandardScaler().fit(X[numcols])
    enc = OneHotEncoder().fit(X[catcols])
    Xn = np.concatenate([ss.transform(X[numcols]), enc.transform(X[catcols]).toarray()], axis=1)
    Xtn = np.concatenate([ss.transform(Xt[numcols]), enc.transform(Xt[catcols]).toarray()],
                         axis=1)
    pca = PCA(n_components=10).fit(Xn)
    Xn, Xtn = pca.transform(Xn), pca.transform(Xtn)
    return np.c_[Xn, np.ones(len(Xn))], Y, np.c_[Xtn, np.ones(len(Xtn))], Yt


def _read_webspam_raw(data_folder):
    """Webspam's svmlight files (ref :544-662): max-abs scaling to [−1, 1],
    an offset feature, labels to {0, 1}."""
    ftr = os.path.join(data_folder, "webspam_train.svm")
    fte = os.path.join(data_folder, "webspam_test.svm")
    if not (os.path.exists(ftr) and os.path.exists(fte)):
        raise FileNotFoundError(f"webspam requires {ftr} and {fte}.")
    import sklearn.datasets as skl_ds
    from sklearn.preprocessing import MaxAbsScaler

    Xtr, ytr = skl_ds.load_svmlight_file(ftr)
    Xte, yte = skl_ds.load_svmlight_file(fte, n_features=Xtr.shape[1])
    scaler = MaxAbsScaler().fit(Xtr)
    Xtr, Xte = scaler.transform(Xtr).toarray(), scaler.transform(Xte).toarray()
    Xtr, Xte = np.c_[Xtr, np.ones(len(ytr))], np.c_[Xte, np.ones(len(yte))]
    return Xtr, np.where(ytr <= 0, 0, 1), Xte, np.where(yte <= 0, 0, 1)


def hyperparams_for_regression():
    """Tau grid-search space (ref experiments_utils.py:271-296)."""
    return {
        "concrete": [0.025, 0.05, 0.075],
        "energy": [0.25, 0.5, 0.75],
        "power": [0.05, 0.1, 0.15],
        "kin8nm": [150, 200, 250],
        "protein": [0.025, 0.05, 0.075],
        "naval": [30000, 40000, 50000],
        "yacht": [0.25, 0.5, 0.75],
        "boston": [0.1, 0.15, 0.2],
        "wine": [2.5, 3.0, 3.5],
        "year": [0.1, 1.0, 10.0],
        "sinus": [0.1, 1.0, 10.0],
        # the JAX package's grid for scikit-learn's diabetes set (no
        # reference grid exists)
        "diabetes": [1e-3, 2e-3, 4e-3],
    }


_UCI_FILES = {
    "concrete": "Concrete_Data.xls",
    "energy": "ENB2012_data.xlsx",
    "power": "CCPP/Folds5x2_pp.xlsx",
    "kin8nm": "dataset_2175_kin8nm.arff",
    "protein": "CASP.csv",
    "naval": "UCI CBM Dataset/data.txt",
    "yacht": "yacht_hydrodynamics.data",
    "boston": "housing.data",
    "wine": "winequality-red.csv",
    "year": "YearPredictionMSD.txt",
}


def get_regression_benchmark(name, seed=111, data_dir="data/", **split_kwargs):
    """(X, Y), splits (ref experiments_utils.py:217-268): ``sinus``
    generated, ``diabetes`` from scikit-learn (442×10), the UCI sets from
    ``data_dir`` (``_UCI_FILES``; ``FileNotFoundError`` when absent). The
    targets are the last column, or for energy and naval the second last."""
    rng = np.random.default_rng(seed)
    if name == "sinus":
        X, Y = synthetic.make_sinus(1000, rng)
        data = np.concatenate([X, Y], axis=-1)
    elif name == "diabetes":
        from sklearn.datasets import load_diabetes

        d = load_diabetes()
        data = np.concatenate([d.data, d.target[:, None]], axis=-1).astype(np.float64)
    else:
        fname = os.path.join(data_dir, _UCI_FILES.get(name, ""))
        if not os.path.exists(fname):
            raise FileNotFoundError(f"regression benchmark {name!r} requires {fname}; "
                                    "downloads are unavailable in this environment.")
        data = _parse_uci(name, fname)
    if name in ("energy", "naval"):
        X, Y = data[:, :-2], data[:, -2:-1]
    else:
        X, Y = data[:, :-1], data[:, -1:]
    return (X, Y), split_data(len(X), seed=seed, **split_kwargs)


def _parse_uci(name, fname):
    """A UCI file as one array: spreadsheets and CSVs through pandas,
    whitespace-separated text through NumPy."""
    if name in ("concrete", "energy", "power", "protein", "wine"):
        import pandas as pd

        if name == "protein":
            return np.array(pd.read_csv(fname))
        if name == "wine":
            return np.array(pd.read_csv(fname, delimiter=";"))
        return np.array(pd.read_excel(fname))
    return np.loadtxt(fname)


def split_data(N, p_split=(0.6, 0.2, 0.2), n_split=None, shuffle=True, seed=None):
    """Train/val/test index splitter (ref experiments_utils.py:107-141)."""
    rng = np.random.default_rng(seed)
    if n_split is None:
        p_split = np.array(p_split, dtype=np.float64)
        assert np.sum(p_split == -1) <= 1
        p_split[p_split == -1] = 1 - (np.sum(p_split) + 1)
        train_idx = int(np.ceil(p_split[0] * N))
        val_idx = int(np.ceil(train_idx + p_split[1] * N))
    else:
        n_split = np.array(n_split)
        assert np.sum(n_split == -1) <= 1
        n_split[n_split == -1] = N - (np.sum(n_split) + 1)
        train_idx = int(n_split[0])
        val_idx = int(train_idx + n_split[1])
    idx = np.arange(N)
    if shuffle:
        rng.shuffle(idx)
    return {"train": idx[:train_idx], "val": idx[train_idx:val_idx],
            "test": idx[val_idx:]}


def read_regression_dataset(dnm, seed=0, num_test=100, data_dir="data/"):
    """Normalized regression bundle (ref experiments_utils.py:159-214):
    ``num_test`` points for test, 10 % for validation, the rest for
    training; inputs and train targets normalised by the train split's
    statistics, test and validation targets left raw."""
    (X, Y), _ = get_regression_benchmark(dnm, seed=seed, data_dir=data_dir, n_split=(0, 0, 0),
                                         shuffle=False)
    N_total = len(X)
    n_val = int(np.ceil(0.1 * N_total))
    n_te = int(num_test) if num_test >= 1 else int(np.ceil(num_test * N_total))
    idx = split_data(N_total, n_split=(N_total - n_val - n_te, n_val, n_te), seed=seed)
    taus = hyperparams_for_regression()[dnm]
    x, y = X[idx["train"]], Y[idx["train"]]
    xv, yv = X[idx["val"]], Y[idx["val"]]
    xt, yt = X[idx["test"]], Y[idx["test"]]
    x_mean, x_std = np.mean(x, 0), np.std(x, 0)
    y_mean, y_std = np.mean(y), np.std(y)
    x_std = np.where(x_std == 0, 1.0, x_std)

    def norm(a):
        return ((a - x_mean) / x_std).astype(np.float32)

    return DataBundle(
        x=norm(x), y=((y - y_mean) / y_std).astype(np.float32),
        xt=norm(xt), yt=yt.astype(np.float32),
        xv=norm(xv), yv=yv.astype(np.float32),
        N=len(x), D=x.shape[1], nc=1,
        y_mean=float(y_mean), y_std=float(y_std), taus=tuple(taus),
    )
