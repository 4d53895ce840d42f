"""Native (C++) host-side k-means and nearest-neighbour search via ctypes.

Counterpart of ``psvi_tpu/native/__init__.py``, with its own copy of the
source (``kmeans.cpp``): k-means++/Lloyd clustering, exact nearest-neighbour
search, pairwise distances, OpenMP over rows. Built with g++ at first use
into ``_build/`` beside this file (listed in ``.gitignore``), keyed by the
source's content, the machine and the compiler's version, and loaded with
ctypes. A failed build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kmeans.cpp")
_BUILD = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_lib = None


def _so_path():
    """The library's path, keyed by the source's content, the machine (a
    ``-march=native`` binary must not load on another CPU) and g++'s
    version."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(os.uname().machine.encode())
    h.update(subprocess.run(["g++", "-dumpversion"], capture_output=True, check=True).stdout)
    return os.path.join(_BUILD, f"libpsvi_native-{h.hexdigest()[:16]}.so")


def _build(so):
    # compile to a temporary file and rename it (atomic): a concurrent
    # process never loads a half-written library
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
           _SRC, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
    os.replace(tmp, so)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        f32p, i32p, i64p = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32,
                                                       ctypes.c_int64))
        i64 = ctypes.c_int64
        lib.kmeans_fit.restype = ctypes.c_double
        lib.kmeans_fit.argtypes = [f32p, i64, i64, i64, ctypes.c_int32, ctypes.c_uint64,
                                   f32p, i32p]
        lib.assign_labels.restype = ctypes.c_double
        lib.assign_labels.argtypes = [f32p, i64, i64, f32p, i64, i32p]
        lib.nearest_index.restype = None
        lib.nearest_index.argtypes = [f32p, i64, i64, f32p, i64, i64p]
        lib.pairwise_sq_dists.restype = None
        lib.pairwise_sq_dists.argtypes = [f32p, i64, f32p, i64, i64, f32p]
        _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def kmeans_fit(X: np.ndarray, k: int, iters: int = 25, seed: int = 0):
    """k-means++ + Lloyd. Returns (centroids (k, d), labels (n,), inertia)."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    n, d = X.shape
    C = np.zeros((k, d), np.float32)
    labels = np.zeros(n, np.int32)
    inertia = lib.kmeans_fit(_fptr(X), n, d, k, iters, seed, _fptr(C),
                             labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return C, labels, inertia


def assign_labels(X: np.ndarray, C: np.ndarray):
    """The nearest centroid of each row of X, and the inertia."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    C = np.ascontiguousarray(C, np.float32)
    labels = np.zeros(len(X), np.int32)
    inertia = lib.assign_labels(_fptr(X), X.shape[0], X.shape[1], _fptr(C), C.shape[0],
                                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, inertia


def nearest_index(X: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Index of the nearest row of X for each row of C."""
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    C = np.ascontiguousarray(C, np.float32)
    out = np.zeros(len(C), np.int64)
    lib.nearest_index(_fptr(X), X.shape[0], X.shape[1], _fptr(C), C.shape[0],
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def pairwise_sq_dists(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    lib = _load()
    X = np.ascontiguousarray(X, np.float32)
    Y = np.ascontiguousarray(Y, np.float32)
    out = np.zeros((X.shape[0], Y.shape[0]), np.float32)
    lib.pairwise_sq_dists(_fptr(X), X.shape[0], _fptr(Y), Y.shape[0], X.shape[1], _fptr(out))
    return out
