"""TreeSHAP contributions of a tree ensemble (h2o3_tpu/models/tree/contrib.py).

Exact path-dependent TreeSHAP (Lundberg & Lee) over the dense heap-order
trees, in the repository's C++ (`native/treeshap.cpp`), which
`ops/_build.load_host` compiles from source at first use; a failed build
raises. It runs on the host, as the reference's genmodel contribution
scorers do: the trees and rows are copied off the card once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from h2o3_tpu_torch.ops import _build

_P = ctypes.POINTER
_I32, _F32, _U8, _U32, _F64 = (ctypes.c_int32, ctypes.c_float,
                               ctypes.c_uint8, ctypes.c_uint32,
                               ctypes.c_double)


def _lib():
    lib = _build.load_host("treeshap")
    if not getattr(lib, "_typed", False):
        head = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, _P(_I32), _P(_F32), _P(_U8), _P(_F32),
                _P(_F32)]
        lib.treeshap_ensemble.restype = None
        lib.treeshap_ensemble.argtypes = head + [_P(_F64), _P(_F64)]
        lib.treeshap_ensemble_cat.restype = None
        lib.treeshap_ensemble_cat.argtypes = head + [
            _P(_U32), _P(_U8), ctypes.c_int, _P(_F64), _P(_F64)]
        lib._typed = True
    return lib


def _host(a, dtype):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return np.ascontiguousarray(a.astype(dtype, copy=False))


def _ptr(a, ctype):
    return a.ctypes.data_as(_P(ctype))


def ensemble_shap(trees, X: np.ndarray) -> np.ndarray:
    """phi (n, C+1) of one TreeArrays ensemble, in raw (unscaled) tree
    values: each row's contributions and, last, the bias term. X: (n, C)
    float64, NaN = NA."""
    if trees.cover is None:
        # the reference asserts
        raise AssertionError("model was trained before covers were "
                             "recorded; retrain to get SHAP")
    col = _host(trees.col, np.int32)
    thr = _host(trees.thr, np.float32)
    nal = _host(trees.na_left, np.uint8)
    val = _host(trees.value, np.float32)
    cov = _host(trees.cover, np.float32)
    X = np.ascontiguousarray(X, np.float64)
    n, C = X.shape
    T, nodes = col.shape
    phi = np.zeros((n, C + 1), np.float64)
    head = (T, nodes, trees.depth, C, n, _ptr(col, _I32), _ptr(thr, _F32),
            _ptr(nal, _U8), _ptr(val, _F32), _ptr(cov, _F32))
    has_cat = (trees.catbits is not None and trees.col_is_cat is not None
               and bool(np.any(np.asarray(trees.col_is_cat))))
    if has_cat:
        catb = _host(trees.catbits, np.uint32)
        iscat = np.zeros(C, np.uint8)
        flags = np.asarray(trees.col_is_cat, bool)
        iscat[: min(C, flags.size)] = flags[:C]
        _lib().treeshap_ensemble_cat(*head, _ptr(catb, _U32),
                                     _ptr(iscat, _U8), int(catb.shape[-1]),
                                     _ptr(X, _F64), _ptr(phi, _F64))
    else:
        _lib().treeshap_ensemble(*head, _ptr(X, _F64), _ptr(phi, _F64))
    return phi
