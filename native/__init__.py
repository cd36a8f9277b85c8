"""ctypes bindings for the native host-side kernel library (kernels.cc).

Builds lazily on first import (g++ -O3 -shared).  These are the C++
equivalents of the reference's external native dependencies (TV_Condat_v2,
Proximity Operator Repository kernels, L-BFGS-B-C) and serve as the golden
host path; the device compute path uses matlab_code_tpu/ops/.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libkernels.so")
_SRC = os.path.join(_DIR, "kernels.cc")


def _build():
    for flags in (["-O3", "-march=native"], ["-O3"]):
        try:
            subprocess.run(
                ["g++", *flags, "-shared", "-fPIC", "-std=c++17",
                 _SRC, "-o", _SO],
                check=True, capture_output=True)
            return
        except subprocess.CalledProcessError as e:
            err = e
    raise RuntimeError(
        f"native build failed: {err.stderr.decode(errors='replace')[:500]}")


def _load():
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_SO)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.tv_denoise.argtypes = [dptr, dptr, ctypes.c_int64, ctypes.c_double]
    lib.tv_denoise_cols.argtypes = [dptr, dptr, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_double]
    lib.isotonic.argtypes = [dptr, dptr, ctypes.c_int64]
    lib.unimodal.argtypes = [dptr, dptr, ctypes.c_int64, ctypes.c_int]
    lib.simplex_project.argtypes = [dptr, dptr, ctypes.c_int64,
                                    ctypes.c_double]
    lib.lbfgsb_minimize.restype = ctypes.c_int64
    lib.lbfgsb_minimize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, dptr, ctypes.c_int64, dptr, dptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    lptr = ctypes.POINTER(ctypes.c_int64)
    lib.matlab_randn_oracle.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                        dptr, lptr]
    lib.matlab_rand_oracle.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                       dptr]
    lib.matlab_zig_table.argtypes = [dptr, dptr, dptr]
    lib.matlab_randn_oracle_with_table.argtypes = [
        ctypes.c_uint32, ctypes.c_int64, dptr, lptr, dptr,
        ctypes.c_double, ctypes.c_double]
    return lib


_lib = _load()
_FG = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                       ctypes.c_void_p)


def _as_c(a):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tv_denoise(y: np.ndarray, lam: float) -> np.ndarray:
    y, yp = _as_c(y)
    x = np.empty_like(y)
    _lib.tv_denoise(yp, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    y.shape[0], lam)
    return x


def prox_tv(Y: np.ndarray, lam: float) -> np.ndarray:
    """Column-wise TV prox of an (n, r) matrix."""
    Yf, yp = _as_c(np.asarray(Y).T)        # column-contiguous
    X = np.empty_like(Yf)
    _lib.tv_denoise_cols(yp, X.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         Yf.shape[1], Yf.shape[0], lam)
    return X.T


def isotonic(y: np.ndarray, increasing: bool = True) -> np.ndarray:
    sign = 1.0 if increasing else -1.0
    y, yp = _as_c(sign * np.asarray(y))
    x = np.empty_like(y)
    _lib.isotonic(yp, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  y.shape[0])
    return sign * x


def unimodal(y: np.ndarray, nonneg: bool = False) -> np.ndarray:
    y, yp = _as_c(y)
    x = np.empty_like(y)
    _lib.unimodal(yp, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  y.shape[0], int(nonneg))
    return x


def simplex_project(y: np.ndarray, eta: float = 1.0) -> np.ndarray:
    y, yp = _as_c(y)
    x = np.empty_like(y)
    _lib.simplex_project(yp, x.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)), y.shape[0], eta)
    return x


def matlab_randn_oracle(n, seed=5489):
    """n MATLAB-twister randn draws from the INDEPENDENT C++ reconstruction
    (kernels.cc matlab_rng_oracle: sequential mt19937ar + runtime-solved
    long-double ziggurat table).  Returns (draws, (edge, tail) rejection
    counts).  Cross-validation oracle for utils/matlab_rng.MatlabRNG."""
    out = np.empty(int(n), np.float64)
    counts = np.zeros(2, np.int64)
    _lib.matlab_randn_oracle(
        seed, int(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, (int(counts[0]), int(counts[1]))


def matlab_randn_oracle_with_table(n, xs, w255, invr, seed=5489):
    """Like matlab_randn_oracle but on a caller-provided ziggurat x-table
    and derived constants — isolates the stream/accept-reject bookkeeping
    from table-rounding noise for bit-exact comparison."""
    out = np.empty(int(n), np.float64)
    counts = np.zeros(2, np.int64)
    xs = np.ascontiguousarray(xs, np.float64)
    _lib.matlab_randn_oracle_with_table(
        seed, int(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(w255), float(invr))
    return out, (int(counts[0]), int(counts[1]))


def matlab_rand_oracle(n, seed=5489):
    """n MATLAB genrand_res53 rand draws from the C++ reconstruction."""
    out = np.empty(int(n), np.float64)
    _lib.matlab_rand_oracle(
        seed, int(n), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def matlab_zig_table():
    """The independently solved ziggurat x-table + derived constants
    (v/f(r), 1/r) from kernels.cc."""
    xs = np.empty(256, np.float64)
    w255 = ctypes.c_double()
    invr = ctypes.c_double()
    _lib.matlab_zig_table(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(w255), ctypes.byref(invr))
    return xs, float(w255.value), float(invr.value)


def lbfgsb(fun, x0, lower, upper, m=5, maxiter=100, pgtol=1e-5, factr=1e7):
    """Minimize fun(x)->(f, grad) over box [lower, upper].  Returns (x, its)."""
    n = int(np.asarray(x0).shape[0])
    x = np.ascontiguousarray(x0, dtype=np.float64).copy()
    lo = np.ascontiguousarray(np.broadcast_to(lower, (n,)), dtype=np.float64)
    hi = np.ascontiguousarray(np.broadcast_to(upper, (n,)), dtype=np.float64)

    def cb(xp, gp, nn, ctx):
        xa = np.ctypeslib.as_array(xp, shape=(nn,))
        f, g = fun(xa.copy())
        ga = np.ctypeslib.as_array(gp, shape=(nn,))
        ga[:] = np.asarray(g, dtype=np.float64)
        return float(f)

    cfun = _FG(cb)
    its = _lib.lbfgsb_minimize(
        ctypes.cast(cfun, ctypes.c_void_p), None,
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m, maxiter, pgtol, factr)
    return x, int(its)
