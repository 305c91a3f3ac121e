"""Host-native kernel evaluation: C extension with numpy fallback.

C kernel-matrix builders — role parity with the reference's Cython
extensions (SURVEY.md §3 C7/C8).  Used by the CPU baseline benchmark
and as an extra oracle in tests; the device compute path never goes
through here.

API convention matches the reference's native layer: ``*_K(out, x1, x2,
theta...)`` fills a preallocated C-contiguous float64 array.  This module
wraps that in an allocating, shape-checked surface.
"""

from __future__ import annotations

import numpy as np

def _import_native():
    """Load the C extension from sys.path or the in-tree native/ dir."""
    try:
        import _ckernels  # type: ignore

        return _ckernels
    except ImportError:
        import pathlib
        import sys

        nd = str(pathlib.Path(__file__).resolve().parents[2] / "native")
        if nd not in sys.path:
            sys.path.append(nd)
        try:
            import _ckernels  # type: ignore

            return _ckernels
        except ImportError:  # pragma: no cover - depends on build state
            return None


_ckernels = _import_native()
HAVE_NATIVE = _ckernels is not None


def _np1d(x):
    a = np.ascontiguousarray(x, dtype=np.float64)
    if a.ndim != 1:
        raise ValueError("inputs must be 1-D")
    return a


def se_k(x1, x2, h, w):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((x1.size, x2.size))
        _ckernels.se_K(out, x1, x2, float(h), float(w))
        return out
    d = x1[:, None] - x2[None, :]
    return h * h * np.exp(-0.5 * d * d / (w * w))


def se_jacobian(x1, x2, h, w):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((2, x1.size, x2.size))
        _ckernels.se_jacobian(out, x1, x2, float(h), float(w))
        return out
    d = x1[:, None] - x2[None, :]
    d2, iw2 = d * d, 1.0 / (w * w)
    E = np.exp(-0.5 * d2 * iw2)
    return np.stack([2 * h * E, h * h * E * d2 * iw2 / w])


def se_hessian(x1, x2, h, w):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((2, 2, x1.size, x2.size))
        _ckernels.se_hessian(out, x1, x2, float(h), float(w))
        return out
    d = x1[:, None] - x2[None, :]
    d2, iw2 = d * d, 1.0 / (w * w)
    iw3 = iw2 / w
    E = np.exp(-0.5 * d2 * iw2)
    hh = 2 * E
    hw = 2 * h * E * d2 * iw3
    ww = h * h * E * (d2 * d2 * iw3 * iw3 - 3 * d2 * iw2 * iw2)
    return np.stack([np.stack([hh, hw]), np.stack([hw, ww])])


def periodic_k(x1, x2, h, w, p):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((x1.size, x2.size))
        _ckernels.periodic_K(out, x1, x2, float(h), float(w), float(p))
        return out
    d = x1[:, None] - x2[None, :]
    s = np.sin(d / (2 * p))
    return h * h * np.exp(-2 * s * s / (w * w))


def periodic_jacobian(x1, x2, h, w, p):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((3, x1.size, x2.size))
        _ckernels.periodic_jacobian(out, x1, x2, float(h), float(w), float(p))
        return out
    d = x1[:, None] - x2[None, :]
    u = d / (2 * p)
    s, s2u = np.sin(u), np.sin(2 * u)
    iw2 = 1.0 / (w * w)
    E = np.exp(-2 * s * s * iw2)
    return np.stack([
        2 * h * E,
        h * h * E * 4 * s * s * iw2 / w,
        h * h * E * d * s2u * iw2 / (p * p),
    ])


def periodic_hessian(x1, x2, h, w, p):
    x1, x2 = _np1d(x1), _np1d(x2)
    if HAVE_NATIVE:
        out = np.empty((3, 3, x1.size, x2.size))
        _ckernels.periodic_hessian(out, x1, x2, float(h), float(w), float(p))
        return out
    d = x1[:, None] - x2[None, :]
    u = d / (2 * p)
    s, s2u, c2u = np.sin(u), np.sin(2 * u), np.cos(2 * u)
    iw2, ip = 1.0 / (w * w), 1.0 / p
    E = np.exp(-2 * s * s * iw2)
    h2E = h * h * E
    g_w = 4 * s * s * iw2 / w
    g_p = d * s2u * iw2 * ip * ip
    g_ww = -12 * s * s * iw2 * iw2
    g_wp = -2 * d * s2u * iw2 / w * ip * ip
    g_pp = -d * (d * c2u * ip + 2 * s2u) * iw2 * ip * ip * ip
    k_hh = 2 * E
    k_hw = 2 * h * E * g_w
    k_hp = 2 * h * E * g_p
    k_ww = h2E * (g_w * g_w + g_ww)
    k_wp = h2E * (g_w * g_p + g_wp)
    k_pp = h2E * (g_p * g_p + g_pp)
    return np.stack([
        np.stack([k_hh, k_hw, k_hp]),
        np.stack([k_hw, k_ww, k_wp]),
        np.stack([k_hp, k_wp, k_pp]),
    ])
