"""Measure the CPU reference: f64 SE kernel build + LAPACK Cholesky.

This is the denominator for BASELINE.json:5's "faster than CPU reference
by 100x" target — the reference library's hot path (Cython elementwise
kernel build + numpy/scipy dpotrf, SURVEY.md §4.1) reproduced with
vectorized numpy (an upper bound on the reference's own speed: the Cython
loops are single-threaded; BLAS gets host threads here).

Writes benchmarks/cpu_baseline.json.  Run once per machine:
    JAX_PLATFORMS=cpu python benchmarks/cpu_baseline.py [Ns...]
"""

# allow running as `python benchmarks/<script>.py` from anywhere
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import json
import os
import sys
import time

import numpy as np
import scipy.linalg as sla


def _build_k_blocked(x, h, w, s, block=8192):
    """K built block-wise into one preallocated array (no (n, n) distance
    temp — at n=65536 the naive build's d+K is 68 GB and risks the OOM
    killer)."""
    n = x.shape[0]
    K = np.empty((n, n), dtype=np.float64)
    for i in range(0, n, block):
        xi = x[i:i + block, None]
        for j in range(0, n, block):
            d = xi - x[None, j:j + block]
            np.multiply(d, d, out=d)
            d *= -1.0 / (2 * w * w)
            np.exp(d, out=d)
            d *= h * h
            K[i:i + block, j:j + block] = d
    K[np.diag_indices_from(K)] += s * s
    return K


def _chol_blocked_inplace(K, panel=4096):
    """In-place lower blocked Cholesky with panel-sized BLAS calls.

    OpenBLAS's monolithic dpotrf segfaults at n=65536 on this host
    (kernel log: write fault inside libscipy_openblas during the
    factorization); panel-sized dpotrf + dtrsm + dgemm is how LAPACK
    blocks it anyway and keeps every BLAS call at a size that works.
    """
    n = K.shape[0]
    tile = 8192  # every BLAS call stays modest: huge single dgemm /
    # dtrsm calls segfault this host's OpenBLAS (kernel log, 2 crashes)
    for r in range(0, n, panel):
        b = min(panel, n - r)
        K[r:r + b, r:r + b] = sla.cholesky(K[r:r + b, r:r + b], lower=True)
        if r + b < n:
            Lkk = K[r:r + b, r:r + b]
            # L21 = A21 L11^-T  <=>  L11 (L21^T) = A21^T
            for i in range(r + b, n, tile):
                j = min(i + tile, n)
                K[i:j, r:r + b] = sla.solve_triangular(
                    Lkk, K[i:j, r:r + b].T, lower=True, trans="N"
                ).T
            strip = K[r + b:, r:r + b]
            for i in range(r + b, n, tile):
                j = min(i + tile, n)
                # lower triangle only (the factorization never reads
                # the strict upper triangle)
                K[i:j, r + b:j] -= strip[i - r - b:j - r - b] @ \
                    strip[:j - r - b].T
    return K


def measure(n: int, iters: int = 2) -> dict:
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-np.pi, np.pi, n))
    y = np.sin(2 * x) + 0.1 * rng.standard_normal(n)
    h, w, s = 1.0, 1.0, 0.1
    big = n >= 32768

    best_build = best_chol = best_solve = np.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        if big:
            K = _build_k_blocked(x, h, w, s)
        else:
            d = x[:, None] - x[None, :]
            K = (h * h) * np.exp(-(d * d) / (2 * w * w))
            K[np.diag_indices_from(K)] += s * s
            del d
        t1 = time.perf_counter()
        if big:
            L = _chol_blocked_inplace(K)  # overwrites K
        else:
            L = sla.cholesky(K, lower=True)
        t2 = time.perf_counter()
        alpha = sla.cho_solve((L, True), y)
        t3 = time.perf_counter()
        best_build = min(best_build, t1 - t0)
        best_chol = min(best_chol, t2 - t1)
        best_solve = min(best_solve, t3 - t2)
        del K, L, alpha
    return {
        "n": n,
        "dtype": "float64",
        "build_s": best_build,
        "cholesky_s": best_chol,
        "solve_s": best_solve,
        "total_s": best_build + best_chol + best_solve,
        **({"note": "blocked in-place chol (panel 4096): OpenBLAS "
                    "monolithic dpotrf segfaults at this n on this host"}
           if big else {}),
    }


if __name__ == "__main__":
    ns = [int(a) for a in sys.argv[1:]] or [4096, 16384]
    out = {}
    for n in ns:
        r = measure(n)
        out[str(n)] = r
        print(json.dumps(r), flush=True)
    path = os.path.join(os.path.dirname(__file__), "cpu_baseline.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update(out)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1)
    print("wrote", path)
