"""Kronecker-structured kernel algebra for D-dimensional Cartesian grids.

The multi-dim sibling of ops/toeplitz.py: when the (n, D) training inputs
are the Cartesian product of per-dimension uniform 1-D grids (row-major,
axis 0 slowest — ``kron_inputs``), a separable stationary kernel matrix
factorizes as a Kronecker product of per-dimension symmetric Toeplitz
matrices:

    K = h^2 T_1 (x) T_2 (x) ... (x) T_D,   T_d[i,j] = k_d(g_d[i] - g_d[j])

so a matvec is D batched FFT sweeps over the reshaped tensor —
O(n log n) for n = prod(n_d) — and memory never holds anything bigger
than the data.  The ARD squared-exponential (models/ard.py) is exactly
such a kernel: h^2 prod_d exp(-diff_d^2 / (2 w_d^2)).

Derivatives stay Kronecker: dK/dh = (2/h) K; dK/dw_d swaps factor d for
its derivative Toeplitz factor.  So the matrix-free Hutchinson gradient
(models/iterative_gp.py, ``structure=KronOperator``) runs entirely in
FFT land, like the 1-D Toeplitz path.

Preconditioning/logdet: the Kronecker product of the per-dimension
Strang circulants is itself diagonalized by the D-dim DFT, so
P = (x)_d C_d + shift I has an exact O(n) logdet and an O(n log n)
apply/half-power — the same preconditioned-SLQ identity as
ops/toeplitz.py::slq_logdet_circulant, one FFT dimension richer.

The reference is strictly 1-D (SURVEY.md §1); this extends the round-1
ARD extension (models/ard.py) with the structure exploit that makes
image-/lattice-style GP regression (2-D and 3-D grids) tractable at
N = prod(n_d) ~ 10^6 on one device.  Gated against dense ARD matrices in
tests/test_kronecker.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from gaussian_processes_tpu.models.ard import ARDGaussianKernel
from gaussian_processes_tpu.ops import toeplitz


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KronOperator:
    """Cartesian-grid geometry: per-dimension uniform 1-D grids.

    ``axes``: tuple of (n_d,) arrays.  The (n, D) training inputs must be
    ``kron_inputs(axes)`` (row-major order) and y must follow the same
    ordering.  Kernel/noise are not stored — one geometry serves every
    hyperparameter value.
    """

    axes: Tuple[jax.Array, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(a.shape[0]) for a in self.axes)

    @property
    def n(self) -> int:
        out = 1
        for a in self.axes:
            out *= int(a.shape[0])
        return out

    @property
    def ndim(self) -> int:
        return len(self.axes)


def kron_inputs(axes) -> jax.Array:
    """(n, D) Cartesian-product inputs, row-major (axis 0 slowest)."""
    grids = jnp.meshgrid(*[jnp.asarray(a) for a in axes], indexing="ij")
    return jnp.stack([g.reshape(-1) for g in grids], axis=-1)


def _se_column(g: jax.Array, w) -> jax.Array:
    """First column of the unit-amplitude SE Toeplitz factor on grid g."""
    d = g - g[0]
    return jnp.exp(-0.5 * jnp.square(d) / jnp.square(w))


def _se_dcolumn(g: jax.Array, w) -> jax.Array:
    """First column of d/dw of the unit SE factor: E * d^2 / w^3."""
    d = g - g[0]
    s = jnp.square(d) / jnp.square(w)
    return jnp.exp(-0.5 * s) * s / w


def kron_columns(kernel: ARDGaussianKernel, op: KronOperator):
    """Per-dimension Toeplitz first columns; h^2 folded into factor 0."""
    if not isinstance(kernel, ARDGaussianKernel):
        raise NotImplementedError(
            "Kronecker structure currently supports ARDGaussianKernel "
            f"(separable by construction); got {type(kernel).__name__}"
        )
    if kernel.w.shape[0] != op.ndim:
        raise ValueError(
            f"kernel has {kernel.w.shape[0]} lengthscales, grid has "
            f"{op.ndim} axes"
        )
    cols = [_se_column(jnp.asarray(g), kernel.w[d])
            for d, g in enumerate(op.axes)]
    cols[0] = cols[0] * jnp.square(kernel.h)
    return cols


def kron_jacobian_columns(kernel: ARDGaussianKernel, op: KronOperator):
    """Column lists for dK/dtheta_p, p = (h, w_1..w_D) — each Kronecker.

    dK/dh = (2/h) K: same columns, rescaled.  dK/dw_d: factor d swapped
    for its derivative column (amplitude kept on factor 0).
    """
    base = kron_columns(kernel, op)
    out = []
    scale = 2.0 / kernel.h
    out.append([base[0] * scale] + list(base[1:]))
    for d in range(op.ndim):
        cols = list(base)
        dcol = _se_dcolumn(jnp.asarray(op.axes[d]), kernel.w[d])
        if d == 0:
            cols[0] = dcol * jnp.square(kernel.h)
        else:
            cols[d] = dcol
        out.append(cols)
    return out


def kron_matvec(cols, v: jax.Array, shift=0.0) -> jax.Array:
    """((x)_d T_d + shift I) @ v; v is (n,) or (n, r), n = prod(n_d).

    D batched Toeplitz-FFT sweeps: reshape to the grid tensor, apply each
    factor along its own axis.
    """
    sizes = tuple(int(c.shape[0]) for c in cols)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    r = v2.shape[1]
    t = v2.reshape(*sizes, r)
    for d, c in enumerate(cols):
        t = jnp.moveaxis(t, d, 0)
        lead = t.shape[0]
        rest = t.shape[1:]
        t = toeplitz.toeplitz_matvec(c, t.reshape(lead, -1))
        t = jnp.moveaxis(t.reshape(lead, *rest), 0, d)
    out = t.reshape(-1, r) + jnp.asarray(shift, v2.dtype) * v2
    return out[:, 0] if squeeze else out


def kernel_matvec_kron(
    kernel: ARDGaussianKernel, op: KronOperator, v: jax.Array, noise,
    jitter: float = 0.0,
) -> jax.Array:
    """(K(x, x) + (noise^2 + jitter) I) @ v on the Cartesian grid."""
    cols = kron_columns(kernel, op)
    shift = jnp.square(jnp.asarray(noise)) + jitter
    return kron_matvec(cols, v, shift)


# --- circulant preconditioner / exact-logdet SLQ (D-dim) --------------------


def kron_circulant_spectrum(cols, shift) -> jax.Array:
    """Full-grid spectrum of P = ((x)_d C_d) + shift I, noise ADDITIVE.

    Each C_d is the Strang circulant of T_d (wrap at n_d/2); the
    Kronecker product is diagonalized by the D-dim DFT with real
    eigenvalues outer-prod(lam_d).  Returned shape: op grid shape.
    Per-factor FFT round-off is rectified at ZERO (no relative floor)
    and ``shift`` — the observation-noise variance plus jitter — is
    added AFTER, mirroring ops/toeplitz.py::circulant_eigenvalues: a
    relative floor at N ~ 1e6 scales lands at the noise level and
    erases s from the high-frequency bins (round-4 measured failure).
    This rectified-kernel + additive-noise spectrum IS the
    preconditioner's definition.

    Caveat (measured, tests/test_kronecker.py): the wrap approximation
    needs each dim's kernel to decay within n_d/2 cells.  With a
    lengthscale comparable to the grid extent the clamped circulant can
    *slow* CG vs no preconditioner — prefer plain CG (or refine the
    grid) in that regime.

    Budgeting note (measured): the Kronecker circulant
    clusters the spectrum less tightly than its 1-D counterpart (wrap
    error compounds across dims), so 2-D grids typically need ~2-3x the
    CG iterations of an equivalent 1-D Toeplitz solve — e.g. 512x512
    f32 at kappa ~ 5e4 reached 2e-6 at 400 iterations where the 1-D 65k
    path needed 150.
    """
    lam = None
    for c in cols:
        n = c.shape[0]
        idx = jnp.arange(n)
        wrap = jnp.where(idx <= n // 2, idx, n - idx)
        # rectify per-factor FFT round-off at zero so the outer product
        # stays >= 0; the noise is added AFTER and is never clamped
        # away (the 1-D rationale at toeplitz.circulant_eigenvalues —
        # a relative floor at N ~ 1e6 scales lands at the noise level
        # and erases s from the high-frequency bins)
        lam_d = jnp.maximum(jnp.fft.fft(c[wrap]).real, 0.0)
        lam = lam_d if lam is None else lam[..., None] * lam_d
    lam = lam + jnp.asarray(shift, lam.dtype)
    # absolute SPD guard for shift == 0 (same rationale as the 1-D
    # circulant_eigenvalues): rectified bins can be exactly 0
    return jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)


def kron_circulant_spectrum_analytic(
    kernel: ARDGaussianKernel, op: KronOperator, shift, aliases: int = 2
) -> jax.Array:
    """Analytic torus spectrum for the separable ARD-SE kernel.

    Each factor's periodized spectrum comes from the 1-D SE Poisson sum
    (ops/toeplitz.py::circulant_eigenvalues_analytic rationale):
    lam_d[k] = (w_d sqrt(2 pi) / dx_d) sum_l exp(-w_d^2 (o_k + l o_s)^2 / 2)
    over the FULL fft frequency grid (negative bins mirrored), h^2
    folded into factor 0 exactly as kron_columns does; the D-dim
    spectrum is the outer product plus the additive noise.  Exact tail
    decay in f32 — no FFT round-off floor.
    """
    if not isinstance(kernel, ARDGaussianKernel):
        raise NotImplementedError(
            "analytic Kronecker spectrum supports ARDGaussianKernel; "
            f"got {type(kernel).__name__}")
    lam = None
    for d, g in enumerate(op.axes):
        g = jnp.asarray(g)
        n = g.shape[0]
        dx = g[1] - g[0]
        k = jnp.arange(n, dtype=g.dtype)
        k = jnp.where(k <= n // 2, k, k - n)  # full fft bin frequencies
        om = 2.0 * jnp.pi * k / (n * dx)
        om_s = 2.0 * jnp.pi / dx
        w = kernel.w[d]
        lam_d = None
        for l in range(-aliases, aliases + 1):
            s = w * jnp.sqrt(2.0 * jnp.pi) * jnp.exp(
                -0.5 * jnp.square(w * (om + l * om_s)))
            lam_d = s if lam_d is None else lam_d + s
        lam_d = lam_d / dx
        if d == 0:
            lam_d = lam_d * jnp.square(kernel.h)
        lam = lam_d if lam is None else lam[..., None] * lam_d
    lam = lam + jnp.asarray(shift, lam.dtype)
    return jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)


def kron_whittle_spectrum(kernel, op, noise, jitter: float = 0.0,
                          spectrum: str = "auto") -> jax.Array:
    """Grid-shaped torus spectrum for the Kron Whittle density.

    "auto"/"analytic" use the closed-form ARD-SE spectrum (the only
    kernel Kronecker structure supports — kron_columns enforces it),
    "fft" the per-factor FFT of the wrapped columns.
    """
    shift = jnp.square(jnp.asarray(noise)) + jitter
    if spectrum in ("auto", "analytic"):
        return kron_circulant_spectrum_analytic(kernel, op, shift)
    return kron_circulant_spectrum(kron_columns(kernel, op), shift)


def _kron_circulant_apply(lam: jax.Array, power: float):
    """v -> F^-1 diag(lam^power) F v over the D-dim grid; v (n,) or (n, r)."""
    lp = jnp.power(lam, power)
    sizes = lam.shape
    axes = tuple(range(len(sizes)))

    def apply(v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        r = v2.shape[1]
        t = v2.reshape(*sizes, r)
        ft = jnp.fft.fftn(t, axes=axes)
        out = jnp.fft.ifftn(ft * lp[..., None], axes=axes).real
        out = out.reshape(-1, r).astype(v2.dtype)
        return out[:, 0] if squeeze else out

    return apply


def kron_circulant_precond(cols, shift):
    """v -> P^-1 v, P = Kronecker-Strang circulant + shift I (free)."""
    lam = kron_circulant_spectrum(cols, shift)
    return _kron_circulant_apply(lam, -1.0)


def slq_logdet_kron_circulant(
    matvec, cols, shift, key, num_probes: int, num_iters: int
):
    """logdet(A) by circulant-preconditioned SLQ on the D-dim grid.

    Identical identity to ops/toeplitz.py::slq_logdet_circulant with
    P = ((x)_d C_d) + shift I: exact logdet(P) = sum log lam over the
    full grid; probes z = P^(1/2) u; quadrature from the PCG Lanczos
    tridiagonals.
    """
    import math

    from gaussian_processes_tpu.ops import krylov

    lam = kron_circulant_spectrum(cols, shift)
    pre = _kron_circulant_apply(lam, -1.0)
    half = _kron_circulant_apply(lam, 0.5)
    n = math.prod(lam.shape)
    u = jax.random.normal(key, (n, num_probes), lam.dtype)
    probes = half(u)
    _, _, alphas, betas = krylov.pcg(
        matvec, pre, probes, num_iters=num_iters, tol=1e-12,
        return_tridiag=True,
    )
    probe_norms = jnp.sum(probes * pre(probes), axis=0)
    T = krylov.lanczos_tridiag_from_cg(alphas, betas)
    evals, evecs = jnp.linalg.eigh(T)
    w = jnp.square(evecs[:, 0, :])
    # physical Ritz floor (see ops/toeplitz.py::slq_logdet_circulant)
    floor = jnp.asarray(shift, lam.dtype) / jnp.max(lam)
    quad = jnp.sum(w * jnp.log(jnp.maximum(evals, floor)), axis=-1)
    return jnp.sum(jnp.log(lam)) + jnp.mean(probe_norms * quad)


def whittle_log_marginal_kron(
    kernel: ARDGaussianKernel, op: KronOperator, y, noise,
    jitter: float = 0.0, spectrum: str = "auto",
) -> jax.Array:
    """EXACT log-density of the D-dim torus (Kronecker-circulant)
    surrogate model — the Whittle likelihood on a Cartesian grid.

    The D-dim generalization of ops/toeplitz.py::whittle_log_marginal:
    K = (x)_d T_d is replaced by its Kronecker-Strang circulant
    (x)_d C_d — a stationary GP on the D-torus — whose density the
    D-dim DFT diagonalizes:

        lml_W = -1/2 sum_k [ |Y^_k|^2 / (n lam_k) + log lam_k ]
                - (n/2) log 2pi,   Y^ = fftn(y over the grid)

    (the full complex FFT makes the conjugate-multiplicity bookkeeping
    of the 1-D rfft version unnecessary: summing |Y^|^2/lam over ALL n
    bins is exactly y^T (C + s^2 I)^-1 y for real y).  O(n log n),
    deterministic, plain autodiff through the per-dimension kernel
    columns — the fully-Bayesian objective for D-dim grids at n ~ 1e6
    where stochastic SLQ surrogates lose f32 honesty (round 2).

    Same boundary semantics as 1-D: each dimension's ends are treated
    as neighbors; use endpoint-exclusive grids and check seam
    compatibility (gates in tests/test_kronecker.py).
    """
    y = jnp.asarray(y)
    n = op.n
    lam = kron_whittle_spectrum(kernel, op, noise, jitter, spectrum)
    fy = jnp.fft.fftn(y.reshape(op.shape))
    p_y = jnp.square(fy.real) + jnp.square(fy.imag)
    quad = jnp.sum(p_y / lam) / n
    logdet = jnp.sum(jnp.log(lam))
    return -0.5 * quad - 0.5 * logdet - 0.5 * n * jnp.log(2.0 * jnp.pi)
