"""Toeplitz-structured kernel algebra for uniform 1-D grids (FFT matvecs).

When the training inputs are an evenly spaced grid, every stationary
kernel matrix here is symmetric Toeplitz: K[i, j] = k((i - j) dx) is
fully described by its first column.  That collapses the iterative
path's O(n^2) on-the-fly strip matvec (ops/krylov.py::kernel_matvec) to
an O(n log n) circulant-embedding FFT product — the classic structured
trick, rebuilt here on XLA's FFT (cuFFT on the GPU):

    embed col into a length-2n circulant   c = [col, 0, col[n-1:0:-1]]
    (T v) = irfft(rfft(c) * rfft([v, 0]))[:n]

Gradients come along for free: dK/dtheta_p of a stationary kernel is
stationary too, so the Hutchinson trace terms of the matrix-free
log-marginal gradient are FFT products of the *Jacobian* columns.

Also here: the Strang circulant preconditioner — the nearest circulant
to T (wrap the column at n/2), whose inverse applies in one more FFT
pair.  For Toeplitz systems it clusters the spectrum at 1, replacing the
O(n k^2) pivoted-Cholesky preconditioner build with something free.

This is the 1-D analogue of "exploit structure before brute force": the
reference library (SURVEY.md §1 — exact 1-D GP regression) is exactly
the regime where gridded designs are common (time series, signals), and
the FFT path turns config-#4-sized fits into sub-second work.
Everything is gated against the dense/strip paths in
tests/test_toeplitz.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gaussian_processes_tpu.models.base import Kernel


def is_uniform_grid(x, rtol: float | None = None) -> bool:
    """Host-side check that ``x`` is sorted and evenly spaced.

    Call this OUTSIDE jit (it concretizes) to decide whether the
    ``structure="toeplitz"`` fast path applies.  The default tolerance
    adapts to the dtype: an exactly uniform grid stored in f32 carries
    spacing jitter up to ~eps * max|x|, which can exceed a fixed 1e-5 of
    dx on fine grids (seen at n=8192 f32 over [-pi, pi)).
    """
    import numpy as np

    x = np.asarray(x)
    if x.ndim != 1 or x.shape[0] < 2:
        return False
    d = np.diff(x)
    dx = d.mean()
    if dx == 0:
        return False
    if rtol is None:
        eps = np.finfo(x.dtype).eps if np.issubdtype(x.dtype, np.floating) \
            else np.finfo(np.float64).eps
        rtol = max(1e-5, 4.0 * eps * float(np.max(np.abs(x))) / abs(dx))
    return bool(np.max(np.abs(d - dx)) <= rtol * abs(dx))


def toeplitz_column(kernel: Kernel, x: jax.Array) -> jax.Array:
    """First column of K_f(x, x) for a uniform grid x: col[i] = k(x_i - x_0)."""
    x = jnp.asarray(x)
    return kernel(x, x[:1])[:, 0]


def jacobian_columns(kernel: Kernel, x: jax.Array) -> jax.Array:
    """First columns of dK/dtheta_p, shape (P, n) — each Toeplitz too."""
    x = jnp.asarray(x)
    return kernel.jacobian(x, x[:1])[:, :, 0]


def _embed_fft(col: jax.Array) -> jax.Array:
    """rfft of the length-2n circulant embedding of a symmetric Toeplitz."""
    n = col.shape[0]
    emb = jnp.concatenate([col, jnp.zeros((1,), col.dtype), col[1:][::-1]])
    del n
    return jnp.fft.rfft(emb)


def toeplitz_matvec(col: jax.Array, v: jax.Array, shift=0.0) -> jax.Array:
    """(T + shift I) @ v for symmetric Toeplitz T with first column ``col``.

    ``v``: (n,) or (n, r).  One length-2n rfft/irfft pair — O(n log n)
    and bandwidth-bound, vs the O(n^2) kernel-eval strip matvec.
    """
    col = jnp.asarray(col)
    n = col.shape[0]
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    fc = _embed_fft(col)  # (n + 1,) complex
    vp = jnp.pad(v2, ((0, n), (0, 0)))
    fv = jnp.fft.rfft(vp, axis=0)
    prod = fc[:, None] * fv
    out = jnp.fft.irfft(prod, n=2 * n, axis=0)[:n]
    out = out.astype(v2.dtype) + jnp.asarray(shift, v2.dtype) * v2
    return out[:, 0] if squeeze else out


def kernel_matvec_toeplitz(
    kernel: Kernel, x: jax.Array, v: jax.Array, noise, jitter: float = 0.0
) -> jax.Array:
    """(K_f(x, x) + (noise^2 + jitter) I) @ v on a uniform grid.

    Drop-in for ops/krylov.py::kernel_matvec when ``is_uniform_grid(x)``.
    """
    col = toeplitz_column(kernel, x)
    shift = jnp.square(jnp.asarray(noise)) + jitter
    return toeplitz_matvec(col, v, shift)


def circulant_eigenvalues(col: jax.Array, shift) -> jax.Array:
    """Spectrum of P = C_s + shift I (Strang circulant), noise ADDITIVE.

    The wrap-around column keeps lags up to n/2 and reflects the rest;
    the kernel part's eigenvalues are the (real) DFT of that column.
    Near-zero or negative kernel eigenvalues (truncated tails, FFT
    round-off on a spectrum whose dynamic range exceeds the dtype) are
    rectified at zero, and ``shift`` — the observation-noise variance
    plus jitter — is added AFTER, so it is never clamped away.  This
    spectrum IS the definition of P, shared by the apply / sampler /
    logdet below so they describe one operator.

    Why additive (round-4 measured failure): the previous
    ``max(lam + shift, 1e-6 max|lam| + shift/2)`` floor is ~1e-2 at
    N=2^20 SE scales (lam_max ~ 1e4) — the same order as a realistic
    noise variance — so the Whittle density's high-frequency bins
    stopped depending on s and the 1M-point posterior mis-ranked the
    noise (lp INCREASED as s -> 0; round-4 forensics).
    ``shift`` must be > 0 for SPD; every caller passes noise^2 + jitter.
    """
    col = jnp.asarray(col)
    n = col.shape[0]
    idx = jnp.arange(n)
    wrap = jnp.where(idx <= n // 2, idx, n - idx)
    cs = col[wrap]
    lam_k = jnp.fft.rfft(cs).real
    lam = jnp.maximum(lam_k, 0.0) + jnp.asarray(shift, col.dtype)
    # absolute SPD guard: with shift == 0 (user-reachable via noise=0,
    # jitter=0) rectified bins are exactly 0 and downstream lam^-1 /
    # log(lam) produce inf — floor at the smallest normal, which is
    # ~1e-38 and cannot bias any run with a real noise level
    return jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)


def spectral_density(kernel, omega):
    """Continuous-FT spectral density S(w) with k(t) = (1/2pi) int S e^{iwt}.

    Returns ``None`` for kernel families without a supported closed
    form (periodic: line spectrum; RQ: Bessel-K form; products:
    convolution) — callers fall back to the FFT spectrum.  Sums map to
    sums.  Closed forms (1-D, validated against an f64 FFT oracle in
    tests/test_toeplitz.py):

      SE          h^2 w sqrt(2 pi) exp(-w^2 o^2 / 2)
      Matern-3/2  h^2 12 sqrt(3) / w^3 * (3/w^2 + o^2)^-2
      Matern-5/2  h^2 (400 sqrt(5) / 3) / w^5 * (5/w^2 + o^2)^-3
    """
    from gaussian_processes_tpu.models.composite import SumKernel
    from gaussian_processes_tpu.models.gaussian import GaussianKernel
    from gaussian_processes_tpu.models.matern import (
        Matern32Kernel,
        Matern52Kernel,
    )

    omega = jnp.asarray(omega)
    if isinstance(kernel, GaussianKernel):
        h2, w = jnp.square(kernel.h), kernel.w
        return h2 * w * jnp.sqrt(2.0 * jnp.pi) * jnp.exp(
            -0.5 * jnp.square(w * omega))
    if isinstance(kernel, Matern32Kernel):
        h2, w = jnp.square(kernel.h), kernel.w
        return h2 * (12.0 * jnp.sqrt(3.0) / w**3) / jnp.square(
            3.0 / jnp.square(w) + jnp.square(omega))
    if isinstance(kernel, Matern52Kernel):
        h2, w = jnp.square(kernel.h), kernel.w
        return h2 * (400.0 * jnp.sqrt(5.0) / 3.0 / w**5) / (
            5.0 / jnp.square(w) + jnp.square(omega)) ** 3
    if isinstance(kernel, SumKernel):
        s1 = spectral_density(kernel.k1, omega)
        s2 = spectral_density(kernel.k2, omega)
        if s1 is None or s2 is None:
            return None
        return s1 + s2
    return None


def periodic_line_bins(kernel, n: int, dx, num_harmonics: int = 256):
    """Exact folded line spectrum of the periodic kernel on n grid bins.

    The periodic kernel is a pure line spectrum (Jacobi-Anger, the same
    expansion models/pathwise.py::periodic_harmonic_features uses):

        k(d) = a_0 + sum_{q>=1} a_q cos(q d / p),
        a_0 = h^2 e^{-c} I_0(c),  a_q = 2 h^2 e^{-c} I_q(c),  c = 1/w^2.

    Sampling at spacing dx folds each line EXACTLY onto its aliased
    frequency in [0, pi/dx] (a sampled cosine IS its folded twin — no
    truncated Poisson sum, no tail).  The folded position in rfft-bin
    units, t_q = fold(q dx / (2 pi p)) * n, is generally not an integer;
    the circulant surrogate model assigns each line's variance a_q to
    the two neighboring bins with linear weights — piecewise-linear
    (and autodiff-differentiable) in the period p, exact whenever the
    period is grid-commensurate (then t_q is an integer and the result
    equals the f64 FFT of the wrapped column bit-for-bit in exact
    arithmetic; gated in tests/test_toeplitz.py).

    Bin scaling: a line carrying variance a at interior rfft bin k
    contributes lam_k = a n / w_k with conjugate multiplicity w_k (2
    interior, 1 at DC/Nyquist), so the model's total variance is
    sum_k w_k lam_k / n = sum_q a_q = k(0).

    Truncation: harmonic weights decay super-exponentially once
    q >> c = 1/w^2; ``num_harmonics`` = 256 (with a matching Bessel
    series length) covers lengthscales w >= ~0.07.  Returns the KERNEL
    part only (no noise shift).
    """
    from gaussian_processes_tpu.models.pathwise import _log_bessel_i

    h = jnp.asarray(kernel.h)
    w = jnp.asarray(kernel.w)
    p = jnp.asarray(kernel.p)
    dtype = jnp.result_type(h.dtype, jnp.asarray(dx).dtype)
    c = 1.0 / (w * w)
    q = jnp.arange(num_harmonics + 1, dtype=dtype)
    logI = _log_bessel_i(q, c, num_terms=max(80, num_harmonics))
    a = jnp.exp(2.0 * jnp.log(h) - c + logI)  # h^2 e^{-c} I_q(c)
    a = a * jnp.where(q == 0, 1.0, 2.0)
    # folded line positions in rfft-bin units: f in cycles/sample
    f = (q / p) * jnp.asarray(dx, dtype) / (2.0 * jnp.pi)
    f = jnp.mod(f, 1.0)
    f = jnp.minimum(f, 1.0 - f)  # [0, 1/2]
    t = f * n  # [0, n/2]
    k0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n // 2)
    frac = t - k0.astype(dtype)
    k1 = jnp.minimum(k0 + 1, n // 2)
    m = n // 2 + 1
    # conjugate multiplicities of the rfft bins
    mult = jnp.full((m,), 2.0, dtype).at[0].set(1.0)
    if n % 2 == 0:
        mult = mult.at[m - 1].set(1.0)
    lam = jnp.zeros((m,), dtype)
    lam = lam.at[k0].add(a * (1.0 - frac) * n / mult[k0])
    lam = lam.at[k1].add(a * frac * n / mult[k1])
    return lam


def _periodic_weights(kernel, num_harmonics: int, dtype):
    """(a_q, nu_q): harmonic variances (2x folded in for q >= 1) and
    line frequencies in rad of the periodic kernel's Jacobi-Anger
    expansion — the building block of both the pure line spectrum and
    the quasi-periodic convolution below."""
    from gaussian_processes_tpu.models.pathwise import _log_bessel_i

    h = jnp.asarray(kernel.h)
    w = jnp.asarray(kernel.w)
    p = jnp.asarray(kernel.p)
    c = 1.0 / (w * w)
    q = jnp.arange(num_harmonics + 1, dtype=dtype)
    logI = _log_bessel_i(q, c, num_terms=max(80, num_harmonics))
    a = jnp.exp(2.0 * jnp.log(h) - c + logI)
    a = a * jnp.where(q == 0, 1.0, 2.0)
    return a, q / p


def quasi_periodic_bins(kp, kc, n: int, dx, dtype, aliases: int,
                        num_harmonics: int):
    """Analytic circulant bins for the QUASI-PERIODIC product kernel.

    k = k_periodic * k_continuous has the closed-form spectral density

        S(o) = sum_q (a_q / 2) [S_c(o - nu_q) + S_c(o + nu_q)]

    (a line spectrum convolved with a continuous density: each harmonic
    broadens into a shifted copy of S_c) — the classic GP time-series
    model (e.g. SE x periodic for decaying periodicity) evaluated
    exactly, tail included, where an f32 FFT of the column cannot
    resolve it.  The aliasing Poisson sum folds in additively, so the
    bins are one lax.scan over harmonics of shifted density
    evaluations.  Returns the kernel part only (no noise shift).
    """
    from jax import lax

    a, nu = _periodic_weights(kp, num_harmonics, dtype)
    k = jnp.arange(n // 2 + 1, dtype=dtype)
    om = 2.0 * jnp.pi * k / (n * dx)
    om_s = 2.0 * jnp.pi / dx
    shifts = [l * om_s for l in range(-aliases, aliases + 1)]

    # jax.checkpoint: without it, autodiff through the scan saves every
    # step's (n//2+1,)-sized density intermediates — measured 53 GB of
    # device-memory residuals at n=2^20 with 257 harmonics (OOM,
    # round 5).
    # The body is a few dozen elementwise evals; recomputing it on the
    # backward pass is free next to the memory it saves.
    @jax.checkpoint
    def body(lam, aq_nu):
        aq, nuq = aq_nu
        s = jnp.zeros_like(lam)
        for sh in shifts:
            s = s + spectral_density(kc, om + sh - nuq)
            s = s + spectral_density(kc, om + sh + nuq)
        return lam + 0.5 * aq * s, None

    lam0 = jnp.zeros((n // 2 + 1,), dtype)
    lam, _ = lax.scan(body, lam0, (a, nu))
    return lam / dx


def _analytic_kernel_bins(kernel, n: int, dx, dtype, aliases: int,
                          num_harmonics: int):
    """Kernel part of the analytic circulant spectrum, or None.

    Recursive over SumKernel so mixed continuous + line families
    (e.g. SE + periodic, the classic quasi-periodic decomposition)
    stay analytic; ProductKernel is supported when one factor is
    periodic (line spectrum) and the other has a continuous density —
    the quasi-periodic convolution (quasi_periodic_bins).
    """
    from gaussian_processes_tpu.models.composite import (
        ProductKernel,
        SumKernel,
    )
    from gaussian_processes_tpu.models.periodic import PeriodicKernel

    if isinstance(kernel, PeriodicKernel):
        return periodic_line_bins(kernel, n, dx, num_harmonics)
    if isinstance(kernel, SumKernel):
        a = _analytic_kernel_bins(kernel.k1, n, dx, dtype, aliases,
                                  num_harmonics)
        b = _analytic_kernel_bins(kernel.k2, n, dx, dtype, aliases,
                                  num_harmonics)
        if a is None or b is None:
            return None
        return a + b
    if isinstance(kernel, ProductKernel):
        for kp, kc in ((kernel.k1, kernel.k2), (kernel.k2, kernel.k1)):
            if isinstance(kp, PeriodicKernel) and \
                    not isinstance(kc, PeriodicKernel):
                probe = spectral_density(kc, jnp.zeros((1,), dtype))
                if probe is None:
                    return None
                return quasi_periodic_bins(kp, kc, n, dx, dtype, aliases,
                                           num_harmonics)
        return None
    k = jnp.arange(n // 2 + 1, dtype=dtype)
    om = 2.0 * jnp.pi * k / (n * dx)
    om_s = 2.0 * jnp.pi / dx
    lam = None
    for l in range(-aliases, aliases + 1):
        s = spectral_density(kernel, om + l * om_s)
        if s is None:
            return None
        lam = s if lam is None else lam + s
    return lam / dx


def circulant_eigenvalues_analytic(
    kernel, x: jax.Array, shift, aliases: int = 8, num_harmonics: int = 256
):
    """Periodized-kernel circulant spectrum from the ANALYTIC density.

    Poisson summation: the DFT of the dx-sampled, L-periodized kernel is
    lam_k = (1/dx) sum_l S(o_k + l * 2 pi / dx), o_k = 2 pi k / L —
    exact for the periodization (which the Strang wrap equals whenever
    the kernel decays within n/2 cells), with the aliasing sum truncated
    at |l| <= ``aliases``.  The default aliases=8 keeps the truncation
    error of the POLYNOMIAL-tail Matern spectra below the 1e-4 oracle
    gate (measured: Matern-3/2 at aliases=2 was ~1.5e-3 in tail bins;
    the error falls ~L^-3); for SE the sum converges super-exponentially
    and any alias count >= 1 is exact to f64.  The periodic kernel is a
    LINE spectrum and folds exactly (periodic_line_bins) — no aliasing
    sum at all; sums of supported families recurse.

    The point (round-4): an f32 FFT of the sampled column cannot resolve
    spectral tails below ~eps * lam_max ~ 1e-3 at N=2^20 — the analytic
    form evaluates the tail DIRECTLY (underflow to 0 is graceful), so
    the additive noise floor s^2 stays exact in every bin.  Returns
    ``None`` if the kernel has no supported spectrum (RQ: Bessel-K
    form; products: convolution).
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    dx = x[1] - x[0]
    lam = _analytic_kernel_bins(kernel, n, dx, x.dtype, aliases,
                                num_harmonics)
    if lam is None:
        return None
    lam = lam + jnp.asarray(shift, x.dtype)
    # same absolute SPD guard as circulant_eigenvalues (shift == 0)
    return jnp.maximum(lam, jnp.finfo(lam.dtype).tiny)


def whittle_spectrum(kernel, x, noise, jitter: float = 0.0,
                     spectrum: str = "auto"):
    """The (n//2+1,) circulant spectrum the Whittle density uses.

    ``spectrum``: "auto" (analytic when the kernel has a closed-form
    density, else FFT), "analytic" (error if unsupported), "fft".
    Shared by whittle_log_marginal and the centered posterior in
    inference/gp_model.py so both describe the same model.
    """
    shift = jnp.square(jnp.asarray(noise)) + jitter
    if spectrum in ("auto", "analytic"):
        lam = circulant_eigenvalues_analytic(kernel, x, shift)
        if lam is not None:
            return lam
        if spectrum == "analytic":
            raise NotImplementedError(
                f"no closed-form spectral density for "
                f"{type(kernel).__name__}; use spectrum='fft'")
        if jnp.shape(x)[0] > 100_000:
            import warnings

            # the FFT spectrum's f32 round-off tail (~eps * lam_max) is
            # the same order as a realistic noise variance at n ~ 1e6 —
            # the measured round-4 failure mode (noise erased from the
            # high-frequency bins; round-4 forensics)
            warnings.warn(
                f"whittle_spectrum: no analytic spectrum for "
                f"{type(kernel).__name__}; falling back to the FFT "
                f"spectrum at n={jnp.shape(x)[0]}, whose f32 round-off "
                f"tail can bias the noise posterior at this scale.",
                stacklevel=2,
            )
    col = toeplitz_column(kernel, x)
    return circulant_eigenvalues(col, shift)


def _circulant_apply(lam: jax.Array, n: int, power: float):
    """v -> F^-1 diag(lam^power) F v — symmetric circulant application."""
    lp = jnp.power(lam, power)

    def apply(v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        fv = jnp.fft.rfft(v2, axis=0)
        out = jnp.fft.irfft(fv * lp[:, None], n=n, axis=0).astype(v2.dtype)
        return out[:, 0] if squeeze else out

    return apply


def strang_circulant_precond(col: jax.Array, shift):
    """v -> (C_s + shift I)^-1 v; O(n log n) build and apply.

    Use instead of the pivoted-Cholesky preconditioner on grids — CG only
    needs P ~ A, not P = A.
    """
    col = jnp.asarray(col)
    lam = circulant_eigenvalues(col, shift)
    return _circulant_apply(lam, col.shape[0], -1.0)


def circulant_logdet(lam: jax.Array, n: int) -> jax.Array:
    """Exact logdet of the circulant from its rfft spectrum.

    Interior rfft bins carry multiplicity 2 (conjugate pairs); DC and
    (for even n) Nyquist carry 1.
    """
    m = lam.shape[0]
    w = jnp.full((m,), 2.0, lam.dtype)
    w = w.at[0].set(1.0)
    if n % 2 == 0:
        w = w.at[m - 1].set(1.0)
    return jnp.sum(w * jnp.log(lam))


def whittle_log_marginal(kernel, x, y, noise, jitter: float = 0.0,
                         spectrum: str = "auto"):
    """EXACT log-density of the circulant surrogate model — the Whittle
    likelihood of GP regression on a uniform grid.

    Replaces K (symmetric Toeplitz) with its Strang circulant C_s; the
    resulting model N(0, C_s + s^2 I) has a closed-form log-density in
    the Fourier basis:

        lml_W = -1/2 sum_k w_k [ |y~_k|^2 / (n lam_k) + log lam_k ]
                - (n/2) log 2pi

    (y~ = rfft(y), lam = the circulant spectrum from whittle_spectrum —
    analytic aliased density when the kernel family has one, else the
    FFT spectrum with the kernel part rectified at zero; the noise
    variance s^2 is strictly ADDITIVE in every bin and never floored
    away — w_k the conjugate multiplicities).  Three O(n log n)/O(n)
    ops, fully deterministic and autodiff-differentiable through the
    kernel hyperparameters — no CG, no SLQ, no probes.

    MODEL SEMANTICS (measured, tests/test_toeplitz.py): the circulant
    model is a stationary GP on the CIRCLE of circumference n*dx — the
    two ends of the grid are treated as neighbors.  For data compatible
    with that boundary (periodic signals on an endpoint-exclusive grid —
    the common case for gridded time series windows), the gap to the
    exact line-GP lml is O(1) nats total with gradients agreeing to a
    few percent.  For data with a seam mismatch the gap grows ~linearly
    in n under infill — check your boundary before trusting the
    posterior.  Why it exists anyway: the stochastic PCG+SLQ surrogate
    at f32 was measured to acquire an O(10^4) systematic bias at N=2^20
    (fake long-lengthscale attractor), while this density is exact for
    its model and ~1000x cheaper per sampler step.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = y.shape[0]
    lam = whittle_spectrum(kernel, x, noise, jitter, spectrum)
    fy = jnp.fft.rfft(y)
    m = lam.shape[0]
    w = jnp.full((m,), 2.0, lam.dtype)
    w = w.at[0].set(1.0)
    if n % 2 == 0:
        w = w.at[m - 1].set(1.0)
    p_y = jnp.square(fy.real) + jnp.square(fy.imag)  # periodogram * n
    quad = jnp.sum(w * p_y / lam) / n
    logdet = jnp.sum(w * jnp.log(lam))
    return -0.5 * quad - 0.5 * logdet - 0.5 * n * jnp.log(2.0 * jnp.pi)


def slq_logdet_circulant(
    matvec, col: jax.Array, shift, key, num_probes: int, num_iters: int
):
    """SLQ estimate of logdet(A) with Strang-circulant preconditioning.

    Same identity as ops/krylov.py::slq_logdet_preconditioned (GPyTorch's
    preconditioned SLQ) with P = C_s + shift I:

        logdet(A) = logdet(P) + E_{z ~ N(0,P)}[(z^T P^-1 z) e1^T log(T) e1]

    logdet(P) is exact from the spectrum; z = P^(1/2) u is one FFT pair
    (P^(1/2) is the symmetric circulant with eigenvalues sqrt(lam)); T is
    the PCG Lanczos tridiagonal.  Everything is O(n log n) per probe
    iteration — the grid analogue of the pivoted-Cholesky SLQ at
    hard-conditioning large N.
    """
    from gaussian_processes_tpu.ops import krylov

    col = jnp.asarray(col)
    n = col.shape[0]
    lam = circulant_eigenvalues(col, shift)
    pre = _circulant_apply(lam, n, -1.0)
    half = _circulant_apply(lam, n, 0.5)
    u = jax.random.normal(key, (n, num_probes), col.dtype)
    probes = half(u)
    _, _, alphas, betas = krylov.pcg(
        matvec, pre, probes, num_iters=num_iters, tol=1e-12,
        return_tridiag=True,
    )
    probe_norms = jnp.sum(probes * pre(probes), axis=0)
    T = krylov.lanczos_tridiag_from_cg(alphas, betas)
    evals, evecs = jnp.linalg.eigh(T)
    w = jnp.square(evecs[:, 0, :])
    # physical Ritz floor: the preconditioned operator's spectrum is
    # >= shift / max(lam), so anything below is f32 Lanczos round-off —
    # clamping there bounds the damage garbage Ritz values can do
    # (log 1e-30 = -69 x probe_norms ~ n fabricated huge logdets at
    # kappa ~ 1e7; measured at N=2^20, STATUS round-2)
    floor = jnp.asarray(shift, lam.dtype) / jnp.max(lam)
    quad = jnp.sum(w * jnp.log(jnp.maximum(evals, floor)), axis=-1)
    return circulant_logdet(lam, n) + jnp.mean(probe_norms * quad)
