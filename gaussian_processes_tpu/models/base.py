"""Kernel base layer.

Capability parity with the reference's kernel contract
(gp/kernels/base.py [R], SURVEY.md §3 C3): an abstract kernel with

* ``__call__(x1, x2) -> K``            (n, m) covariance matrix
* ``jacobian(x1, x2) -> dK/dtheta``    (P, n, m)
* ``hessian(x1, x2) -> d2K/dtheta2``   (P, P, n, m)
* ``params`` get / ``with_params`` (functional set), ``copy()``
* ``sym_K()`` — the sympy symbolic kernel expression, used by the test
  suite to validate the hand-written closed forms (the analogue of the
  reference's "Cython matches sympy" gate).

Design (SURVEY.md §7): kernels are frozen dataclasses registered
as JAX pytrees whose leaves are the hyperparameters, so a kernel can be an
argument to ``jit``/``grad``/``vmap`` directly.  All pairwise math is
vectorized jnp on the difference matrix; the hot tiled path lives in
``ops/pairwise.py`` (Pallas) and shares the same elementwise cores.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def pairwise_diff(x1: jax.Array, x2: jax.Array) -> jax.Array:
    """Pairwise difference matrix d[i, j] = x1[i] - x2[j] for 1-D inputs."""
    x1 = jnp.asarray(x1)
    x2 = jnp.asarray(x2)
    return x1[:, None] - x2[None, :]


class Kernel(abc.ABC):
    """Abstract covariance kernel over 1-D inputs.

    Subclasses are frozen dataclasses whose fields are the hyperparameters
    (scalars, in the order of ``param_names``).
    """

    #: ordered hyperparameter names; subclasses override.
    param_names: tuple = ()

    # -- elementwise cores (shared by the jnp path and the Pallas path) ----

    @staticmethod
    @abc.abstractmethod
    def k_fn(d: jax.Array, *params: jax.Array) -> jax.Array:
        """Elementwise kernel value as a function of the difference d."""

    @staticmethod
    @abc.abstractmethod
    def jac_fn(d: jax.Array, *params: jax.Array) -> tuple:
        """Elementwise dK/dtheta, one array per parameter."""

    @staticmethod
    @abc.abstractmethod
    def hess_fn(d: jax.Array, *params: jax.Array) -> tuple:
        """Elementwise upper-triangle of d2K/dtheta2 in row-major order:
        ((0,0), (0,1), ..., (0,P-1), (1,1), ...)."""

    # -- public API ---------------------------------------------------------

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    @property
    def params(self) -> jax.Array:
        """Hyperparameters as a (P,) array, ordered as ``param_names``."""
        vals = [getattr(self, name) for name in self.param_names]
        return jnp.stack([jnp.asarray(v, dtype=jnp.result_type(*vals)) for v in vals])

    def with_params(self, theta) -> "Kernel":
        """Functional parameter update: a new kernel with params = theta."""
        theta = jnp.asarray(theta)
        kwargs = {name: theta[i] for i, name in enumerate(self.param_names)}
        return dataclasses.replace(self, **kwargs)

    def copy(self) -> "Kernel":
        return dataclasses.replace(self)

    def _param_values(self) -> tuple:
        return tuple(getattr(self, name) for name in self.param_names)

    #: whether the Pallas tile builder can evaluate this kernel (leaf
    #: kernels with a static elementwise ``k_fn`` over 1-D differences)
    supports_tiled = True

    def kdiag(self, xo: jax.Array) -> jax.Array:
        """diag(k(xo, xo)), shape (m,) — k(0) for stationary kernels."""
        m = xo.shape[0]
        k0 = self.k_fn(jnp.zeros(()), *self._param_values())
        return jnp.broadcast_to(k0, (m,))

    def __call__(self, x1: jax.Array, x2: jax.Array) -> jax.Array:
        """Covariance matrix K[i, j] = k(x1[i], x2[j]); shape (n, m)."""
        d = pairwise_diff(x1, x2)
        return self.k_fn(d, *self._param_values())

    def jacobian(self, x1: jax.Array, x2: jax.Array) -> jax.Array:
        """dK/dtheta stacked over parameters; shape (P, n, m)."""
        d = pairwise_diff(x1, x2)
        return jnp.stack(self.jac_fn(d, *self._param_values()))

    def hessian_pair(self, x1: jax.Array, x2: jax.Array,
                     p: int, q: int) -> jax.Array:
        """One (n, m) slice H[p, q] = d2K/(dtheta_p dtheta_q); p, q are
        static Python ints.

        The chunked log-likelihood Hessian (models/gp.py::
        _hessian_from_pieces_chunked) streams parameter pairs through
        this method; its one-slice-at-a-time peak-memory bound holds
        only if the implementation emits JUST the requested slice.
        This default picks a single closed-form expression out of
        ``hess_fn``'s upper-triangle tuple — the sibling expressions
        are independent elementwise ops XLA dead-code-eliminates under
        jit.  Kernels that override ``hessian`` with a fused/batched
        computation MUST override this too, or the chunked path
        silently re-materializes the (P, P, n, m) stack it exists to
        avoid (ADVICE r3; overrides: ard.py, composite.py)."""
        d = pairwise_diff(x1, x2)
        tri = self.hess_fn(d, *self._param_values())
        i, j = (p, q) if p <= q else (q, p)
        P = self.n_params
        return tri[i * P - (i * (i - 1)) // 2 + (j - i)]

    def hessian(self, x1: jax.Array, x2: jax.Array) -> jax.Array:
        """d2K/dtheta2; shape (P, P, n, m), symmetric in the first two axes."""
        d = pairwise_diff(x1, x2)
        tri = self.hess_fn(d, *self._param_values())
        P = self.n_params
        rows = []
        it = iter(range(len(tri)))
        idx = {}
        for i in range(P):
            for j in range(i, P):
                idx[(i, j)] = next(it)
        for i in range(P):
            row = [tri[idx[(min(i, j), max(i, j))]] for j in range(P)]
            rows.append(jnp.stack(row))
        return jnp.stack(rows)

    # -- symbolic ground truth (test oracle) --------------------------------

    @classmethod
    @abc.abstractmethod
    def sym_K(cls):
        """Sympy expression for k(d) and the ordered sympy parameter symbols.

        Returns (expr, d_symbol, (param_symbols...)).  Used only by tests to
        validate the closed-form jnp implementations; never on the hot path.
        """


def register_kernel_dataclass(cls):
    """Decorator: freeze + register a kernel dataclass as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls = jax.tree_util.register_dataclass(cls)
    return cls
