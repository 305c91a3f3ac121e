"""ChEES-HMC: jittered fixed-trajectory HMC with adaptive length.

The vectorized alternative to NUTS (SURVEY.md §7's "vectorized leapfrog"
taken to its conclusion).  NUTS saturates one device well below linear
chain scaling: every chain in
the vmapped batch waits for the deepest tree each transition, so most
lanes idle in masked while-loop iterations.  ChEES-HMC (Hoffman,
Radul & Sountsov, 2021-style scheme, implemented from the published
algorithm description) removes the trees entirely:

* every iteration runs ONE shared jittered trajectory length
  ``t = u * T`` (u ~ Uniform(0,1), same for all chains), so the leapfrog
  loop is a dense, fully-utilized batched computation — no masking;
* the mean trajectory length T adapts by stochastic gradient ascent on
  the ChEES criterion (Change in the Estimator of the Expected Square),
  whose per-chain gradient is
      (||z' - mu||^2 - ||z - mu||^2) * ((z' - mu) . v') * u
  with v' the final velocity and mu the cross-chain mean — large
  populations of parallel chains are exactly what makes this estimator
  work, matching the many-device design of this framework;
* step size adapts by the same dual averaging as NUTS (target acceptance
  0.651, the optimal for plain HMC), the diagonal mass matrix by the
  same windowed Welford machinery, and all cross-chain reductions go
  through the same pooling hooks, so ``parallel.sharded``-style chain
  sharding applies unchanged.

Same statistical gates as NUTS (tests/test_chees.py): analytic-target
moments within Monte-Carlo error, determinism, adaptation sanity.

CAVEAT — shared trajectory length on MULTISCALE posteriors (measured,
round-4 1M-point run): the population-shared T
is adapted for the bulk of the chains.  A chain sitting in a mode whose
curvature is much higher than the bulk's integrates ~full oscillation
periods per trajectory and proposes a point near its start — it keeps
ACCEPTING (energy error ~0) while moving sub-f32-ulp distances, which
presents as a frozen chain at accept ≈ 1 (draw std exactly 0).  Watch
``n_frozen_chains``-style per-chain std alongside R-hat; if modes with
very different scales are genuinely expected, NUTS (per-chain dynamic
trajectories) is the robust choice — with the measured lockstep
throughput cost.

Round-5 addendum (measured, the "period-resolution wall"):
a posterior coordinate can be narrower than the f32 ulp spacing of the
sampling coordinate itself (the period of a periodic kernel at n=2^20:
identification sharpens ~n^1.5).  Then NO f32 sampler moves that
coordinate — NUTS removes the freezes but the coordinate still pins,
and its zero variance starves pooled mass adaptation.  Fix the
coordinate at its point estimate (its uncertainty is sub-ulp anyway),
rescale it, or evaluate that marginal in f64 on the CPU backend.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_processes_tpu.inference import adaptation as adapt
from gaussian_processes_tpu.inference.nuts import ChainState, init_chain


class CheesInfo(NamedTuple):
    accept_prob: jax.Array  # (C,)
    num_leapfrog: jax.Array  # scalar (shared across chains)
    diverging: jax.Array  # (C,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CheesState:
    """Carry for the ChEES sampler scans (checkpointable pytree)."""

    chains: ChainState  # batched (C, ...)
    da: adapt.DualAveragingState  # step size
    welford: adapt.WelfordState  # mass matrix moments
    inv_mass: jax.Array  # (D,)
    step_size: jax.Array
    traj_length: jax.Array  # mean trajectory length T
    traj_m: jax.Array  # Adam first moment for log T
    traj_v: jax.Array  # Adam second moment for log T
    traj_count: jax.Array
    key: jax.Array


class CheesResult(NamedTuple):
    positions: jax.Array  # (S, C, D)
    log_probs: jax.Array
    accept_prob: jax.Array
    num_leapfrog: jax.Array  # (S,)
    diverging: jax.Array
    step_size: jax.Array
    traj_length: jax.Array
    inv_mass: jax.Array
    final: CheesState


def _default_reduce_mean(x):
    return jnp.mean(x)


def _default_reduce_welford(w):
    return w


def _hmc_trajectory(log_prob_fn, chains: ChainState, key, eps, n_steps, inv_mass,
                    shard_axis=None):
    """Batched leapfrog trajectory + MH accept for all chains at once.

    Under ``shard_map``, ``shard_axis`` folds the device index into the
    per-chain randomness so sharded chains draw independent momenta while
    the caller's shared key keeps the trajectory length synchronized.
    """
    C, D = chains.z.shape
    if shard_axis is not None:
        key = jax.random.fold_in(key, lax.axis_index(shard_axis))
    mom_key, acc_key = jax.random.split(key)
    xi = jax.random.normal(mom_key, (C, D), chains.z.dtype)
    r0 = xi / jnp.sqrt(inv_mass)[None, :]

    def kinetic(r):
        return 0.5 * jnp.sum(inv_mass[None, :] * r * r, axis=-1)

    def body(_, carry):
        z, r, logp, grad = carry
        r_half = r + 0.5 * eps * grad
        z = z + eps * inv_mass[None, :] * r_half
        logp, grad = jax.vmap(jax.value_and_grad(log_prob_fn))(z)
        r = r_half + 0.5 * eps * grad
        return z, r, logp, grad

    z1, r1, logp1, grad1 = lax.fori_loop(
        0, n_steps, body, (chains.z, r0, chains.logp, chains.grad)
    )

    energy0 = -chains.logp + kinetic(r0)
    energy1 = -logp1 + kinetic(r1)
    log_accept = energy0 - energy1  # (C,)
    finite = jnp.isfinite(log_accept)
    accept_prob = jnp.where(finite, jnp.exp(jnp.minimum(log_accept, 0.0)), 0.0)
    u = jax.random.uniform(acc_key, (C,), chains.z.dtype)
    take = (u < accept_prob) & finite

    new = ChainState(
        z=jnp.where(take[:, None], z1, chains.z),
        logp=jnp.where(take, logp1, chains.logp),
        grad=jnp.where(take[:, None], grad1, chains.grad),
    )
    # final velocity of the proposal, for the ChEES gradient
    v1 = inv_mass[None, :] * r1
    return new, z1, v1, accept_prob, ~finite


def _chees_grad(z0, z1, v1, accept_prob, u_jitter, reduce_mean,
                reduce_vec_mean):
    """Stochastic gradient of the ChEES criterion wrt trajectory time.

    NaN-safe: a blown-up trajectory (non-finite z1/v1, acceptance 0)
    must contribute zero, not poison the Adam moments for the rest of
    warmup (0 * NaN = NaN would otherwise stick T at NaN — observed in
    f32 accelerator runs).
    """
    finite = jnp.all(jnp.isfinite(z1), axis=-1) & jnp.all(
        jnp.isfinite(v1), axis=-1
    )  # (C,)
    z1s = jnp.where(finite[:, None], z1, z0)
    v1s = jnp.where(finite[:, None], v1, 0.0)
    mu0 = reduce_vec_mean(z0)  # (D,) cross-chain (and cross-device) mean
    mu1 = reduce_vec_mean(z1s)
    a = jnp.sum(jnp.square(z1s - mu1), axis=-1) - jnp.sum(
        jnp.square(z0 - mu0), axis=-1
    )  # (C,)
    b = jnp.sum((z1s - mu1) * v1s, axis=-1)  # (C,) d/dt ||z1 - mu||^2 / 2
    per_chain = jnp.where(finite, accept_prob * a * b * u_jitter, 0.0)
    denom = jnp.maximum(reduce_mean(accept_prob), 1e-4)
    g = reduce_mean(per_chain) / denom
    return jnp.where(jnp.isfinite(g), g, 0.0)


def chees_step(
    log_prob_fn,
    state: CheesState,
    *,
    adapt_traj: bool,
    flags=None,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    reduce_vec_mean=None,
    adam_lr: float = 0.025,
    shard_axis=None,
):
    """One ChEES-HMC iteration over all (local) chains."""
    if reduce_vec_mean is None:
        reduce_vec_mean = lambda x: jnp.mean(x, axis=0)
    key, jit_key, traj_key = jax.random.split(state.key, 3)
    eps = jnp.exp(state.da.log_step) if adapt_traj else state.step_size

    # the jitter key comes from the (device-shared) state key, so every
    # device in a sharded run integrates the same number of steps
    u_jitter = jax.random.uniform(jit_key, dtype=state.traj_length.dtype)
    t = u_jitter * state.traj_length
    n_steps = jnp.clip(
        jnp.ceil(t / eps).astype(jnp.int32), 1, max_leapfrog
    )

    z0 = state.chains.z
    chains, z1, v1, accept, nonfinite = _hmc_trajectory(
        log_prob_fn, state.chains, traj_key, eps, n_steps, state.inv_mass,
        shard_axis=shard_axis,
    )

    da = state.da
    welford = state.welford
    inv_mass = state.inv_mass
    traj_length = state.traj_length
    traj_m, traj_v, traj_count = state.traj_m, state.traj_v, state.traj_count
    step_size = state.step_size

    if adapt_traj:
        # HARMONIC mean of per-chain acceptance for step-size adaptation:
        # the arithmetic mean hides stuck chains (measured at N=2^20:
        # one chain frozen at ~0 acceptance leaves the pooled mean at
        # the 0.65 target, so the shared step size never shrinks for it
        # and split-R-hat = inf).  The harmonic mean is dominated by the
        # worst chains, throttling the population until every chain
        # moves; the 1e-3 floor keeps one pathological chain from
        # stalling adaptation outright.  Built from reduce_mean only, so
        # sharded runs pool it exactly (pmean of reciprocals).
        pooled_accept = 1.0 / reduce_mean(1.0 / jnp.maximum(accept, 1e-3))
        da = adapt.da_update(da, pooled_accept, target_accept=target_accept)

        # ChEES trajectory-length adaptation: Adam on log T with the
        # normalized stochastic gradient (ascent)
        g = _chees_grad(z0, z1, v1, accept, u_jitter, reduce_mean,
                        reduce_vec_mean)
        g = g / (jnp.abs(g) + 1e-10)  # sign-ish normalization (robust)
        tc = traj_count + 1
        b1, b2 = 0.9, 0.999
        traj_m = b1 * traj_m + (1 - b1) * g
        traj_v = b2 * traj_v + (1 - b2) * g * g
        mhat = traj_m / (1 - b1 ** tc.astype(traj_m.dtype))
        vhat = traj_v / (1 - b2 ** tc.astype(traj_v.dtype))
        log_T = jnp.log(traj_length) + adam_lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        traj_length = jnp.exp(log_T)
        traj_count = tc

        welford = jax.tree.map(
            lambda new, old: jnp.where(flags["in_slow"], new, old),
            adapt.welford_update_batch(welford, chains.z),
            welford,
        )
        pooled = reduce_welford(welford)
        new_inv_mass = adapt.welford_variance(pooled)
        inv_mass = jnp.where(flags["window_end"], new_inv_mass, inv_mass)
        welford = jax.tree.map(
            lambda zed, w: jnp.where(flags["window_end"], zed, w),
            adapt.welford_init(inv_mass.shape[0], inv_mass.dtype),
            welford,
        )
        da = jax.tree.map(
            lambda r, d: jnp.where(flags["window_end"], r, d),
            adapt.da_init(jnp.exp(da.log_step)),
            da,
        )
        final_step = jnp.exp(da.log_avg_step)
        step_size = jnp.where(flags["last"], final_step, jnp.exp(da.log_step))

    new_state = CheesState(
        chains=chains,
        da=da,
        welford=welford,
        inv_mass=inv_mass,
        step_size=step_size,
        traj_length=traj_length,
        traj_m=traj_m,
        traj_v=traj_v,
        traj_count=traj_count,
        key=key,
    )
    info = CheesInfo(
        accept_prob=accept, num_leapfrog=n_steps, diverging=nonfinite
    )
    return new_state, info


def sample_chees(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    num_warmup: int = 500,
    num_samples: int = 1000,
    *,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    reduce_vec_mean=None,
    chunk_size: int | None = None,
    shard_axis=None,
) -> CheesResult:
    """ChEES-HMC over C vectorized chains: warmup (step size, mass matrix,
    trajectory length) then fixed-settings collection."""
    dtype = init_position.dtype
    chains = jax.vmap(lambda z: init_chain(log_prob_fn, z))(init_position)
    dim = init_position.shape[-1]
    state = CheesState(
        chains=chains,
        da=adapt.da_init(jnp.asarray(init_step_size, dtype)),
        welford=adapt.welford_init(dim, dtype),
        inv_mass=jnp.ones((dim,), dtype),
        step_size=jnp.asarray(init_step_size, dtype),
        traj_length=jnp.asarray(init_traj_length, dtype),
        traj_m=jnp.zeros((), dtype),
        traj_v=jnp.zeros((), dtype),
        traj_count=jnp.zeros((), jnp.int32),
        key=key,
    )
    schedule = adapt.build_warmup_schedule(num_warmup)

    def wstep(s, flags):
        s, _ = chees_step(
            log_prob_fn, s, adapt_traj=True, flags=flags,
            target_accept=target_accept, max_leapfrog=max_leapfrog,
            reduce_mean=reduce_mean, reduce_welford=reduce_welford,
            reduce_vec_mean=reduce_vec_mean, shard_axis=shard_axis,
        )
        return s, None

    def run_warmup(s, flags):
        return lax.scan(wstep, s, flags)[0]

    if chunk_size is None or chunk_size >= num_warmup:
        state = run_warmup(state, schedule)
    else:
        run_j = jax.jit(run_warmup)
        done = 0
        while done < num_warmup:
            step = min(chunk_size, num_warmup - done)
            flags = jax.tree.map(lambda a: a[done : done + step], schedule)
            state = run_j(state, flags)
            done += step

    def cstep(s, _):
        s, info = chees_step(
            log_prob_fn, s, adapt_traj=False,
            max_leapfrog=max_leapfrog,
            reduce_mean=reduce_mean, reduce_welford=reduce_welford,
            reduce_vec_mean=reduce_vec_mean, shard_axis=shard_axis,
        )
        out = (s.chains.z, s.chains.logp, info.accept_prob,
               info.num_leapfrog, info.diverging)
        return s, out

    def run_collect(s, length):
        return lax.scan(cstep, s, None, length=length)

    if chunk_size is None or chunk_size >= num_samples:
        state, outs = run_collect(state, num_samples)
        zs, lps, accs, nls, divs = outs
    else:
        run_j = jax.jit(run_collect, static_argnums=1)
        chunks = []
        done = 0
        while done < num_samples:
            step = min(chunk_size, num_samples - done)
            state, out = run_j(state, step)
            chunks.append(out)
            done += step
        zs, lps, accs, nls, divs = (
            jnp.concatenate([c[i] for c in chunks]) for i in range(5)
        )
    return CheesResult(
        positions=zs,
        log_probs=lps,
        accept_prob=accs,
        num_leapfrog=nls,
        diverging=divs,
        step_size=state.step_size,
        traj_length=state.traj_length,
        inv_mass=state.inv_mass,
        final=state,
    )
