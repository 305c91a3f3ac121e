"""From-scratch No-U-Turn Sampler, designed for vectorized accelerator execution.

The reference library ships analytic log-likelihood gradients as the hook
for external samplers (SURVEY.md §1, §4.4); BASELINE.json:5,9,11 makes
fully Bayesian hyperparameter inference via NUTS/HMC a first-class
subsystem of this framework, scaled to many vectorized chains per device and
chain sharding across hosts.

Design constraints (SURVEY.md §7 M2 — "iterative NUTS with static bounds
and masking so it vmaps"):

* **No recursion, no data-dependent Python control flow.**  Tree doubling
  is a ``lax.while_loop`` over depths; each subtree is a ``lax.while_loop``
  over at most ``2**depth`` leapfrog steps.  Everything is fixed-shape, so
  one chain traces once and ``vmap``/``shard_map`` batch it (JAX's
  while-loop batching rule masks finished lanes).
* **Iterative U-turn bookkeeping in O(max_depth) memory.**  Within a
  subtree, leaf ``i`` (0-indexed) is checkpointed at slot
  ``popcount(i)`` when ``i`` is even; a complete sub-subtree of size
  ``2**k`` ending at leaf ``i`` (``2**k`` divides ``i+1``) is U-turn
  checked against the checkpoint at slot ``popcount(i + 1 - 2**k)``.
  Proof sketch of no slot collision: if even leaves ``j1 < j2`` share a
  slot and ``j2`` lands inside ``j1``'s live range ``[j1, j1 +
  2**tz(j1))``, then ``j2``'s low ``tz(j1)`` bits are nonzero while its
  high bits equal ``j1``'s, forcing ``popcount(j2) > popcount(j1)`` —
  contradiction.  (Same memory-efficient scheme family as public iterative
  NUTS implementations; derived independently here, validated by tests.)
* **Multinomial (biased-progressive) sampling** over the trajectory:
  leaves carry weight ``exp(energy0 - energy_leaf)``; subtrees resample
  progressively; a completed subtree replaces the tree proposal with
  probability ``min(1, w_subtree / w_tree)``.
* **Direction handling:** the backward edge stores its momentum negated,
  so every subtree is built as a *forward* integration from its edge and
  the U-turn algebra needs no direction cases; the cross-tree check
  un-negates the backward momentum.
* Divergences (energy error > ``max_delta_energy``, or non-finite) stop
  tree growth; NaN compares are arranged to register as divergent.

The target density is any ``log_prob_fn(position) -> scalar`` (gradients
via ``jax.value_and_grad``); for GP hyperparameter posteriors see
``inference/gp_model.py``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from gaussian_processes_tpu.inference import adaptation as adapt


class ChainState(NamedTuple):
    """Per-chain state: position, log density, and its gradient."""

    z: jax.Array
    logp: jax.Array
    grad: jax.Array


class TransitionInfo(NamedTuple):
    accept_prob: jax.Array
    num_leapfrog: jax.Array
    diverging: jax.Array
    turning: jax.Array
    depth: jax.Array
    energy: jax.Array


def init_chain(log_prob_fn: Callable, z: jax.Array) -> ChainState:
    logp, grad = jax.value_and_grad(log_prob_fn)(z)
    return ChainState(z=z, logp=logp, grad=grad)


def _leapfrog(log_prob_fn, z, r, grad, eps, inv_mass):
    r_half = r + 0.5 * eps * grad
    z_new = z + eps * inv_mass * r_half
    logp, grad_new = jax.value_and_grad(log_prob_fn)(z_new)
    r_new = r_half + 0.5 * eps * grad_new
    return z_new, r_new, logp, grad_new


def _kinetic(r, inv_mass):
    return 0.5 * jnp.sum(inv_mass * r * r)


def _uturn(dz, r_a, r_b, inv_mass):
    """Original NUTS criterion on the span dz = z_b - z_a (diag metric)."""
    return (jnp.dot(dz, inv_mass * r_a) < 0) | (jnp.dot(dz, inv_mass * r_b) < 0)


class _SubtreeCarry(NamedTuple):
    i: jax.Array  # next leaf index within the subtree
    z_e: jax.Array  # forward edge of the subtree (continues with +eps)
    r_e: jax.Array
    grad_e: jax.Array
    logp_e: jax.Array
    z_p: jax.Array  # subtree proposal
    logp_p: jax.Array
    grad_p: jax.Array
    lsw: jax.Array  # log sum of leaf weights in the subtree
    ckpt_z: jax.Array  # (max_depth + 1, D) checkpoint positions
    ckpt_r: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_acc: jax.Array
    n_leaves: jax.Array
    key: jax.Array


def _trailing_zeros(m):
    return lax.population_count(jnp.bitwise_and(m, -m) - 1)


def _build_subtree(
    log_prob_fn,
    depth,
    edge,
    eps,
    inv_mass,
    energy0,
    max_depth,
    max_delta_energy,
    key,
    dtype,
):
    """Integrate 2**depth leapfrog steps forward from ``edge``.

    Returns the subtree carry after the loop; callers must treat the
    subtree as rejected if it is turning or diverging.
    """
    z0, r0, grad0, logp0 = edge
    dim = z0.shape[0]
    n_slots = max_depth + 1
    neg_inf = jnp.array(-jnp.inf, dtype)
    carry = _SubtreeCarry(
        i=jnp.zeros((), jnp.int32),
        z_e=z0,
        r_e=r0,
        grad_e=grad0,
        logp_e=logp0,
        z_p=z0,
        logp_p=logp0,
        grad_p=grad0,
        lsw=neg_inf,
        ckpt_z=jnp.zeros((n_slots, dim), dtype),
        ckpt_r=jnp.zeros((n_slots, dim), dtype),
        turning=jnp.zeros((), bool),
        diverging=jnp.zeros((), bool),
        sum_acc=jnp.zeros((), dtype),
        n_leaves=jnp.zeros((), jnp.int32),
        key=key,
    )
    n_leaf_target = lax.shift_left(jnp.ones((), jnp.int32), depth)

    def cond(c: _SubtreeCarry):
        return (c.i < n_leaf_target) & ~c.turning & ~c.diverging

    def body(c: _SubtreeCarry) -> _SubtreeCarry:
        key, sub = jax.random.split(c.key)
        z, r, logp, grad = _leapfrog(
            log_prob_fn, c.z_e, c.r_e, c.grad_e, eps, inv_mass
        )
        energy = -logp + _kinetic(r, inv_mass)
        lw = energy0 - energy  # log leaf weight; NaN ⇒ divergent below
        diverging = ~(lw > -max_delta_energy)
        # NaN-safe accept statistic: a non-finite leaf (failed Cholesky,
        # blown-up trajectory) counts as acceptance 0, not NaN — one bad
        # leaf must not poison dual averaging for the rest of warmup.
        acc_leaf = jnp.where(jnp.isfinite(lw), jnp.exp(jnp.minimum(lw, 0.0)), 0.0)
        sum_acc = c.sum_acc + acc_leaf

        # progressive multinomial proposal within the subtree
        lsw = jnp.logaddexp(c.lsw, lw)
        take = jax.random.uniform(sub, dtype=dtype) < jnp.exp(lw - lsw)
        z_p = jnp.where(take, z, c.z_p)
        logp_p = jnp.where(take, logp, c.logp_p)
        grad_p = jnp.where(take, grad, c.grad_p)

        # checkpoint even leaves at slot popcount(i)
        i = c.i
        slot = lax.population_count(i)
        is_even = (i % 2) == 0
        ckpt_z = jnp.where(
            is_even, c.ckpt_z.at[slot].set(z), c.ckpt_z
        )
        ckpt_r = jnp.where(
            is_even, c.ckpt_r.at[slot].set(r), c.ckpt_r
        )

        # U-turn checks for every complete sub-subtree ending at leaf i
        ip1 = i + 1
        n_checks = _trailing_zeros(ip1)

        def check(k, turning):
            j = ip1 - jnp.left_shift(1, k).astype(jnp.int32)
            s = lax.population_count(j)
            dz = z - ckpt_z[s]
            turn = _uturn(dz, ckpt_r[s], r, inv_mass)
            return turning | ((k <= n_checks) & turn)

        turning = lax.fori_loop(1, max_depth + 1, check, c.turning)

        return _SubtreeCarry(
            i=i + 1,
            z_e=z,
            r_e=r,
            grad_e=grad,
            logp_e=logp,
            z_p=z_p,
            logp_p=logp_p,
            grad_p=grad_p,
            lsw=lsw,
            ckpt_z=ckpt_z,
            ckpt_r=ckpt_r,
            turning=turning,
            diverging=c.diverging | diverging,
            sum_acc=sum_acc,
            n_leaves=c.n_leaves + 1,
            key=key,
        )

    return lax.while_loop(cond, body, carry)


class _TreeCarry(NamedTuple):
    z_bwd: jax.Array  # backward edge; momentum stored NEGATED
    r_bwd: jax.Array
    grad_bwd: jax.Array
    logp_bwd: jax.Array
    z_fwd: jax.Array
    r_fwd: jax.Array
    grad_fwd: jax.Array
    logp_fwd: jax.Array
    z_p: jax.Array
    logp_p: jax.Array
    grad_p: jax.Array
    lsw: jax.Array
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_acc: jax.Array
    n_leaves: jax.Array
    key: jax.Array


@partial(jax.jit, static_argnums=(0, 5))
def nuts_transition(
    log_prob_fn: Callable,
    state: ChainState,
    key: jax.Array,
    step_size,
    inv_mass,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
):
    """One NUTS transition for a single chain; ``vmap`` for many chains."""
    dtype = state.z.dtype
    eps = jnp.asarray(step_size, dtype)
    inv_mass = jnp.broadcast_to(jnp.asarray(inv_mass, dtype), state.z.shape)
    mom_key, loop_key = jax.random.split(key)

    # r ~ N(0, M) with M^{-1} = inv_mass (diagonal)
    xi = jax.random.normal(mom_key, state.z.shape, dtype)
    r0 = xi / jnp.sqrt(inv_mass)
    energy0 = -state.logp + _kinetic(r0, inv_mass)

    carry = _TreeCarry(
        z_bwd=state.z,
        r_bwd=-r0,
        grad_bwd=state.grad,
        logp_bwd=state.logp,
        z_fwd=state.z,
        r_fwd=r0,
        grad_fwd=state.grad,
        logp_fwd=state.logp,
        z_p=state.z,
        logp_p=state.logp,
        grad_p=state.grad,
        lsw=jnp.zeros((), dtype),  # initial point has log weight 0
        depth=jnp.zeros((), jnp.int32),
        turning=jnp.zeros((), bool),
        diverging=jnp.zeros((), bool),
        sum_acc=jnp.zeros((), dtype),
        n_leaves=jnp.zeros((), jnp.int32),
        key=loop_key,
    )

    def cond(c: _TreeCarry):
        return (c.depth < max_depth) & ~c.turning & ~c.diverging

    def body(c: _TreeCarry) -> _TreeCarry:
        key, dir_key, sub_key, merge_key = jax.random.split(c.key, 4)
        go_fwd = jax.random.bernoulli(dir_key)

        edge = (
            jnp.where(go_fwd, c.z_fwd, c.z_bwd),
            jnp.where(go_fwd, c.r_fwd, c.r_bwd),
            jnp.where(go_fwd, c.grad_fwd, c.grad_bwd),
            jnp.where(go_fwd, c.logp_fwd, c.logp_bwd),
        )
        sub = _build_subtree(
            log_prob_fn,
            c.depth,
            edge,
            eps,
            inv_mass,
            energy0,
            max_depth,
            max_delta_energy,
            sub_key,
            dtype,
        )

        ok = ~sub.turning & ~sub.diverging

        # extend the chosen edge only when the subtree completed
        upd_f = ok & go_fwd
        upd_b = ok & ~go_fwd
        z_fwd = jnp.where(upd_f, sub.z_e, c.z_fwd)
        r_fwd = jnp.where(upd_f, sub.r_e, c.r_fwd)
        grad_fwd = jnp.where(upd_f, sub.grad_e, c.grad_fwd)
        logp_fwd = jnp.where(upd_f, sub.logp_e, c.logp_fwd)
        z_bwd = jnp.where(upd_b, sub.z_e, c.z_bwd)
        r_bwd = jnp.where(upd_b, sub.r_e, c.r_bwd)
        grad_bwd = jnp.where(upd_b, sub.grad_e, c.grad_bwd)
        logp_bwd = jnp.where(upd_b, sub.logp_e, c.logp_bwd)

        # biased progressive proposal swap
        p_take = jnp.minimum(1.0, jnp.exp(sub.lsw - c.lsw))
        take = ok & (jax.random.uniform(merge_key, dtype=dtype) < p_take)
        z_p = jnp.where(take, sub.z_p, c.z_p)
        logp_p = jnp.where(take, sub.logp_p, c.logp_p)
        grad_p = jnp.where(take, sub.grad_p, c.grad_p)
        lsw = jnp.where(ok, jnp.logaddexp(c.lsw, sub.lsw), c.lsw)

        # cross-tree U-turn over the full extended trajectory
        dz = z_fwd - z_bwd
        cross = _uturn(dz, -r_bwd, r_fwd, inv_mass)
        turning = sub.turning | (ok & cross)

        return _TreeCarry(
            z_bwd=z_bwd,
            r_bwd=r_bwd,
            grad_bwd=grad_bwd,
            logp_bwd=logp_bwd,
            z_fwd=z_fwd,
            r_fwd=r_fwd,
            grad_fwd=grad_fwd,
            logp_fwd=logp_fwd,
            z_p=z_p,
            logp_p=logp_p,
            grad_p=grad_p,
            lsw=lsw,
            depth=c.depth + 1,
            turning=turning,
            diverging=c.diverging | sub.diverging,
            sum_acc=c.sum_acc + sub.sum_acc,
            n_leaves=c.n_leaves + sub.n_leaves,
            key=key,
        )

    out = lax.while_loop(cond, body, carry)

    new_state = ChainState(z=out.z_p, logp=out.logp_p, grad=out.grad_p)
    nl = jnp.maximum(out.n_leaves, 1)
    info = TransitionInfo(
        accept_prob=out.sum_acc / nl.astype(dtype),
        num_leapfrog=out.n_leaves,
        diverging=out.diverging,
        turning=out.turning,
        depth=out.depth,
        energy=-out.logp_p,
    )
    return new_state, info


# ---------------------------------------------------------------------------
# Sampler driver: windowed warmup + collection, many vectorized chains
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Carry for the warmup/collection scans (checkpointable pytree)."""

    chains: ChainState  # batched over chains (C, ...)
    da: adapt.DualAveragingState
    welford: adapt.WelfordState
    inv_mass: jax.Array
    step_size: jax.Array
    key: jax.Array


class NUTSResult(NamedTuple):
    positions: jax.Array  # (num_samples, C, D)
    log_probs: jax.Array  # (num_samples, C)
    accept_prob: jax.Array  # (num_samples, C)
    num_leapfrog: jax.Array  # (num_samples, C)
    diverging: jax.Array  # (num_samples, C) bool
    step_size: jax.Array
    inv_mass: jax.Array
    final: SamplerState


def _default_reduce_mean(x):
    return jnp.mean(x)


def _default_reduce_welford(w):
    return w


def init_sampler_state(
    log_prob_fn, init_position, key, init_step_size=0.1
) -> SamplerState:
    """Batched init: ``init_position`` has shape (C, D)."""
    chains = jax.vmap(lambda z: init_chain(log_prob_fn, z))(init_position)
    dim = init_position.shape[-1]
    dtype = init_position.dtype
    return SamplerState(
        chains=chains,
        da=adapt.da_init(jnp.asarray(init_step_size, dtype)),
        welford=adapt.welford_init(dim, dtype),
        inv_mass=jnp.ones((dim,), dtype),
        step_size=jnp.asarray(init_step_size, dtype),
        key=key,
    )


def warmup_step(
    log_prob_fn,
    state: SamplerState,
    flags,
    *,
    max_depth=10,
    target_accept=0.8,
    max_delta_energy=1000.0,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
):
    """One adaptive warmup step over all (local) chains.

    ``flags`` is a dict of scalars from ``adapt.build_warmup_schedule``.
    ``reduce_mean``/``reduce_welford`` are the cross-device pooling hooks
    (identity/local-mean by default; ``parallel/sharded.py`` supplies
    psum-based versions so 1024 sharded chains adapt as one population).
    """
    key, tkey = jax.random.split(state.key)
    n_chains = state.chains.z.shape[0]
    tkeys = jax.random.split(tkey, n_chains)
    step_size = jnp.exp(state.da.log_step)
    chains, info = jax.vmap(
        lambda cs, k: nuts_transition(
            log_prob_fn, cs, k, step_size, state.inv_mass,
            max_depth, max_delta_energy,
        )
    )(state.chains, tkeys)

    accept = reduce_mean(info.accept_prob)
    da = adapt.da_update(state.da, accept, target_accept=target_accept)

    welford = jax.tree.map(
        lambda new, old: jnp.where(flags["in_slow"], new, old),
        adapt.welford_update_batch(state.welford, chains.z),
        state.welford,
    )

    # window end: refresh inv-mass from the pooled estimate, reset moments,
    # restart dual averaging at the current step size
    pooled = reduce_welford(welford)
    new_inv_mass = adapt.welford_variance(pooled)
    inv_mass = jnp.where(flags["window_end"], new_inv_mass, state.inv_mass)
    welford = jax.tree.map(
        lambda z, w: jnp.where(flags["window_end"], z, w),
        adapt.welford_init(state.inv_mass.shape[0], state.inv_mass.dtype),
        welford,
    )
    da = jax.tree.map(
        lambda r, d: jnp.where(flags["window_end"], r, d),
        adapt.da_init(jnp.exp(da.log_step)),
        da,
    )

    # final warmup step: freeze the averaged step size
    final_step = jnp.exp(da.log_avg_step)
    step_out = jnp.where(flags["last"], final_step, jnp.exp(da.log_step))

    return (
        SamplerState(
            chains=chains,
            da=da,
            welford=welford,
            inv_mass=inv_mass,
            step_size=step_out,
            key=key,
        ),
        info,
    )


def sample_step(
    log_prob_fn,
    state: SamplerState,
    *,
    max_depth=10,
    max_delta_energy=1000.0,
):
    """One non-adaptive collection step over all (local) chains."""
    key, tkey = jax.random.split(state.key)
    tkeys = jax.random.split(tkey, state.chains.z.shape[0])
    chains, info = jax.vmap(
        lambda cs, k: nuts_transition(
            log_prob_fn, cs, k, state.step_size, state.inv_mass,
            max_depth, max_delta_energy,
        )
    )(state.chains, tkeys)
    return dataclasses.replace(state, chains=chains, key=key), info


def collect(
    log_prob_fn: Callable,
    state: SamplerState,
    num_samples: int,
    *,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
    chunk_size: int | None = None,
) -> NUTSResult:
    """Non-adaptive collection from an existing ``SamplerState``.

    The checkpoint/resume entry point (SURVEY.md §6.4): ``state`` is a
    plain pytree, so ``utils.checkpoint.save_pytree(path, result.final)``
    then ``collect(fn, load_pytree(path, like), k)`` continues the chain
    bit-identically (resume invariance is tested).

    ``chunk_size`` splits the scan into multiple device dispatches of at
    most that many transitions.  Semantically identical (the carry is the
    same pytree); use it when a single device execution would run long
    enough to trip an external time limit, or to
    interleave host-side logging/checkpointing.
    """

    def cstep(s, _):
        s, info = sample_step(
            log_prob_fn, s, max_depth=max_depth, max_delta_energy=max_delta_energy
        )
        out = (
            s.chains.z,
            s.chains.logp,
            info.accept_prob,
            info.num_leapfrog,
            info.diverging,
        )
        return s, out

    def run_scan(s, length):
        return lax.scan(cstep, s, None, length=length)

    if chunk_size is None or chunk_size >= num_samples:
        state, (zs, lps, accs, nls, divs) = run_scan(state, num_samples)
    else:
        run_j = jax.jit(run_scan, static_argnums=1)
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
    return NUTSResult(
        positions=zs,
        log_probs=lps,
        accept_prob=accs,
        num_leapfrog=nls,
        diverging=divs,
        step_size=state.step_size,
        inv_mass=state.inv_mass,
        final=state,
    )


def warmup(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    num_warmup: int = 500,
    *,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    max_delta_energy: float = 1000.0,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    chunk_size: int | None = None,
) -> SamplerState:
    """Run the adaptive warmup alone; pair with ``collect`` to sample.

    ``chunk_size`` as in ``collect``: split the warmup scan into several
    shorter device executions with identical semantics.
    """
    state = init_sampler_state(log_prob_fn, init_position, key, init_step_size)
    schedule = adapt.build_warmup_schedule(num_warmup)

    def wstep(s, flags):
        s, _ = warmup_step(
            log_prob_fn,
            s,
            flags,
            max_depth=max_depth,
            target_accept=target_accept,
            max_delta_energy=max_delta_energy,
            reduce_mean=reduce_mean,
            reduce_welford=reduce_welford,
        )
        return s, None

    if chunk_size is None or chunk_size >= num_warmup:
        state, _ = lax.scan(wstep, state, schedule, length=num_warmup)
        return state

    run_j = jax.jit(
        lambda s, flags: lax.scan(wstep, s, flags)[0]
    )
    done = 0
    while done < num_warmup:
        step = min(chunk_size, num_warmup - done)
        flags = jax.tree.map(lambda a: a[done : done + step], schedule)
        state = run_j(state, flags)
        done += step
    return state


def sample_nuts(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    num_warmup: int = 500,
    num_samples: int = 1000,
    *,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
    max_delta_energy: float = 1000.0,
    reduce_mean=_default_reduce_mean,
    reduce_welford=_default_reduce_welford,
    chunk_size: int | None = None,
) -> NUTSResult:
    """Windowed-warmup NUTS over ``C`` vectorized chains.

    Args:
      log_prob_fn: unnormalized log density of one position (D,).
      init_position: (C, D) initial positions (C chains).
      key: PRNG key.

    The whole sampler is one ``jit``-able pure function: warmup and
    collection are ``lax.scan``s of masked adaptive steps, so it vmaps
    over problems and shard_maps over devices (SURVEY.md §6.8).
    """
    state = warmup(
        log_prob_fn,
        init_position,
        key,
        num_warmup,
        max_depth=max_depth,
        target_accept=target_accept,
        init_step_size=init_step_size,
        max_delta_energy=max_delta_energy,
        reduce_mean=reduce_mean,
        reduce_welford=reduce_welford,
        chunk_size=chunk_size,
    )
    return collect(
        log_prob_fn,
        state,
        num_samples,
        max_depth=max_depth,
        max_delta_energy=max_delta_energy,
        chunk_size=chunk_size,
    )
