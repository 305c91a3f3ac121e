"""Chain-parallel NUTS / ChEES-HMC over a device mesh.

The reference has no parallelism at all (SURVEY.md §3 "Parallelism &
communication inventory": none).  This module is the data/chain
parallel axis required by BASELINE.json:9,11: sampler chains sharded over
a ``jax.sharding.Mesh`` with ``shard_map``, warmup adaptation pooled
across the *entire* chain population via XLA collectives —
``pmean`` of acceptance statistics and an exact cross-device Welford merge
(``psum`` of M2 corrections) — so 1024 sharded chains adapt exactly as one
vectorized population (the NCCL/MPI analogue, SURVEY.md §6.8).

Round-2 redesign (VERDICT r1 item 3): the sharded samplers are split into
``init / warmup / collect`` stages carried by an explicit sharded state
pytree, with **host-level chunking between shard_map dispatches** and the
final state exposed, so the flagship 1024-chain run is checkpointable,
resumable, and short per dispatch — the same durability the single-device path
had in round 1 (SURVEY.md §6.3/§6.4).  Chunking is semantics-preserving:
the carry crossing the host boundary is the same pytree the on-device
scan would carry.

Determinism: per-device NUTS RNG keys are derived once at init by folding
the device's mesh index into the caller's key and then ride in the state
(shape (n_devices,), sharded), so results at a fixed device count are
reproducible and resume-invariant (SURVEY.md §6.2).  ChEES keeps its key
replicated — the algorithm needs every device to integrate the same
jittered trajectory length — and folds the device index per step for
momenta only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_processes_tpu.inference import adaptation as adapt
from gaussian_processes_tpu.inference import chees as chees_mod
from gaussian_processes_tpu.inference import nuts as nuts_mod
from gaussian_processes_tpu.inference.nuts import ChainState


def make_chain_mesh(n_devices: int | None = None, axis: str = "chain") -> Mesh:
    """1-D mesh over (the first n) local+addressable devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (axis,))


def _pooled_reducers(axis: str):
    """Cross-device pooling hooks for warmup adaptation.

    With equal per-device chain counts, pmean of local means is the exact
    global mean; the Welford merge adds the between-device mean-shift
    correction to M2 (Chan et al.), so the pooled variance is exactly what
    a single-device run over all chains would compute.
    """

    def reduce_mean(x):
        return lax.pmean(jnp.mean(x), axis)

    def reduce_welford(w):
        mean_g = lax.pmean(w.mean, axis)
        m2_g = lax.psum(w.m2 + w.count * jnp.square(w.mean - mean_g), axis)
        count_g = lax.psum(w.count, axis)
        return type(w)(mean=mean_g, m2=m2_g, count=count_g)

    return reduce_mean, reduce_welford


# ---------------------------------------------------------------------------
# NUTS: sharded state + init / warmup / collect
# ---------------------------------------------------------------------------


class ShardedNUTSState(NamedTuple):
    """Global view of a chain-sharded ``nuts.SamplerState``.

    ``chains`` is the global (C, ...) block sharded over the mesh axis;
    adaptation state (``da``/``welford``/``inv_mass``/``step_size``) is
    replicated (it is a pure function of pooled statistics); ``keys`` is
    one PRNG key per device, sharded, so per-device randomness survives
    the host boundary between chunked dispatches.

    A plain pytree: ``utils.checkpoint.save_pytree`` checkpoints it, and
    ``shard_put_nuts`` re-places a host-loaded copy onto a mesh.
    """

    chains: ChainState
    da: adapt.DualAveragingState
    welford: adapt.WelfordState
    inv_mass: jax.Array
    step_size: jax.Array
    keys: jax.Array  # (n_devices,) typed PRNG keys


class ShardedNUTSResult(NamedTuple):
    positions: jax.Array  # (S, C, D) — C = global chain count
    log_probs: jax.Array  # (S, C)
    accept_prob: jax.Array  # (S, C)
    num_leapfrog: jax.Array  # (S, C)
    diverging: jax.Array  # (S, C)
    step_size: jax.Array  # scalar, identical on every device
    inv_mass: jax.Array  # (D,), identical on every device
    final: "ShardedNUTSState"  # resume/checkpoint entry point


def _nuts_state_specs(axis: str) -> ShardedNUTSState:
    return ShardedNUTSState(
        chains=P(axis),  # pytree prefix: every chain leaf sharded on dim 0
        da=P(),
        welford=P(),
        inv_mass=P(),
        step_size=P(),
        keys=P(axis),
    )


def _to_local(state: ShardedNUTSState) -> nuts_mod.SamplerState:
    return nuts_mod.SamplerState(
        chains=state.chains,
        da=state.da,
        welford=state.welford,
        inv_mass=state.inv_mass,
        step_size=state.step_size,
        key=state.keys[0],
    )


def _to_sharded(s: nuts_mod.SamplerState) -> ShardedNUTSState:
    return ShardedNUTSState(
        chains=s.chains,
        da=s.da,
        welford=s.welford,
        inv_mass=s.inv_mass,
        step_size=s.step_size,
        keys=s.key[None],
    )


def shard_put_nuts(
    state: ShardedNUTSState, mesh: Mesh, axis: str = "chain"
) -> ShardedNUTSState:
    """Place a (host-loaded) sharded-NUTS state onto ``mesh`` — the
    resume-from-checkpoint companion of ``save_pytree``/``load_pytree``."""
    specs = _nuts_state_specs(axis)
    # expand the pytree-prefix specs to per-leaf NamedShardings
    def put(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return ShardedNUTSState(
        chains=jax.tree.map(lambda l: put(l, P(axis)), state.chains),
        da=jax.tree.map(lambda l: put(l, P()), state.da),
        welford=jax.tree.map(lambda l: put(l, P()), state.welford),
        inv_mass=put(state.inv_mass, P()),
        step_size=put(state.step_size, P()),
        keys=put(state.keys, P(axis)),
    )


def init_nuts_sharded(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    init_step_size: float = 0.1,
) -> ShardedNUTSState:
    """Initialize a chain-sharded sampler state from global (C, D) positions."""
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    C = init_position.shape[0]
    if C % n_dev != 0:
        raise ValueError(f"device count ({n_dev}) must evenly divide chains ({C})")

    def local(pos_local, key):
        dev_key = jax.random.fold_in(key, lax.axis_index(axis))
        s = nuts_mod.init_sampler_state(
            log_prob_fn, pos_local, dev_key, init_step_size
        )
        return _to_sharded(s)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=_nuts_state_specs(axis),
        check_vma=False,
    )
    return jax.jit(fn)(init_position, key)


def warmup_nuts_sharded(
    log_prob_fn: Callable,
    state: ShardedNUTSState,
    num_warmup: int,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    max_depth: int = 10,
    target_accept: float = 0.8,
    max_delta_energy: float = 1000.0,
    chunk_size: int | None = None,
) -> ShardedNUTSState:
    """Pooled-adaptation warmup over the sharded chain population.

    ``chunk_size`` splits the warmup scan into several shorter device
    dispatches *at host level, between shard_map calls* — semantically
    identical (the same pytree is the carry either way), but each
    execution stays short and the state can be
    checkpointed between chunks.
    """
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    reduce_mean, reduce_welford = _pooled_reducers(axis)
    schedule = adapt.build_warmup_schedule(num_warmup)

    def chunk(state, flags):
        s = _to_local(state)

        def wstep(s, f):
            s, _ = nuts_mod.warmup_step(
                log_prob_fn,
                s,
                f,
                max_depth=max_depth,
                target_accept=target_accept,
                max_delta_energy=max_delta_energy,
                reduce_mean=reduce_mean,
                reduce_welford=reduce_welford,
            )
            return s, None

        s, _ = lax.scan(wstep, s, flags)
        return _to_sharded(s)

    fn = jax.jit(
        jax.shard_map(
            chunk,
            mesh=mesh,
            in_specs=(_nuts_state_specs(axis), P()),
            out_specs=_nuts_state_specs(axis),
            check_vma=False,
        )
    )
    if chunk_size is None or chunk_size >= num_warmup:
        return fn(state, schedule)
    done = 0
    while done < num_warmup:
        step = min(chunk_size, num_warmup - done)
        flags = jax.tree.map(lambda a: a[done : done + step], schedule)
        state = fn(state, flags)
        done += step
    return state


def collect_nuts_sharded(
    log_prob_fn: Callable,
    state: ShardedNUTSState,
    num_samples: int,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
    chunk_size: int | None = None,
) -> ShardedNUTSResult:
    """Non-adaptive collection from a sharded state; resumable.

    ``collect(2k)`` ≡ ``collect(1k)`` + ``collect(1k from .final)`` —
    resume invariance over the 8-device mesh is tested
    (tests/test_parallel.py).
    """
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)

    out_sample_specs = (P(None, axis), P(None, axis), P(None, axis),
                       P(None, axis), P(None, axis))

    def chunk(state, length):
        s = _to_local(state)

        def cstep(s, _):
            s, info = nuts_mod.sample_step(
                log_prob_fn,
                s,
                max_depth=max_depth,
                max_delta_energy=max_delta_energy,
            )
            out = (
                s.chains.z,
                s.chains.logp,
                info.accept_prob,
                info.num_leapfrog,
                info.diverging,
            )
            return s, out

        s, outs = lax.scan(cstep, s, None, length=length)
        return _to_sharded(s), outs

    def make_fn(length):
        return jax.jit(
            jax.shard_map(
                lambda st: chunk(st, length),
                mesh=mesh,
                in_specs=(_nuts_state_specs(axis),),
                out_specs=(_nuts_state_specs(axis), out_sample_specs),
                check_vma=False,
            )
        )

    if chunk_size is None or chunk_size >= num_samples:
        state, (zs, lps, accs, nls, divs) = make_fn(num_samples)(state)
    else:
        fns = {}
        chunks = []
        done = 0
        while done < num_samples:
            step = min(chunk_size, num_samples - done)
            if step not in fns:
                fns[step] = make_fn(step)
            state, out = fns[step](state)
            chunks.append(out)
            done += step
        zs, lps, accs, nls, divs = (
            jnp.concatenate([c[i] for c in chunks]) for i in range(5)
        )
    return ShardedNUTSResult(
        positions=zs,
        log_probs=lps,
        accept_prob=accs,
        num_leapfrog=nls,
        diverging=divs,
        step_size=state.step_size,
        inv_mass=state.inv_mass,
        final=state,
    )


def sample_nuts_sharded(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    num_warmup: int = 500,
    num_samples: int = 1000,
    chunk_size: int | None = None,
    init_step_size: float = 0.1,
    max_depth: int = 10,
    target_accept: float = 0.8,
    max_delta_energy: float = 1000.0,
) -> ShardedNUTSResult:
    """NUTS with chains sharded over ``mesh``'s ``axis``.

    ``init_position`` is the *global* (C, D) chain block; C must divide
    evenly by the mesh axis size.  Semantics match a single-device
    ``sample_nuts`` over all C chains with pooled adaptation (the
    cross-device reductions are exact, not approximate).  ``chunk_size``
    bounds the length of any single device execution (host-chunked).
    """
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    state = init_nuts_sharded(
        log_prob_fn, init_position, key,
        mesh=mesh, axis=axis, init_step_size=init_step_size,
    )
    state = warmup_nuts_sharded(
        log_prob_fn, state, num_warmup,
        mesh=mesh, axis=axis, max_depth=max_depth,
        target_accept=target_accept, max_delta_energy=max_delta_energy,
        chunk_size=chunk_size,
    )
    return collect_nuts_sharded(
        log_prob_fn, state, num_samples,
        mesh=mesh, axis=axis, max_depth=max_depth,
        max_delta_energy=max_delta_energy, chunk_size=chunk_size,
    )


# ---------------------------------------------------------------------------
# ChEES: sharded init / warmup / collect
# ---------------------------------------------------------------------------


class ShardedCheesResult(NamedTuple):
    positions: jax.Array  # (S, C, D)
    log_probs: jax.Array
    accept_prob: jax.Array
    num_leapfrog: jax.Array  # (S,) shared across chains/devices
    diverging: jax.Array
    step_size: jax.Array
    traj_length: jax.Array
    inv_mass: jax.Array
    final: chees_mod.CheesState  # chains sharded, rest replicated


def _chees_state_specs(axis: str) -> chees_mod.CheesState:
    return chees_mod.CheesState(
        chains=P(axis),
        da=P(),
        welford=P(),
        inv_mass=P(),
        step_size=P(),
        traj_length=P(),
        traj_m=P(),
        traj_v=P(),
        traj_count=P(),
        key=P(),  # replicated on purpose: shared trajectory jitter
    )


def shard_put_chees(
    state: chees_mod.CheesState, mesh: Mesh, axis: str = "chain"
) -> chees_mod.CheesState:
    """Place a (host-loaded) ChEES state onto ``mesh`` for resumption."""

    def put(leaf, spec):
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return chees_mod.CheesState(
        chains=jax.tree.map(lambda l: put(l, P(axis)), state.chains),
        da=jax.tree.map(lambda l: put(l, P()), state.da),
        welford=jax.tree.map(lambda l: put(l, P()), state.welford),
        inv_mass=put(state.inv_mass, P()),
        step_size=put(state.step_size, P()),
        traj_length=put(state.traj_length, P()),
        traj_m=put(state.traj_m, P()),
        traj_v=put(state.traj_v, P()),
        traj_count=put(state.traj_count, P()),
        key=put(state.key, P()),
    )


def init_chees_sharded(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
) -> chees_mod.CheesState:
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    C = init_position.shape[0]
    if C % n_dev != 0:
        raise ValueError(f"device count ({n_dev}) must evenly divide chains ({C})")
    dtype = init_position.dtype
    dim = init_position.shape[-1]

    def local(pos_local):
        chains = jax.vmap(
            lambda z: nuts_mod.init_chain(log_prob_fn, z)
        )(pos_local)
        return chains

    chains = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis),
            check_vma=False,
        )
    )(init_position)
    rep = NamedSharding(mesh, P())
    return chees_mod.CheesState(
        chains=chains,
        da=jax.device_put(adapt.da_init(jnp.asarray(init_step_size, dtype)), rep),
        welford=jax.device_put(adapt.welford_init(dim, dtype), rep),
        inv_mass=jax.device_put(jnp.ones((dim,), dtype), rep),
        step_size=jax.device_put(jnp.asarray(init_step_size, dtype), rep),
        traj_length=jax.device_put(jnp.asarray(init_traj_length, dtype), rep),
        traj_m=jax.device_put(jnp.zeros((), dtype), rep),
        traj_v=jax.device_put(jnp.zeros((), dtype), rep),
        traj_count=jax.device_put(jnp.zeros((), jnp.int32), rep),
        key=jax.device_put(key, rep),
    )


def _chees_reducers(axis: str):
    reduce_mean, reduce_welford = _pooled_reducers(axis)

    def reduce_vec_mean(x):
        return lax.pmean(jnp.mean(x, axis=0), axis)

    return reduce_mean, reduce_welford, reduce_vec_mean


def warmup_chees_sharded(
    log_prob_fn: Callable,
    state: chees_mod.CheesState,
    num_warmup: int,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
    chunk_size: int | None = None,
) -> chees_mod.CheesState:
    """Pooled ChEES warmup (step size, mass matrix, trajectory length),
    host-chunked between shard_map dispatches."""
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    reduce_mean, reduce_welford, reduce_vec_mean = _chees_reducers(axis)
    schedule = adapt.build_warmup_schedule(num_warmup)

    def chunk(s, flags):
        def wstep(s, f):
            s, _ = chees_mod.chees_step(
                log_prob_fn, s, adapt_traj=True, flags=f,
                target_accept=target_accept, max_leapfrog=max_leapfrog,
                reduce_mean=reduce_mean, reduce_welford=reduce_welford,
                reduce_vec_mean=reduce_vec_mean, shard_axis=axis,
            )
            return s, None

        s, _ = lax.scan(wstep, s, flags)
        return s

    fn = jax.jit(
        jax.shard_map(
            chunk,
            mesh=mesh,
            in_specs=(_chees_state_specs(axis), P()),
            out_specs=_chees_state_specs(axis),
            check_vma=False,
        )
    )
    if chunk_size is None or chunk_size >= num_warmup:
        return fn(state, schedule)
    done = 0
    while done < num_warmup:
        step = min(chunk_size, num_warmup - done)
        flags = jax.tree.map(lambda a: a[done : done + step], schedule)
        state = fn(state, flags)
        done += step
    return state


def collect_chees_sharded(
    log_prob_fn: Callable,
    state: chees_mod.CheesState,
    num_samples: int,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    max_leapfrog: int = 1000,
    chunk_size: int | None = None,
) -> ShardedCheesResult:
    """Fixed-settings ChEES collection; chunked and resumable like NUTS."""
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    reduce_mean, reduce_welford, reduce_vec_mean = _chees_reducers(axis)

    out_sample_specs = (P(None, axis), P(None, axis), P(None, axis),
                       P(None), P(None, axis))

    def chunk(s, length):
        def cstep(s, _):
            s, info = chees_mod.chees_step(
                log_prob_fn, s, adapt_traj=False, max_leapfrog=max_leapfrog,
                reduce_mean=reduce_mean, reduce_welford=reduce_welford,
                reduce_vec_mean=reduce_vec_mean, shard_axis=axis,
            )
            out = (s.chains.z, s.chains.logp, info.accept_prob,
                   info.num_leapfrog, info.diverging)
            return s, out

        return lax.scan(cstep, s, None, length=length)

    def make_fn(length):
        return jax.jit(
            jax.shard_map(
                lambda st: chunk(st, length),
                mesh=mesh,
                in_specs=(_chees_state_specs(axis),),
                out_specs=(_chees_state_specs(axis), out_sample_specs),
                check_vma=False,
            )
        )

    if chunk_size is None or chunk_size >= num_samples:
        state, (zs, lps, accs, nls, divs) = make_fn(num_samples)(state)
    else:
        fns = {}
        chunks = []
        done = 0
        while done < num_samples:
            step = min(chunk_size, num_samples - done)
            if step not in fns:
                fns[step] = make_fn(step)
            state, out = fns[step](state)
            chunks.append(out)
            done += step
        zs, lps, accs, nls, divs = (
            jnp.concatenate([c[i] for c in chunks]) for i in range(5)
        )
    return ShardedCheesResult(
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


def sample_chees_sharded(
    log_prob_fn: Callable,
    init_position: jax.Array,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    axis: str = "chain",
    num_warmup: int = 500,
    num_samples: int = 1000,
    chunk_size: int | None = None,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
) -> ShardedCheesResult:
    """ChEES-HMC with chains sharded over the mesh.

    The sampler key stays replicated so every device integrates the same
    jittered trajectory length each iteration (the algorithm requires a
    common step count); per-chain momenta fold in the device index.  All
    adaptation statistics — acceptance, ChEES gradient, Welford moments —
    pool exactly across the population via collectives.  ``chunk_size``
    bounds single-execution length (host-chunked between dispatches).
    """
    if mesh is None:
        mesh = make_chain_mesh(axis=axis)
    state = init_chees_sharded(
        log_prob_fn, init_position, key,
        mesh=mesh, axis=axis, init_step_size=init_step_size,
        init_traj_length=init_traj_length,
    )
    state = warmup_chees_sharded(
        log_prob_fn, state, num_warmup,
        mesh=mesh, axis=axis, target_accept=target_accept,
        max_leapfrog=max_leapfrog, chunk_size=chunk_size,
    )
    return collect_chees_sharded(
        log_prob_fn, state, num_samples,
        mesh=mesh, axis=axis, max_leapfrog=max_leapfrog,
        chunk_size=chunk_size,
    )
