"""Fully Bayesian hyperparameter inference with the DATA sharded.

The capstone of the matrix-free stack (BASELINE.json:5 "fully Bayesian
... scaled" crossed with config #4's N): ChEES-HMC whose log-posterior is
the deterministic PCG+SLQ surrogate of ``inference.gp_model.
make_log_posterior_iterative``, evaluated with the n training rows
sharded over a mesh axis — every leapfrog step's kernel matvecs,
preconditioner build, and Hutchinson gradient contractions split D ways
(``parallel/iterative_sharded.py::_vg_local``), with ``psum``/
``all_gather`` collectives making each device's log-prob and gradient
globally exact.

Two mesh layouts, one code path:

* 1-D ``Mesh((D,), ('i',))`` — ``chain_axis=None``: all chains on every
  device (chain compute replicated, data FLOPs split).  Bit-compatible
  with single-device ``sample_chees`` on the same surrogate up to
  reduction order: same probes, same jitter/momentum keys (no device
  folding), same adaptation.
* 2-D ``Mesh((C_dev, D_dev), ('chain', 'i'))`` — chains sharded over
  ``chain_axis`` (momenta fold the chain-axis device index, adaptation
  pools over it exactly as ``parallel/sharded.py``) AND data rows
  sharded over ``data_axis``.  This is the full config-#4 Bayesian
  layout: more chains than fit one device's FLOP budget, and N too
  expensive for one device's matvec.

Durability matches the chain-sharded samplers: init / warmup / collect
stages, host-level chunking between shard_map dispatches, final state
exposed for checkpoint/resume.

The surrogate's probes are FROZEN at build time (drawn once on the host
from ``probe_key`` with the exact key plumbing of the unsharded path and
row-sharded over ``data_axis``), so all devices sample one shared
deterministic log-density — MC error is a fixed O(1/sqrt(num_probes))
surrogate bias, not per-step noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussian_processes_tpu.inference import adaptation as adapt
from gaussian_processes_tpu.inference import chees as chees_mod
from gaussian_processes_tpu.inference import nuts as nuts_mod
from gaussian_processes_tpu.models.base import Kernel
from gaussian_processes_tpu.parallel.iterative_sharded import (
    _draw_vg_probes,
    _vg_local,
    make_row_mesh,
)


def make_bayes_mesh(
    n_chain_devices: int = 1,
    n_data_devices: int | None = None,
    chain_axis: str = "chain",
    data_axis: str = "i",
) -> Mesh:
    """(chain, data) mesh over the local devices.

    ``n_chain_devices=1`` degenerates to pure data parallelism (pass
    ``chain_axis=None`` to the samplers then, for single-device-bitwise
    momenta).
    """
    devs = jax.devices()
    if n_data_devices is None:
        n_data_devices = len(devs) // n_chain_devices
    devs = np.asarray(devs[: n_chain_devices * n_data_devices]).reshape(
        n_chain_devices, n_data_devices
    )
    return Mesh(devs, (chain_axis, data_axis))


class _Surrogate(NamedTuple):
    """Host-side handle: frozen probe rows + the local log-post factory."""

    probes: jax.Array  # (n, r) Rademacher, row-sharded at dispatch
    xi1: jax.Array  # (rank, r) or (0, r)
    xi2: jax.Array  # (n, r)
    make_local: "callable"  # (x, x_loc, y_loc, pr_loc, xi1, xi2_loc) -> log_post


def make_log_posterior_iterative_datasharded(
    kernel_template: Kernel,
    n: int,
    dtype,
    data_axis: str = "i",
    *,
    probe_key: jax.Array | None = None,
    prior_mean=0.0,
    prior_std=2.0,
    num_probes: int = 8,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
) -> _Surrogate:
    """Data-sharded twin of ``make_log_posterior_iterative``.

    Returns the frozen global probe draws plus a factory that — called
    INSIDE a ``shard_map`` body with that body's local data/probe shards —
    builds the ``log_post(u)`` the samplers consume.  ``custom_vjp``
    stashes the Hutchinson gradient from the forward solves, so the
    samplers' per-leapfrog ``value_and_grad`` costs one sharded PCG+SLQ
    evaluation, exactly like the unsharded surrogate.
    """
    if probe_key is None:
        probe_key = jax.random.key(20240817)
    P_k = kernel_template.n_params
    mu = jnp.asarray(prior_mean, dtype)
    sd = jnp.asarray(prior_std, dtype)
    probes, xi1, xi2 = _draw_vg_probes(
        probe_key, n, num_probes, precond_rank, dtype
    )

    def make_local(x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc):
        def _vg_u(u):
            theta = jnp.exp(u)
            kernel = kernel_template.with_params(theta[:P_k])
            lml, g_theta = _vg_local(
                kernel, x_full, x_loc, y_loc, probes_loc, xi1, xi2_loc,
                theta[P_k], data_axis,
                num_probes=num_probes, num_iters=num_iters, tol=tol,
                jitter=jitter, block_size=block_size,
                precond_rank=precond_rank,
            )
            lp = lml - 0.5 * jnp.sum(jnp.square((u - mu) / sd))
            g_u = g_theta * theta - (u - mu) / jnp.square(sd)
            return lp, g_u

        @jax.custom_vjp
        def log_post(u):
            return _vg_u(u)[0]

        def fwd(u):
            return _vg_u(u)

        def bwd(g_u, ct):
            return (ct * g_u,)

        log_post.defvjp(fwd, bwd)
        return log_post

    return _Surrogate(probes=probes, xi1=xi1, xi2=xi2, make_local=make_local)


def _chees_state_specs(chain_axis) -> chees_mod.CheesState:
    cs = P(chain_axis) if chain_axis is not None else P()
    return chees_mod.CheesState(
        chains=cs, da=P(), welford=P(), inv_mass=P(), step_size=P(),
        traj_length=P(), traj_m=P(), traj_v=P(), traj_count=P(), key=P(),
    )


def _reducers(chain_axis):
    """Pooling hooks: across the chain axis when sharded, local otherwise."""
    if chain_axis is None:
        return (
            chees_mod._default_reduce_mean,
            chees_mod._default_reduce_welford,
            None,
        )

    def reduce_mean(x):
        return lax.pmean(jnp.mean(x), chain_axis)

    def reduce_welford(w):
        mean_g = lax.pmean(w.mean, chain_axis)
        m2_g = lax.psum(
            w.m2 + w.count * jnp.square(w.mean - mean_g), chain_axis
        )
        count_g = lax.psum(w.count, chain_axis)
        return type(w)(mean=mean_g, m2=m2_g, count=count_g)

    def reduce_vec_mean(x):
        return lax.pmean(jnp.mean(x, axis=0), chain_axis)

    return reduce_mean, reduce_welford, reduce_vec_mean


def sample_chees_iterative_sharded(
    kernel_template: Kernel,
    x,
    y,
    init_position: jax.Array,
    key: jax.Array,
    *,
    mesh: Mesh | None = None,
    data_axis: str = "i",
    chain_axis: str | None = None,
    probe_key: jax.Array | None = None,
    prior_mean=0.0,
    prior_std=2.0,
    num_probes: int = 8,
    num_iters: int = 100,
    tol: float = 1e-6,
    jitter: float = 0.0,
    block_size: int = 1024,
    precond_rank: int = 0,
    num_warmup: int = 500,
    num_samples: int = 1000,
    chunk_size: int | None = None,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrog: int = 1000,
) -> chees_mod.CheesResult:
    """ChEES-HMC on the matrix-free surrogate with data rows sharded.

    ``init_position`` is the global (C, P+1) chain block over
    u = log(kernel params..., s).  With ``chain_axis=None`` chains are
    replicated (every device steps all C chains; the data-parallel
    psum/all_gather split the FLOPs); with a 2-D mesh and ``chain_axis``
    set, C must divide the chain-axis size and adaptation pools across
    it.  ``chunk_size`` host-chunks the scans (short dispatches,
    checkpointable between dispatches, bit-identical).
    """
    if mesh is None:
        mesh = make_row_mesh(axis=data_axis)
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = x.shape[0]
    dtype = init_position.dtype
    n_data = mesh.shape[data_axis]
    if n % n_data != 0:
        raise ValueError(f"data axis size ({n_data}) must evenly divide n ({n})")
    if chain_axis is not None:
        C = init_position.shape[0]
        if C % mesh.shape[chain_axis] != 0:
            raise ValueError(
                f"chain axis size ({mesh.shape[chain_axis]}) must evenly "
                f"divide chains ({C})"
            )

    sur = make_log_posterior_iterative_datasharded(
        kernel_template, n, dtype, data_axis,
        probe_key=probe_key, prior_mean=prior_mean, prior_std=prior_std,
        num_probes=num_probes, num_iters=num_iters, tol=tol, jitter=jitter,
        block_size=block_size, precond_rank=precond_rank,
    )
    reduce_mean, reduce_welford, reduce_vec_mean = _reducers(chain_axis)
    state_specs = _chees_state_specs(chain_axis)
    pos_spec = P(chain_axis) if chain_axis is not None else P()
    data_specs = (P(), P(data_axis), P(data_axis), P(data_axis), P(),
                  P(data_axis))
    data_args = (x, x, y, sur.probes, sur.xi1, sur.xi2)

    # ---- init ------------------------------------------------------------
    def init_local(pos_loc, x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc):
        log_post = sur.make_local(x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc)
        return jax.vmap(lambda z: nuts_mod.init_chain(log_post, z))(pos_loc)

    chains = jax.jit(
        jax.shard_map(
            init_local, mesh=mesh,
            in_specs=(pos_spec,) + data_specs,
            out_specs=pos_spec,
            check_vma=False,
        )
    )(init_position, *data_args)
    dim = init_position.shape[-1]
    rep = NamedSharding(mesh, P())
    state = chees_mod.CheesState(
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

    # ---- warmup ----------------------------------------------------------
    schedule = adapt.build_warmup_schedule(num_warmup)

    def warm_chunk(s, flags, x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc):
        log_post = sur.make_local(x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc)

        def wstep(s, f):
            s, _ = chees_mod.chees_step(
                log_post, s, adapt_traj=True, flags=f,
                target_accept=target_accept, max_leapfrog=max_leapfrog,
                reduce_mean=reduce_mean, reduce_welford=reduce_welford,
                reduce_vec_mean=reduce_vec_mean, shard_axis=chain_axis,
            )
            return s, None

        return lax.scan(wstep, s, flags)[0]

    warm_fn = jax.jit(
        jax.shard_map(
            warm_chunk, mesh=mesh,
            in_specs=(state_specs, P()) + data_specs,
            out_specs=state_specs,
            check_vma=False,
        )
    )
    if chunk_size is None or chunk_size >= num_warmup:
        state = warm_fn(state, schedule, *data_args)
    else:
        done = 0
        while done < num_warmup:
            step = min(chunk_size, num_warmup - done)
            flags = jax.tree.map(lambda a: a[done : done + step], schedule)
            state = warm_fn(state, flags, *data_args)
            done += step

    # ---- collect ---------------------------------------------------------
    samp_spec = P(None, chain_axis) if chain_axis is not None else P()
    out_sample_specs = (samp_spec, samp_spec, samp_spec, P(), samp_spec)

    def coll_chunk(s, length, x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc):
        log_post = sur.make_local(x_full, x_loc, y_loc, pr_loc, xi1, xi2_loc)

        def cstep(s, _):
            s, info = chees_mod.chees_step(
                log_post, s, adapt_traj=False, max_leapfrog=max_leapfrog,
                reduce_mean=reduce_mean, reduce_welford=reduce_welford,
                reduce_vec_mean=reduce_vec_mean, shard_axis=chain_axis,
            )
            out = (s.chains.z, s.chains.logp, info.accept_prob,
                   info.num_leapfrog, info.diverging)
            return s, out

        return lax.scan(cstep, s, None, length=length)

    def make_coll(length):
        return jax.jit(
            jax.shard_map(
                lambda st, *d: coll_chunk(st, length, *d),
                mesh=mesh,
                in_specs=(state_specs,) + data_specs,
                out_specs=(state_specs, out_sample_specs),
                check_vma=False,
            )
        )

    if chunk_size is None or chunk_size >= num_samples:
        state, (zs, lps, accs, nls, divs) = make_coll(num_samples)(
            state, *data_args
        )
    else:
        fns = {}
        chunks = []
        done = 0
        while done < num_samples:
            step = min(chunk_size, num_samples - done)
            if step not in fns:
                fns[step] = make_coll(step)
            state, out = fns[step](state, *data_args)
            chunks.append(out)
            done += step
        zs, lps, accs, nls, divs = (
            jnp.concatenate([c[i] for c in chunks]) for i in range(5)
        )
    return chees_mod.CheesResult(
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
