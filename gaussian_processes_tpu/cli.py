"""Command-line runner for the five acceptance workloads.

Usage:
    python -m gaussian_processes_tpu.cli config1_fit_se500
    python -m gaussian_processes_tpu.cli config3_nuts_64 --num-samples 200
    python -m gaussian_processes_tpu.cli --list

Each run emits JSONL metrics (utils/metrics.py) and an end-of-run summary
line; ``--profile-dir`` dumps a TensorBoard trace of the hot phase
(SURVEY.md §6.1, §6.6).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def _apply_overrides(cfg, args):
    nuts = cfg.nuts
    if args.num_samples is not None:
        nuts = dataclasses.replace(nuts, num_samples=args.num_samples)
    if args.num_warmup is not None:
        nuts = dataclasses.replace(nuts, num_warmup=args.num_warmup)
    if args.n_chains is not None:
        nuts = dataclasses.replace(nuts, n_chains=args.n_chains)
    data = cfg.data
    if args.n is not None:
        data = dataclasses.replace(data, n=args.n)
    return dataclasses.replace(
        cfg,
        nuts=nuts,
        data=data,
        metrics_path=args.metrics,
        profile_dir=args.profile_dir,
    )


def _roofline(n, wall, dtype):
    """Roofline fields on a GPU (whose peaks are tabled); FLOP/s elsewhere."""
    import jax

    from gaussian_processes_tpu.utils import fit_flops, roofline

    if jax.devices()[0].platform == "gpu":
        return roofline(n, wall, dtype)
    return {"n": n, "wall_s": wall, "achieved_flops": fit_flops(n) / wall}


def run_config(cfg) -> dict:
    import jax
    import jax.numpy as jnp

    from gaussian_processes_tpu import fit, predict_diag
    from gaussian_processes_tpu.inference import (
        fit_mle_restarts,
        init_positions,
        make_log_posterior,
        sample_nuts,
    )
    from gaussian_processes_tpu.parallel import (
        fit_sharded,
        make_chain_mesh,
        make_grid_mesh,
        sample_nuts_sharded,
    )
    from gaussian_processes_tpu.utils import (
        MetricsLogger,
        make_data,
        make_kernel,
        summarize_nuts,
        timed,
        trace,
    )

    log = MetricsLogger(path=cfg.metrics_path)
    dtype = cfg.fit.dtype
    x, y, xo = make_data(cfg.data, dtype=dtype)
    kernel = make_kernel(cfg.kernel)
    kernel = jax.tree.map(lambda v: jnp.asarray(v, dtype), kernel)
    log.log("start", config=cfg.name, task=cfg.task, n=cfg.data.n,
            backend=jax.default_backend(), dtype=dtype)

    if cfg.task == "fit":
        fit_j = jax.jit(lambda k, x, y: fit(k, x, y, cfg.fit.noise, cfg.fit.jitter))
        with trace(cfg.profile_dir):
            wall = timed(fit_j, kernel, x, y)
        post = fit_j(kernel, x, y)
        mean, var = predict_diag(post, xo)
        rmse = float(np.sqrt(np.mean((np.asarray(mean) - np.sin(cfg.data.freq * xo)) ** 2)))
        summary = {"fit_wall_s": wall, "log_marginal": float(post.log_marginal),
                   "pred_rmse_vs_truth": rmse, **_roofline(cfg.data.n, wall, dtype)}

    elif cfg.task == "mle":
        res = fit_mle_restarts(
            kernel, x, y, cfg.fit.noise, jax.random.key(cfg.data.seed),
            n_restarts=cfg.mle.n_restarts, num_steps=cfg.mle.num_steps,
            method=cfg.mle.method, jitter=cfg.fit.jitter,
        )
        summary = {
            "log_marginal": float(res.log_marginal),
            "theta": np.asarray(jnp.exp(res.u)).tolist(),
            "converged": bool(res.converged),
        }

    elif cfg.task in ("nuts", "chees", "nuts_multihost", "bayes_grid"):
        ncfg = cfg.nuts
        if cfg.task == "bayes_grid":
            # Whittle (circulant-model) likelihood on a uniform grid —
            # deterministic FFT leapfrogs, N ~ 10^6 viable; sampled with
            # ChEES below (the throughput sampler)
            from gaussian_processes_tpu.inference import (
                make_log_posterior_whittle,
            )
            from gaussian_processes_tpu.ops.toeplitz import is_uniform_grid

            assert is_uniform_grid(x), "bayes_grid needs layout='grid'"
            import numpy as _np

            u0 = _np.log(_np.concatenate(
                [_np.asarray(kernel.params), [cfg.fit.noise]]))
            log_post = make_log_posterior_whittle(
                kernel, x, y, prior_mean=jnp.asarray(u0, dtype),
                prior_std=ncfg.prior_std, jitter=cfg.fit.jitter,
            )
        else:
            log_post = make_log_posterior(
                kernel, x, y, prior_std=ncfg.prior_std, jitter=cfg.fit.jitter
            )
        key = jax.random.key(ncfg.seed)
        k1, k2 = jax.random.split(key)
        init = init_positions(
            kernel, cfg.fit.noise, k1, n_chains=ncfg.n_chains, spread=0.2,
            dtype=jnp.dtype(dtype),
        )
        import time as _time

        t0 = _time.perf_counter()
        with trace(cfg.profile_dir):
            if cfg.task == "nuts_multihost":
                mesh = make_chain_mesh(cfg.mesh.n_devices, cfg.mesh.chain_axis)
                res = sample_nuts_sharded(
                    log_post, init, k2, mesh=mesh,
                    num_warmup=ncfg.num_warmup, num_samples=ncfg.num_samples,
                    max_depth=ncfg.max_depth, target_accept=ncfg.target_accept,
                    init_step_size=ncfg.init_step_size,
                    # host-chunked dispatch: checkpointable between
                    # chunks (VERDICT r1 item 3)
                    chunk_size=ncfg.chunk_size,
                )
            elif cfg.task in ("chees", "bayes_grid"):
                from gaussian_processes_tpu.inference.chees import sample_chees

                res = sample_chees(
                    log_post, init, k2,
                    num_warmup=ncfg.num_warmup, num_samples=ncfg.num_samples,
                    init_step_size=ncfg.init_step_size,
                    chunk_size=ncfg.chunk_size,
                    **({"init_traj_length": 0.1, "max_leapfrog": 32}
                       if cfg.task == "bayes_grid" else {}),
                )
            else:
                res = sample_nuts(
                    log_post, init, k2,
                    num_warmup=ncfg.num_warmup, num_samples=ncfg.num_samples,
                    max_depth=ncfg.max_depth, target_accept=ncfg.target_accept,
                    init_step_size=ncfg.init_step_size,
                    chunk_size=ncfg.chunk_size,
                )
            jax.block_until_ready(res.positions)
        wall = _time.perf_counter() - t0
        from gaussian_processes_tpu.inference.diagnostics import summarize as diag_summarize

        summary = summarize_nuts(res)
        draws = np.asarray(res.positions).reshape(-1, init.shape[-1])
        summary.update(
            wall_s=wall,
            samples_per_s=ncfg.num_samples * ncfg.n_chains / wall,
            posterior_mean=np.exp(draws).mean(0).tolist(),
            posterior_sd=np.exp(draws).std(0).tolist(),
            diagnostics=diag_summarize(np.asarray(res.positions), wall_s=wall),
        )

    elif cfg.task == "fit_large":
        # block-cyclic distributed Cholesky: no device ever holds the full
        # N x N matrix (XLA's cholesky on a sharded operand gathers it)
        from gaussian_processes_tpu.parallel import fit_blockcyclic

        mesh = make_chain_mesh(cfg.mesh.n_devices, axis="shard")
        block = 256 if cfg.data.n >= 4096 else 64
        fn = lambda k, x, y: fit_blockcyclic(
            k, x, y, cfg.fit.noise, mesh, block_size=block,
            jitter=cfg.fit.jitter,
        )
        with trace(cfg.profile_dir):
            wall = timed(fn, kernel, x, y, warmup=1, iters=2)
        post = fn(kernel, x, y)
        summary = {"fit_wall_s": wall, "log_marginal": float(post.log_marginal),
                   "mesh": str(dict(zip(mesh.axis_names, mesh.devices.shape))),
                   "block_size": block,
                   **_roofline(cfg.data.n, wall, dtype)}
    elif cfg.task == "sgpr":
        # sparse inducing-point GP: one O(n m^2) matmul sweep + (m, m) tail
        from gaussian_processes_tpu.models.sgpr import (
            fit_sgpr, kmeans_inducing, predict_sgpr,
        )

        m_ind = min(1024, max(64, cfg.data.n // 1024))
        z = kmeans_inducing(
            jax.random.PRNGKey(cfg.data.seed), x, m_ind, iters=5
        )
        jax.block_until_ready(z)
        fn = lambda k, xx, yy: fit_sgpr(
            k, xx, yy, cfg.fit.noise, z, jitter=cfg.fit.jitter
        )
        with trace(cfg.profile_dir):
            wall = timed(fn, kernel, x, y, warmup=1, iters=2)
        post = fn(kernel, x, y)
        mean, var = predict_sgpr(post, xo)
        summary = {
            "fit_wall_s": wall,
            "elbo": float(post.log_marginal),
            "trace_gap": float(post.trace_gap),
            "m_inducing": m_ind,
            "pred_finite": bool(np.all(np.isfinite(np.asarray(mean)))
                                and np.all(np.asarray(var) > -1e-3)),
        }
    else:
        raise ValueError(f"unknown task {cfg.task!r}")

    log.log("summary", config=cfg.name, **summary)
    log.close()
    return summary


def main(argv=None):
    from gaussian_processes_tpu.utils import CONFIGS, enable_compile_cache

    ap = argparse.ArgumentParser(prog="gaussian_processes_tpu.cli")
    ap.add_argument("config", nargs="?", help="config name (see --list)")
    ap.add_argument("--list", action="store_true", help="list configs")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--n-chains", type=int, default=None)
    ap.add_argument("--num-warmup", type=int, default=None)
    ap.add_argument("--num-samples", type=int, default=None)
    ap.add_argument("--metrics", default=None, help="JSONL metrics file")
    ap.add_argument("--profile-dir", default=None, help="jax.profiler trace dir")
    args = ap.parse_args(argv)

    if args.list or not args.config:
        for name, c in CONFIGS.items():
            print(f"{name:24s} task={c.task:14s} n={c.data.n}")
        return 0
    if args.config not in CONFIGS:
        print(f"unknown config {args.config!r}; use --list", file=sys.stderr)
        return 2
    cfg = _apply_overrides(CONFIGS[args.config], args)
    enable_compile_cache()
    run_config(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
