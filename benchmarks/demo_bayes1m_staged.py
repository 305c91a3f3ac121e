"""Staged, restartable 1M-point Bayes acceptance run.

Same model, objective, and sampler math as demo_bayes1m.py (Whittle +
ChEES at N=2^20, 16 chains) but restartable: a long run that is
interrupted resumes from its last checkpoint instead of starting over.
This runner:

* runs warmup as the same chunked schedule sample_chees uses (flags
  sliced per chunk — identical programs and inputs), with a heartbeat
  per chunk dispatch and a checkpoint every 100 warmup iterations,
  then continues COLLECTION in stages of ``STAGE`` draws using the
  exact collection transition sample_chees uses (chees_step with
  adapt_traj=False, same max_leapfrog), chunked 2 draws per dispatch;
* checkpoints the full sampler state pytree + accumulated draws to
  ``D1M_STATE`` after warmup and after every stage (np.savez of the
  flattened tree; the typed PRNG key via key_data);
* a stall guard aborts the PROCESS (os._exit) if no chunk
  completes for D1M_STALL_S seconds (default 180) — the outer
  supervisor loop (run_bayes1m_staged.sh) restarts it and it resumes
  from the checkpoint, losing at most one stage;
* exits 0 printing the final JSON (same fields as demo_bayes1m.py)
  once D1M_SAMPLES draws are banked.

Resume invariance of the chunked scan is the round-2 tested property
(bit-identical chunk splits); restarting from a checkpoint re-enters
the same transition with the same state, so the draw stream is the
one sample_chees would have produced modulo the at-most-one lost
stage boundary.
"""

# allow running as `python benchmarks/<script>.py` from anywhere
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import os
import sys
import threading
import time

import numpy as np

STALL_S = float(os.environ.get("D1M_STALL_S", 180))
_last_progress = [time.time()]


def _heartbeat():
    _last_progress[0] = time.time()


def _stall_guard():
    while True:
        time.sleep(5)
        if time.time() - _last_progress[0] > STALL_S:
            print(f"STALL: no chunk completed in {STALL_S:.0f}s — "
                  f"aborting for supervisor restart", flush=True)
            os._exit(42)


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from gaussian_processes_tpu import GaussianKernel
    from gaussian_processes_tpu.inference import (
        init_positions,
        make_log_posterior_whittle,
    )
    import gaussian_processes_tpu.inference.chees as chees_mod

    n = int(os.environ.get("D1M_N", 1 << 20))
    n_chains = int(os.environ.get("D1M_CHAINS", 16))
    num_warmup = int(os.environ.get("D1M_WARMUP", 500))
    num_samples = int(os.environ.get("D1M_SAMPLES", 6000))
    stage_len = int(os.environ.get("D1M_STAGE", 250))
    max_lf = int(os.environ.get("D1M_MAX_LEAPFROG", 128))
    chunk = int(os.environ.get("D1M_CHUNK", 2))
    spread = float(os.environ.get("D1M_SPREAD", 0.01))
    step0 = float(os.environ.get("D1M_STEP", 0.005))
    state_path = os.environ.get("D1M_STATE", "/tmp/bayes1m_staged_state.npz")
    save_path = os.environ.get("D1M_SAVE", "")

    kernel_mode = os.environ.get("D1M_KERNEL", "se")

    rng = np.random.default_rng(0)
    x = (np.arange(n) * (2 * np.pi / n) - np.pi).astype(np.float32)
    y = (np.sin(50 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.key(0))
    if kernel_mode == "se":
        h0, w0, s0 = 0.7, 0.04, 0.1
        k0 = GaussianKernel(h=jnp.asarray(h0, jnp.float32),
                            w=jnp.asarray(w0, jnp.float32))
        u0 = np.log(np.array([h0, w0, s0], dtype=np.float32))
        log_post = make_log_posterior_whittle(
            k0, x, y, prior_mean=jnp.asarray(u0), prior_std=1.0,
            jitter=1e-6)
        init = init_positions(k0, s0, k1, n_chains=n_chains,
                              spread=spread, dtype=jnp.float32)
    elif kernel_mode == "periodic_fixedp":
        # the reference's flagship periodic kernel with the period FIXED
        # at its periodogram estimate: the p-posterior at n=2^20 is
        # narrower than f32 ulp spacing (the round-5 "period-resolution
        # wall"), so p is a point estimate and (h, w, s)
        # are sampled over the round-5 analytic line spectrum
        from gaussian_processes_tpu import PeriodicKernel

        h0, w0, p0, s0 = 0.7, 1.0, 0.02, 0.1
        k0 = PeriodicKernel(h=jnp.asarray(h0, jnp.float32),
                            w=jnp.asarray(w0, jnp.float32),
                            p=jnp.asarray(p0, jnp.float32))
        u04 = np.log(np.array([h0, w0, p0, s0], dtype=np.float32))
        lp4 = make_log_posterior_whittle(
            k0, x, y, prior_mean=jnp.asarray(u04), prior_std=1.0,
            jitter=1e-6)
        logp_hat = jnp.asarray(np.log(p0), jnp.float32)

        def log_post(u3):
            u4 = jnp.concatenate([u3[:2], logp_hat[None], u3[2:]])
            return lp4(u4)

        init = jnp.asarray(np.log([h0, w0, s0]), jnp.float32)[None, :] + \
            spread * jax.random.normal(k1, (n_chains, 3), jnp.float32)
    else:
        raise ValueError(f"unknown D1M_KERNEL={kernel_mode}")

    def save_state(state, draws, accs, wall_accum, warm_done):
        leaves, _ = jax.tree.flatten(state)
        leaves = [np.asarray(jax.random.key_data(l))
                  if jnp.issubdtype(getattr(l, "dtype", jnp.float32),
                                    jax.dtypes.prng_key) else np.asarray(l)
                  for l in leaves]
        tmp = state_path + ".tmp.npz"
        np.savez(tmp,
                 n_leaves=len(leaves),
                 **{f"leaf_{i}": l for i, l in enumerate(leaves)},
                 draws=draws, accs=accs, wall_accum=wall_accum,
                 warm_done=warm_done)
        os.replace(tmp, state_path)  # atomic vs an abort mid-write

    def load_state(template):
        d = np.load(state_path)
        leaves, treedef = jax.tree.flatten(template)
        out = []
        for i, t in enumerate(leaves):
            a = d[f"leaf_{i}"]
            if jnp.issubdtype(getattr(t, "dtype", jnp.float32),
                              jax.dtypes.prng_key):
                out.append(jax.random.wrap_key_data(jnp.asarray(a)))
            else:
                out.append(jnp.asarray(a))
        return (jax.tree.unflatten(treedef, out), d["draws"], d["accs"],
                float(d["wall_accum"]))

    threading.Thread(target=_stall_guard, daemon=True).start()
    t_run0 = time.perf_counter()

    # template state (host-side construction only — no dispatch) for
    # checkpoint restore; mirrors sample_chees init
    def template_state():
        chains = jax.vmap(
            lambda z: chees_mod.init_chain(log_post, z))(init)
        dim = init.shape[-1]
        from gaussian_processes_tpu.inference import adaptation as adapt
        return chees_mod.CheesState(
            chains=chains,
            da=adapt.da_init(jnp.asarray(step0, jnp.float32)),
            welford=adapt.welford_init(dim, jnp.float32),
            inv_mass=jnp.ones((dim,), jnp.float32),
            step_size=jnp.asarray(step0, jnp.float32),
            traj_length=jnp.asarray(0.1, jnp.float32),
            traj_m=jnp.zeros((), jnp.float32),
            traj_v=jnp.zeros((), jnp.float32),
            traj_count=jnp.zeros((), jnp.int32),
            key=k2,
        )

    from gaussian_processes_tpu.inference import adaptation as adapt

    schedule = adapt.build_warmup_schedule(num_warmup)

    def wstep(s, flags):
        s, _ = chees_mod.chees_step(
            log_post, s, adapt_traj=True, flags=flags,
            max_leapfrog=max_lf)
        return s, None

    warm_j = jax.jit(lambda s, f: lax.scan(wstep, s, f)[0])

    # checkpoint record carries warmup progress so a restart
    # mid-warmup resumes the SCHEDULE at the right position (the flags
    # are runtime inputs — same program every chunk)
    if os.path.exists(state_path):
        state, draws, accs, wall_accum = load_state(template_state())
        d0 = np.load(state_path)
        warm_done = int(d0["warm_done"]) if "warm_done" in d0 else num_warmup
        print(f"resumed: warmup {warm_done}/{num_warmup}, "
              f"{draws.shape[0]} draws banked", flush=True)
        _heartbeat()
    else:
        state = template_state()
        float(jnp.sum(state.chains.logp))  # realize init dispatch
        _heartbeat()
        draws = np.zeros((0, n_chains, 3), np.float32)
        accs = np.zeros((0, n_chains), np.float32)
        wall_accum = 0.0
        warm_done = 0

    t0 = time.perf_counter()
    while warm_done < num_warmup:
        step = min(chunk, num_warmup - warm_done)
        flags = jax.tree.map(
            lambda a: a[warm_done : warm_done + step], schedule)
        state = warm_j(state, flags)
        float(jnp.sum(state.chains.z))  # fetch-sync = heartbeat
        _heartbeat()
        warm_done += step
        if warm_done % 100 == 0 or warm_done == num_warmup:
            wall_accum += time.perf_counter() - t0
            t0 = time.perf_counter()
            save_state(state, draws, accs, wall_accum,
                       warm_done=warm_done)
            print(f"warmup {warm_done}/{num_warmup}, "
                  f"{wall_accum:.1f}s", flush=True)

    # collection continuation: EXACTLY sample_chees's cstep, chunked
    def cstep(s, _):
        s, info = chees_mod.chees_step(
            log_post, s, adapt_traj=False, max_leapfrog=max_lf)
        return s, (s.chains.z, info.accept_prob)

    run_j = jax.jit(
        lambda s, ln: lax.scan(cstep, s, None, length=ln),
        static_argnums=1)

    while draws.shape[0] < num_samples:
        t0 = time.perf_counter()
        todo = min(stage_len, num_samples - draws.shape[0])
        z_chunks, a_chunks = [], []
        done = 0
        while done < todo:
            step = min(chunk, todo - done)
            state, (zs, asz) = run_j(state, step)
            float(jnp.sum(zs))  # fetch-sync each chunk = heartbeat
            _heartbeat()
            z_chunks.append(np.asarray(zs))
            a_chunks.append(np.asarray(asz))
            done += step
        draws = np.concatenate([draws] + z_chunks)
        accs = np.concatenate([accs] + a_chunks)
        wall_accum += time.perf_counter() - t0
        save_state(state, draws, accs, wall_accum, warm_done=num_warmup)
        print(f"stage done: {draws.shape[0]}/{num_samples} draws, "
              f"{wall_accum:.1f}s accumulated", flush=True)

    from gaussian_processes_tpu.inference.diagnostics import summarize
    positions = draws  # (S, C, D)
    exp_draws = np.exp(positions).reshape(-1, 3)
    diag = summarize(positions)
    acc_pc = accs.reshape(-1, n_chains).mean(0)
    std_pc = positions.std(0).max(-1)
    if save_path:
        np.savez(save_path, positions=positions, accept=accs)
    tag = "" if kernel_mode == "se" else f"_{kernel_mode}"
    out = {
        "metric": f"bayes1m_chees_whittle{tag}_n{n}_c{n_chains}",
        "value": round(positions.shape[0] * n_chains / wall_accum, 1),
        "unit": "samples/s (incl. warmup+compile, staged walls)",
        "wall_s": round(wall_accum, 1),
        "process_wall_s": round(time.perf_counter() - t_run0, 1),
        "draws": int(positions.shape[0] * n_chains),
        "num_warmup": num_warmup,
        "accept_mean": float(accs.mean()),
        "posterior_mean_hws": exp_draws.mean(0).round(5).tolist(),
        "posterior_sd_hws": exp_draws.std(0).round(6).tolist(),
        "true_hws": [None, None, 0.1],
        "max_rhat": diag["max_rhat"],
        "min_ess": diag["min_ess"],
        "min_chain_accept": float(acc_pc.min()),
        "n_frozen_chains": int(np.sum(std_pc < 1e-6)),
        "finite": bool(np.all(np.isfinite(exp_draws))),
    }
    print("DONE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
