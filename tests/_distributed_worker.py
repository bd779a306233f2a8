"""Worker process for tests/test_distributed.py.

Each of two processes owns 2 forced CPU devices (4 global), initializes
jax.distributed against a local coordinator, places its half of the
segment rows with jax.make_array_from_process_local_data, and runs the
segment-sharded window E-step over the global mesh.  Process 0 writes the
replicated outputs to an .npz for the pytest driver to compare against
the single-process oracle.

Invoked as:  python _distributed_worker.py <proc_id> <num_procs> <port> <out>
"""

import sys

import numpy as np


def synth_problem():
    "Deterministic small problem; identical in every process and the driver."
    from smcpp_jax.ops import window_kernel as wk

    rng = np.random.RandomState(2)
    nk = 9
    data = []
    for _ in range(5):
        rows = rng.randint(20, 60)
        d = np.c_[rng.randint(1, 20, rows), rng.randint(0, nk, rows)].astype(
            np.int64
        )
        data.append(d)
    key_id = {(k,): k for k in range(nk)}
    M = 4
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.1, 1.0, (nk, M))
    kk, vv, soc = wk.pack_windows(data, key_id, seg_target=32)
    return pi, T, E, kk, vv, soc


def main():
    proc_id, num_procs, port, out = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    import jax

    from smcpp_jax.parallel import distributed as dist, mesh as mesh_mod

    dist.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == num_procs, jax.process_count()
    n_global = jax.device_count()

    pi, T, E, kk, vv, soc = synth_problem()
    keys, valid = mesh_mod.pad_segments(kk, vv, n_global)
    S = keys.shape[0]
    assert S % num_procs == 0
    lo = proc_id * (S // num_procs)
    hi = lo + S // num_procs

    mesh = dist.global_mesh()
    gk, gv = dist.shard_local_contigs(mesh, keys[lo:hi], valid[lo:hi])
    estep = mesh_mod.make_sharded_window_estep(mesh, soc)
    import jax.numpy as jnp

    ll, g0, xi, gs = estep(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), gk, gv
    )
    if proc_id == 0:
        np.savez(
            out,
            ll=np.asarray(ll),
            gamma0=np.asarray(g0),
            xisum=np.asarray(xi),
            gamma_sums=np.asarray(gs),
            n_global_devices=n_global,
        )
    # all processes must reach shutdown together
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
