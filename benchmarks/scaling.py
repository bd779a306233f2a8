"""Weak-scaling benchmark of the data-parallel window E-step on a virtual
device mesh.

Per-device workload is held fixed (2 contigs x ~0.5 Mbp) while the mesh
grows 1 -> 8 devices; ideal weak scaling keeps wall time flat, so measured
throughput should grow linearly with the mesh.  On this image the mesh is 8
virtual CPU devices (xla_force_host_platform_device_count) — the SPMD
program, shardings, and XLA-inserted psum collectives are exactly the ones
that run over NVLink on a multi-GPU host (BASELINE.md C5); only the
interconnect differs.

Run:  PYTHONPATH=. python benchmarks/scaling.py
"""

import os
import time

os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_force_host_platform_device_count=8",
)
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

import smcpp_jax  # noqa: F401,E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from smcpp_jax.parallel import mesh as mesh_mod  # noqa: E402


def synth_contig(rng, n_keys, bases):
    rows = []
    total = 0
    while total < bases:
        span = int(rng.geometric(0.02))
        span = min(span, bases - total)
        rows.append((span, int(rng.integers(0, n_keys))))
        total += span
    return np.asarray(rows, dtype=np.int64)


def main():
    rng = np.random.default_rng(0)
    M, n_keys = 8, 12
    per_dev_contigs, bases = 2, 500_000
    key_id = {(k,): k for k in range(n_keys)}
    pi = jnp.asarray(rng.dirichlet(np.ones(M)), jnp.float32)
    T = jnp.asarray(rng.dirichlet(np.ones(M), size=M), jnp.float32)
    E = jnp.asarray(rng.uniform(0.1, 1.0, (n_keys, M)), jnp.float32)

    devices = jax.devices()
    results = []
    for nd in (1, 2, 4, 8):
        if nd > len(devices):
            break
        data = [
            synth_contig(rng, n_keys, bases)
            for _ in range(per_dev_contigs * nd)
        ]
        total_bases = float(sum(d[:, 0].sum() for d in data))
        mesh = mesh_mod.make_mesh(devices[:nd])
        from smcpp_jax.ops import window_kernel as wk

        keys, valid, soc = wk.pack_windows(data, key_id, seg_target=2048)
        keys, valid = mesh_mod.pad_segments(keys, valid, nd)
        estep = mesh_mod.make_sharded_window_estep(mesh, soc)
        sh = NamedSharding(mesh, P("data", None))
        kd = jax.device_put(jnp.asarray(keys), sh)
        vd = jax.device_put(jnp.asarray(valid), sh)
        out = estep(pi, T, E, kd, vd)  # compile
        jax.block_until_ready(out)
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            out = estep(pi, T, E, kd, vd)
            jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        thr = total_bases / dt
        results.append((nd, dt, thr))
        print(
            f"devices={nd}  contigs={len(data)}  wall={dt * 1e3:8.1f} ms  "
            f"throughput={thr / 1e6:8.1f} Mbp/s  ll={float(out[0]):.2f}"
        )

    base = results[0][2]
    for nd, dt, thr in results:
        eff = thr / (base * nd)
        print(f"devices={nd}: weak-scaling efficiency {100 * eff:5.1f}%")
    ncores = os.cpu_count()
    print(
        f"note: {len(devices)} virtual devices share {ncores} physical "
        "cores, so efficiency beyond "
        f"{ncores} devices measures host oversubscription, not the SPMD "
        "program (whose outputs are verified exact vs single-device in "
        "tests/test_parallel.py); on a real slice each device is a chip."
    )


if __name__ == "__main__":
    main()
