"""Multi-host (multi-process) execution of the sharded E-step.

The reference has nothing distributed to test (SURVEY.md §2.3/§4); this
exercises the jax.distributed path end-to-end on CPU: two OS processes,
each owning 2 forced-host devices, form a 4-device global mesh; each
process places only ITS half of the segment rows
(jax.make_array_from_process_local_data), and the segment-sharded window
E-step must reproduce the single-process oracle exactly.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(__file__)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_window_estep(tmp_path):
    port = _free_port()
    out = str(tmp_path / "proc0.npz")
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_distributed_worker.py"),
             str(i), "2", str(port), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    z = np.load(out)
    assert int(z["n_global_devices"]) == 4

    # single-process oracle on the same deterministic problem
    sys.path.insert(0, HERE)
    try:
        from _distributed_worker import synth_problem
    finally:
        sys.path.pop(0)
    from smcpp_jax.ops import window_kernel as wk

    pi, T, E, kk, vv, soc = synth_problem()
    ll1, g1, x1, gs1 = wk.estep_windows(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E),
        jnp.asarray(kk), jnp.asarray(vv), soc,
    )
    assert np.isclose(float(z["ll"]), float(ll1), rtol=1e-10)
    np.testing.assert_allclose(z["gamma0"], np.asarray(g1), rtol=1e-8)
    np.testing.assert_allclose(z["xisum"], np.asarray(x1), rtol=1e-8)
    np.testing.assert_allclose(z["gamma_sums"], np.asarray(gs1), rtol=1e-8)


def test_two_process_estimate_cli(tmp_path, example_vcf):
    """Multi-host `estimate` straight from the CLI (VERDICT r2 item 3):
    two OS processes, each with 2 forced-host devices, join via
    --coordinator/--num-processes/--process-id and run over a 4-device
    global mesh.  Both processes must produce the same fit, and it must
    agree with a single-process run to sharded-reduction noise.

    With ONE input file and host-local ingestion (the multi-process
    default since round 4), process 1's shard is EMPTY — this also
    pins the zero-contig edge of the host-local path.  A second pair
    runs with --replicated-data to keep the escape hatch exercised:
    its fit must equal the host-local one exactly (the global
    statistics are identical either way)."""
    from smcpp_jax.data.vcf import SampleList, vcf2smc

    smc = str(tmp_path / "ex.smc.gz")
    vcf2smc(
        example_vcf, smc, "1",
        SampleList("pop1", ["msp_0", "msp_1", "msp_2", "msp_3", "msp_4"]),
    )
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
    )
    cli = [sys.executable, "-m", "smcpp_jax.commands.main", "estimate",
           "--em-iterations", "1", "--knots", "6", "--seed", "0",
           "1.25e-8", smc]
    procs = [
        subprocess.Popen(
            cli + ["-o", str(tmp_path / f"out{i}"),
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    import json

    fits = [
        json.load(open(tmp_path / f"out{i}" / "model.final.json"))
        for i in range(2)
    ]
    y0 = np.asarray(fits[0]["model"]["y"], float)
    y1 = np.asarray(fits[1]["model"]["y"], float)
    np.testing.assert_array_equal(y0, y1)  # replicated driver: identical

    # single-process oracle on a 4-device mesh
    p = subprocess.run(
        cli + ["-o", str(tmp_path / "out_single")],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]
    ys = np.asarray(
        json.load(open(tmp_path / "out_single" / "model.final.json"))
        ["model"]["y"], float,
    )
    np.testing.assert_allclose(y0, ys, rtol=1e-4, atol=1e-6)

    # --replicated-data escape hatch: every process loads the full
    # dataset; same fit to sharded-reduction noise (the two modes pad
    # the segment layout differently, so not bit-identical)
    port2 = _free_port()
    procs = [
        subprocess.Popen(
            cli + ["-o", str(tmp_path / f"rep{i}"), "--replicated-data",
                   "--coordinator", f"127.0.0.1:{port2}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
        assert "host-local ingestion" not in log
    yr = np.asarray(
        json.load(open(tmp_path / "rep0" / "model.final.json"))
        ["model"]["y"], float,
    )
    np.testing.assert_allclose(y0, yr, rtol=1e-4, atol=1e-6)


def test_two_process_hostlocal_estimate_cli(tmp_path, example_vcf):
    """Host-local ingestion e2e (VERDICT r3 item 1): two input files, two
    CLI processes — each process must load and filter ONLY its own file
    (asserted from the ingestion log line), place only its own window
    segments (jax.make_array_from_process_local_data), and both must
    produce the same fit as (a) each other and (b) a single-process run
    over the full dataset.  The reference is single-node by construction
    (/root/reference/src/inference_manager.cpp:89-106)."""
    from smcpp_jax.data.vcf import SampleList, vcf2smc

    smc0 = str(tmp_path / "a.smc.gz")
    smc1 = str(tmp_path / "b.smc.gz")
    vcf2smc(
        example_vcf, smc0, "1",
        SampleList("pop1", ["msp_0", "msp_1", "msp_2", "msp_3", "msp_4"]),
    )
    # second contig: same conversion with a different distinguished pair
    # (the first sample) so the two shards carry genuinely different
    # observation streams
    vcf2smc(
        example_vcf, smc1, "1",
        SampleList("pop1", ["msp_3", "msp_0", "msp_1", "msp_2", "msp_4"]),
    )
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
    )
    cli = [sys.executable, "-m", "smcpp_jax.commands.main", "estimate",
           "--em-iterations", "1", "--knots", "6", "--seed", "0",
           "1.25e-8", smc0, smc1]
    procs = [
        subprocess.Popen(
            cli + ["-o", str(tmp_path / f"hl{i}"),
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    # host-locality: each process ingested exactly its 1-file shard
    for i, log in enumerate(logs):
        assert f"host-local ingestion: process {i}/2 loads 1 of 2 files" \
            in log, log[-4000:]
        assert "host-local window packing" in log, log[-4000:]

    import json

    fits = [
        json.load(open(tmp_path / f"hl{i}" / "model.final.json"))
        for i in range(2)
    ]
    y0 = np.asarray(fits[0]["model"]["y"], float)
    y1 = np.asarray(fits[1]["model"]["y"], float)
    np.testing.assert_array_equal(y0, y1)  # same global stats everywhere

    # single-process oracle over the full dataset on a 4-device mesh
    p = subprocess.run(
        cli + ["-o", str(tmp_path / "hl_single")],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]
    ys = np.asarray(
        json.load(open(tmp_path / "hl_single" / "model.final.json"))
        ["model"]["y"], float,
    )
    np.testing.assert_allclose(y0, ys, rtol=1e-4, atol=1e-6)


def test_two_process_hostlocal_split_cli(tmp_path, example_vcf):
    """Host-local ingestion through the SPLIT workflow: two joint-data
    files, two CLI processes — each loads only its own file, the two-pop
    manager all-reduces its key counts, and the split fit must match the
    single-process oracle exactly (the M = 1 closed-form E-step consumes
    only global aggregates, so the fits are bit-identical)."""
    import json

    from smcpp_jax.data.vcf import SampleList, vcf2smc

    p1 = SampleList("pop1", ["msp_0", "msp_1", "msp_2"])
    p2 = SampleList("pop2", ["msp_3", "msp_4"])
    p1b = SampleList("pop1", ["msp_1", "msp_2", "msp_0"])
    f1 = str(tmp_path / "p1.smc.gz")
    f2 = str(tmp_path / "p2.smc.gz")
    f12a = str(tmp_path / "p12a.smc.gz")
    f12b = str(tmp_path / "p12b.smc.gz")
    vcf2smc(example_vcf, f1, "1", p1)
    vcf2smc(example_vcf, f2, "1", p2)
    vcf2smc(example_vcf, f12a, "1", p1, p2)
    vcf2smc(example_vcf, f12b, "1", p1b, p2)

    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
    )
    # marginal fits (single-process, quick)
    for name, fn in (("m1", f1), ("m2", f2)):
        p = subprocess.run(
            [sys.executable, "-m", "smcpp_jax.commands.main", "estimate",
             "--em-iterations", "1", "--knots", "4", "--seed", "0",
             "-o", str(tmp_path / name), "1.25e-8", fn],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=420,
        )
        assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]

    cli = [sys.executable, "-m", "smcpp_jax.commands.main", "split",
           str(tmp_path / "m1" / "model.final.json"),
           str(tmp_path / "m2" / "model.final.json"), f12a, f12b]
    port = _free_port()
    procs = [
        subprocess.Popen(
            cli + ["-o", str(tmp_path / f"sp{i}"),
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    for i, log in enumerate(logs):
        assert f"host-local ingestion: process {i}/2 loads 1 of 2 files" \
            in log, log[-4000:]

    # single-process oracle
    p = subprocess.run(
        cli + ["-o", str(tmp_path / "sp_single")],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]

    def split_of(d):
        return json.load(
            open(tmp_path / d / "model.final.json")
        )["model"]["split"]

    s0, s1, ss = split_of("sp0"), split_of("sp1"), split_of("sp_single")
    assert s0 == s1
    np.testing.assert_allclose(s0, ss, rtol=1e-6, atol=1e-9)


def test_two_process_hostlocal_posterior_cli(tmp_path, example_vcf):
    """Host-local posterior decode (round 4): two data files, two CLI
    processes — each loads only its own file, the window decode reduces
    over the global mesh, and each process writes ITS shard's gammas and
    MAP path to <output>.procI.  Must match the single-process decode."""
    import json

    from smcpp_jax.data.vcf import SampleList, vcf2smc

    smc0 = str(tmp_path / "a.smc.gz")
    smc1 = str(tmp_path / "b.smc.gz")
    vcf2smc(
        example_vcf, smc0, "1",
        SampleList("pop1", ["msp_0", "msp_1", "msp_2", "msp_3", "msp_4"]),
    )
    vcf2smc(
        example_vcf, smc1, "1",
        SampleList("pop1", ["msp_3", "msp_0", "msp_1", "msp_2", "msp_4"]),
    )
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
        # pin the exact f32 gamma pull: this oracle checks host-local
        # sharding correctness at 2e-4, below the default f16 transfer
        # rounding (manager._transfer_dtype)
        SMCPP_JAX_DECODE_TRANSFER="f32",
    )
    # quick marginal fit to decode against
    p = subprocess.run(
        [sys.executable, "-m", "smcpp_jax.commands.main", "estimate",
         "--em-iterations", "1", "--knots", "4", "--seed", "0",
         "-o", str(tmp_path / "fit"), "1.25e-8", smc0],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]
    model = str(tmp_path / "fit" / "model.final.json")

    cli = [sys.executable, "-m", "smcpp_jax.commands.main", "posterior",
           "--M", "8", "--map", model]
    port = _free_port()
    procs = [
        subprocess.Popen(
            cli + [str(tmp_path / "post.npz"), smc0, smc1,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    for i, log in enumerate(logs):
        assert f"host-local posterior: process {i}/2 decodes 1 of 2" \
            in log, log[-4000:]

    # single-process oracle
    p = subprocess.run(
        cli + [str(tmp_path / "single.npz"), smc0, smc1],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]
    ref = np.load(str(tmp_path / "single.npz"))
    for i, smc in enumerate((smc0, smc1)):
        z = np.load(str(tmp_path / f"post.proc{i}.npz"))
        assert set(z.files) == {
            "hidden_states", smc, smc + "_sites", smc + "_map"
        }
        np.testing.assert_allclose(z[smc], ref[smc], rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(z[smc + "_map"], ref[smc + "_map"])
        np.testing.assert_array_equal(
            z[smc + "_sites"], ref[smc + "_sites"]
        )


def test_fingerprint_guard_catches_dtype_mismatch(tmp_path):
    """The fingerprint collective preceding every host-local gather must
    FAIL LOUDLY when processes contribute different dtypes — a mismatched
    gloo allgather otherwise silently delivers corrupt bytes (the
    np.bincount-int64-on-empty bug this guard was built for)."""
    worker = tmp_path / "w.py"
    worker.write_text(
        "import sys\n"
        "import jax\n"
        "import numpy as np\n"
        "i = int(sys.argv[1])\n"
        "jax.distributed.initialize(\n"
        "    coordinator_address=sys.argv[2], num_processes=2, process_id=i\n"
        ")\n"
        "from smcpp_jax.parallel import hostlocal\n"
        "x = np.zeros(3, np.float64 if i == 0 else np.int64)\n"
        "try:\n"
        "    hostlocal.allreduce_sum(x)\n"
        "except RuntimeError as e:\n"
        "    assert 'mismatch' in str(e), e\n"
        "    print('GUARD-OK')\n"
        "else:\n"
        "    print('GUARD-MISSED')\n"
    )
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), f"127.0.0.1:{port}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out = stdout.decode(errors="replace")
        assert "GUARD-OK" in out, out[-2000:]


def test_two_process_hostlocal_twopop_posterior_cli(tmp_path, example_vcf):
    """Two-population posterior under host-local ingestion: the two-pop
    manager shares the window decode machinery, so joint data decodes
    host-locally too — two joint files, two processes, each writes its
    shard's npz; gammas must match the single-process decode."""
    import json

    from smcpp_jax.data.vcf import SampleList, vcf2smc
    from smcpp_jax.models import SMCModel, SMCTwoPopulationModel

    p1 = SampleList("pop1", ["msp_0", "msp_1", "msp_2"])
    p2 = SampleList("pop2", ["msp_3", "msp_4"])
    p1b = SampleList("pop1", ["msp_1", "msp_2", "msp_0"])
    f1 = str(tmp_path / "p1.smc.gz")
    f12a = str(tmp_path / "p12a.smc.gz")
    f12b = str(tmp_path / "p12b.smc.gz")
    vcf2smc(example_vcf, f1, "1", p1)
    vcf2smc(example_vcf, f12a, "1", p1, p2)
    vcf2smc(example_vcf, f12b, "1", p1b, p2)

    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        PYTHONPATH=os.path.dirname(HERE),
        SMCPP_JAX_DECODE_TRANSFER="f32",  # see one-pop posterior test
    )
    p = subprocess.run(
        [sys.executable, "-m", "smcpp_jax.commands.main", "estimate",
         "--em-iterations", "1", "--knots", "4", "--seed", "0",
         "-o", str(tmp_path / "fit"), "1.25e-8", f1],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]

    d = json.load(open(tmp_path / "fit" / "model.final.json"))
    m1 = SMCModel.from_dict(d["model"])
    m2 = SMCModel.from_dict(d["model"])
    m1._pid = "pop1"
    m2._pid = "pop2"
    jm = SMCTwoPopulationModel(m1, m2, float(m1.knots[-1]) / 2)
    jfit = tmp_path / "joint.json"
    json.dump(
        {"model": jm.to_dict(), "theta": d["theta"], "rho": d["rho"],
         "alpha": d["alpha"], "hidden_states": d["hidden_states"]},
        open(jfit, "w"),
    )

    cli = [sys.executable, "-m", "smcpp_jax.commands.main", "posterior",
           "--M", "8", str(jfit)]
    port = _free_port()
    procs = [
        subprocess.Popen(
            cli + [str(tmp_path / "post.npz"), f12a, f12b,
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    p = subprocess.run(
        cli + [str(tmp_path / "single.npz"), f12a, f12b],
        env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420,
    )
    assert p.returncode == 0, p.stdout.decode(errors="replace")[-4000:]
    ref = np.load(str(tmp_path / "single.npz"))
    for i, smc in enumerate((f12a, f12b)):
        z = np.load(str(tmp_path / f"post.proc{i}.npz"))
        np.testing.assert_allclose(z[smc], ref[smc], rtol=2e-4, atol=2e-5)
