"""CLI surface smoke test — the equivalent of the reference's
test/run_test_long.sh: exercise every subcommand end-to-end on the seeded
example VCF."""

import json
import os

import numpy as np
import pytest

from smcpp_jax.commands.main import main

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    os.makedirs(d / "out", exist_ok=True)
    return d


def test_version_and_cite(capsys):
    main(["version"])
    assert "smcpp_jax" in capsys.readouterr().out
    main(["cite"])
    assert "Terhorst" in capsys.readouterr().out


def test_vcf2smc(workdir, example_vcf):
    main([
        "vcf2smc", example_vcf, str(workdir / "chr1.smc.gz"), "1",
        "pop1:msp_0,msp_1,msp_2,msp_3,msp_4",
    ])
    assert os.path.exists(workdir / "chr1.smc.gz")


def test_vcf2smc_distinguished(workdir, example_vcf):
    main([
        "vcf2smc", "-d", "msp_1", "msp_1",
        example_vcf, str(workdir / "chr1.d.smc.gz"), "1",
        "pop1:msp_0,msp_1,msp_2,msp_3,msp_4",
    ])
    assert os.path.exists(workdir / "chr1.d.smc.gz")


def test_estimate(workdir):
    np.random.seed(0)
    main([
        "estimate", "-o", str(workdir / "out"), "--em-iterations", "1",
        "--knots", "4", "1.25e-8", str(workdir / "chr1.smc.gz"),
    ])
    fn = workdir / "out" / "model.final.json"
    assert os.path.exists(fn)
    d = json.load(open(fn))
    assert d["model"]["class"] == "SMCModel"


def test_plot(workdir):
    main([
        "plot", "-c", str(workdir / "plot.png"),
        str(workdir / "out" / "model.final.json"),
    ])
    assert os.path.exists(workdir / "plot.png")
    assert os.path.exists(workdir / "plot.csv")


def test_posterior(workdir):
    main([
        "posterior", "--M", "16",
        "--heatmap", str(workdir / "heat.png"),
        "--map", "--intervals", "0.025,0.5,0.975",
        str(workdir / "out" / "model.final.json"),
        str(workdir / "post.npz"),
        str(workdir / "chr1.smc.gz"),
    ])
    z = np.load(workdir / "post.npz")
    assert "hidden_states" in z
    path = str(workdir / "chr1.smc.gz")
    g = z[path]
    assert g.shape[0] == 16
    np.testing.assert_allclose(g.sum(axis=0), 1.0, atol=1e-4)
    assert os.path.exists(workdir / "heat.png")
    # MAP path: one valid state index per row
    mp = z[path + "_map"]
    assert mp.shape == (g.shape[1],)
    assert mp.min() >= 0 and mp.max() < 16
    # credible intervals: quantiles ordered and within the state grid
    qt = z[path + "_quantiles"]
    assert qt.shape == (3, g.shape[1])
    assert np.all(np.diff(qt, axis=0) >= -1e-12)
    hs = z["hidden_states"]
    assert qt.min() >= hs[0] and qt.max() <= hs[-2]


def test_chunk(workdir):
    os.makedirs(workdir / "chunks", exist_ok=True)
    main([
        "chunk", "-w", "100000", "5",
        str(workdir / "chunks" / "c.{}.smc.gz"),
        str(workdir / "chr1.smc.gz"),
    ])
    assert os.path.exists(workdir / "chunks" / "c.0.smc.gz")


def test_simulate_hmm_engine(workdir):
    "simulate --engine hmm writes valid SMC++ data (no msprime needed)."
    from smcpp_jax.data.format import load_contig

    out = str(workdir / "sim.smc.gz")
    main([
        "simulate", "--engine", "hmm",
        str(workdir / "out" / "model.final.json"), "3", "200000", out,
    ])
    c = load_contig(out)
    assert c.data[:, 0].sum() == 200000


def test_posterior_quantiles_math():
    "CDF inversion against hand-computed values on a tiny posterior."
    from smcpp_jax.commands.posterior import posterior_quantiles

    hs = np.array([0.0, 1.0, 2.0, np.inf])
    # column 0: uniform over first two states; column 1: all mass in state 1
    gamma = np.array([[0.5, 0.0],
                      [0.5, 1.0],
                      [0.0, 0.0]])
    q = posterior_quantiles(gamma, hs, [0.25, 0.5, 0.75])
    # column 0: q25 -> 0.5 into state 0; q50 -> state boundary 1.0;
    # q75 -> half into state 1 => 1.5
    np.testing.assert_allclose(q[:, 0], [0.5, 1.0, 1.5])
    # column 1: all quantiles interpolate inside state 1 = [1, 2)
    np.testing.assert_allclose(q[:, 1], [1.25, 1.5, 1.75])
    # terminal-interval mass reports the left edge
    g2 = np.array([[0.0], [0.0], [1.0]])
    q2 = posterior_quantiles(g2, hs, [0.5])
    np.testing.assert_allclose(q2, [[2.0]])
