"""Generative simulation from the model's own coalescent HMM.

Samples a hidden TMRCA path along the genome from (pi, T) and per-site
observations from the theta-incorporated CSFS — the exact generative process
the inference engine fits.  Used for parameter-recovery validation and as an
msprime-free fallback for the `simulate` command (the reference's simulate
requires msprime, /root/reference/smcpp/commands/simulate.py).
"""

import numpy as np

from ..inference import estimation
from ..ops import csfs as csfs_mod
from ..ops import grid as grid_mod
from ..ops import ratefunc, transition


def simulate_contig(model, theta, rho, L, n, seed=0, M=32):
    """Simulate one contig of length L bases with n undistinguished lineages.

    Returns an (rows, 4) int32 observation array in the SMC++ row format
    (span, a, b, nb) with nb == n everywhere.
    """
    rng = np.random.RandomState(seed)
    hs = estimation.balance_hidden_states(model, M)
    g = grid_mod.make_time_grid(model.s, hs)
    a_vals = np.asarray(model.stepwise_values(), dtype=np.float64)
    pi = np.asarray(ratefunc.initial_distribution(a_vals, g))
    T = np.asarray(transition.transition_matrix(a_vals, rho, g))
    em = np.asarray(
        csfs_mod.incorporate_theta(
            csfs_mod.conditioned_sfs(a_vals, g, n), theta
        )
    )  # (M, 3, n+1)

    # --- sample the hidden path as (state, run-length) pairs
    Tn = T / T.sum(axis=1, keepdims=True)
    self_p = np.diag(Tn)
    jump = Tn.copy()
    np.fill_diagonal(jump, 0.0)
    jump /= jump.sum(axis=1, keepdims=True)
    states, lengths = [], []
    s = rng.choice(len(pi), p=pi / pi.sum())
    pos = 0
    while pos < L:
        run = rng.geometric(max(1.0 - self_p[s], 1e-12))
        run = min(run, L - pos)
        states.append(s)
        lengths.append(run)
        pos += run
        if pos < L:
            s = rng.choice(len(pi), p=jump[s])

    # --- per-run emissions: segregating sites are sparse
    nb = em.shape[2]
    cat_rows = np.stack(
        [np.arange(em.shape[1] * nb) // nb, np.arange(em.shape[1] * nb) % nb,
         np.full(em.shape[1] * nb, n)], axis=1,
    )
    return _emission_rows(rng, states, lengths, em, cat_rows, (0, 0, n))


def _bernoulli_positions(rng, run, p):
    """Sorted positions in [0, run) of a Bernoulli(p) site process, drawn
    as geometric gaps (the same law as a Binomial(run, p) count placed
    uniformly without replacement)."""
    if p <= 0.0:
        return np.zeros(0, np.int64)
    out, end = [], -1
    while True:
        m = int(run * p + 5 * np.sqrt(run * p) + 16)
        pos = end + np.cumsum(rng.geometric(p, m))
        out.append(pos[pos < run])
        if pos[-1] >= run:
            return np.concatenate(out)
        end = pos[-1]


def _emission_rows(rng, states, lengths, em, cat_rows, nonseg):
    """SMC++ rows for a hidden path given as (state, run-length) pairs:
    within each run, segregating sites form a Bernoulli process at the
    state's P(segregating), and each site's observation is a category
    drawn from the state's CSFS row (``cat_rows[c]`` = its columns)."""
    ncol = len(nonseg)
    nonseg = np.asarray(nonseg)
    blocks = []
    for s, run in zip(states, lengths):
        probs = np.maximum(em[s].ravel().astype(np.float64), 0)
        p_seg = 1.0 - probs[0] / probs.sum()
        pos = _bernoulli_positions(rng, run, p_seg)
        k = len(pos)
        blk = np.zeros((2 * k + 1, 1 + ncol), np.int64)
        blk[0::2, 1:] = nonseg  # gaps (and the tail) are non-segregating
        blk[0:2 * k:2, 0] = np.diff(pos, prepend=-1) - 1
        blk[2 * k, 0] = run - (pos[-1] + 1 if k else 0)
        if k:
            sp = probs.copy()
            sp[0] = 0.0
            sp /= sp.sum()
            blk[1::2, 0] = 1
            blk[1::2, 1:] = cat_rows[rng.choice(len(sp), size=k, p=sp)]
        blocks.append(blk[blk[:, 0] > 0])
    return np.concatenate(blocks).astype(np.int32)


def write_simulated(fn, model, theta, rho, L, n, seed=0, pid="pop1"):
    "Simulate and write one contig in SMC++ format."
    from . import format as fmt

    data = simulate_contig(model, theta, rho, L, n, seed)
    dist = [[["sim", 0], ["sim", 1]]]
    undist = [[["sim_u", i] for i in range(n)]]
    fmt.write_contig(fn, data, [pid], dist, undist)
    return fn


def simulate_joint_contig(model12, theta, rho, L, n1, n2, seed=0, M=24):
    """Simulate a two-population (a1=2) contig from the joint generative HMM:
    hidden TMRCA path from the pop-1 model's (pi, T), per-site observations
    from the theta-incorporated joint CSFS.

    Returns (rows, 7) int32: (span, a1, b1, n1, a2, b2, n2)."""
    from ..ops.jcsfs import JointCSFS

    rng = np.random.RandomState(seed)
    m1 = model12.model1
    hs = estimation.balance_hidden_states(m1, M)
    g = grid_mod.make_time_grid(m1.s, hs)
    a_vals = np.asarray(m1.stepwise_values(), dtype=np.float64)
    pi = np.asarray(ratefunc.initial_distribution(a_vals, g))
    T = np.asarray(transition.transition_matrix(a_vals, rho, g))

    jc = JointCSFS(n1, n2, 2, 0, hs, K=10, seed=seed)
    m2 = model12.model2
    J = jc.compute(
        (np.asarray(m1.stepwise_values(), np.float64), m1.s),
        (np.asarray(m2.stepwise_values(), np.float64), m2.s),
        model12.split,
    )  # (M, 3, (n1+1)(n2+1))
    em = np.asarray(csfs_mod.incorporate_theta(J, theta))

    # hidden path as runs
    Tn = T / T.sum(axis=1, keepdims=True)
    self_p = np.diag(Tn)
    jump = Tn.copy()
    np.fill_diagonal(jump, 0.0)
    jump /= jump.sum(axis=1, keepdims=True)
    states, lengths = [], []
    s = rng.choice(len(pi), p=pi / pi.sum())
    pos = 0
    while pos < L:
        run = min(rng.geometric(max(1.0 - self_p[s], 1e-12)), L - pos)
        states.append(s)
        lengths.append(run)
        pos += run
        if pos < L:
            s = rng.choice(len(pi), p=jump[s])

    D2 = n2 + 1
    c = np.arange(em.shape[1] * em.shape[2])
    a1_, rest = np.divmod(c, (n1 + 1) * D2)
    b1_, b2_ = np.divmod(rest, D2)
    cat_rows = np.stack(
        [a1_, b1_, np.full_like(c, n1), np.zeros_like(c), b2_,
         np.full_like(c, n2)], axis=1,
    )
    return _emission_rows(rng, states, lengths, em, cat_rows,
                          (0, 0, n1, 0, 0, n2))


def write_example_vcf(fn, length=1_000_000, n_diploid=10, seed=0,
                      N0=1e4, mu=1.25e-8, r=1e-8, split=0.05):
    """Write a seeded multi-sample VCF of one contig named ``1``.

    Diploids ``msp_0 .. msp_{n_diploid-1}``: the first half form
    population 1, the rest population 2, both at constant size ``N0``
    with a recent ``split`` (coalescent units).  Genotypes come from the
    joint generative HMM's rows (``simulate_joint_contig``): ``msp_0``
    carries pop 1's distinguished pair, and each row's undistinguished
    derived counts are scattered over random haplotypes of the other
    samples of its population.  Returns ``fn``.
    """
    from ..models import SMCModel, SMCTwoPopulationModel

    n_pop1 = n_diploid // 2
    n1 = 2 * n_pop1 - 2
    n2 = 2 * (n_diploid - n_pop1)
    knots = np.array([0.05, 0.2, 0.8, 3.0])
    joint = SMCTwoPopulationModel(
        SMCModel(knots, N0, "piecewise", "pop1"),
        SMCModel(knots, N0, "piecewise", "pop2"),
        split,
    )
    rows = simulate_joint_contig(
        joint, 2 * N0 * mu, 2 * N0 * r, int(length), n1, n2, seed=seed,
    )
    rng = np.random.RandomState(seed + 1)
    undist1 = np.arange(2, 2 * n_pop1)
    undist2 = np.arange(2 * n_pop1, 2 * n_diploid)
    names = [f"msp_{i}" for i in range(n_diploid)]
    opener = __import__("gzip").open if str(fn).endswith(".gz") else open
    with opener(fn, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID=1,length={int(length)}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                           "FILTER", "INFO", "FORMAT"] + names) + "\n")
        pos = 0
        for span, a1, b1, _, _, b2, _ in rows:
            pos += int(span)
            if span != 1 or a1 + b1 + b2 == 0:
                continue
            hap = np.zeros(2 * n_diploid, np.int8)
            hap[rng.permutation(2)[:a1]] = 1
            hap[rng.choice(undist1, b1, replace=False)] = 1
            hap[rng.choice(undist2, b2, replace=False)] = 1
            gts = [f"{hap[2 * i]}|{hap[2 * i + 1]}" for i in range(n_diploid)]
            f.write(f"1\t{pos}\t.\tA\tC\t.\tPASS\t.\tGT\t"
                    + "\t".join(gts) + "\n")
    return fn


def write_simulated_joint(fn, model12, theta, rho, L, n1, n2, seed=0):
    from . import format as fmt

    data = simulate_joint_contig(model12, theta, rho, L, n1, n2, seed)
    dist = [[["sim", 0], ["sim", 1]], []]
    undist = [[["u1", i] for i in range(n1)], [["u2", i] for i in range(n2)]]
    fmt.write_contig(fn, data, [model12.model1.pid, model12.model2.pid],
                     dist, undist)
    return fn
