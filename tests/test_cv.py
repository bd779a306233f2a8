"""Cross-validation end-to-end (reduced rp sweep for test runtime)."""

import json
import os

import numpy as np
import pytest

from smcpp_jax.data.simulate import write_simulated
from smcpp_jax.models import SMCModel


@pytest.mark.slow
def test_cv_end_to_end(tmp_path):
    from smcpp_jax.commands.main import main

    true = SMCModel(np.array([0.05, 2.0]), 2e4, "piecewise", "pop1")
    true.y = np.log(np.array([1.5, 0.8]))
    files = []
    for i in range(2):
        fn = str(tmp_path / f"c{i}.smc.gz")
        write_simulated(fn, true, 1e-4, 1e-4, L=1_000_000, n=4, seed=i)
        files.append(fn)
    outdir = str(tmp_path / "cv")
    os.makedirs(outdir, exist_ok=True)
    main([
        "cv", "-o", outdir, "--folds", "2", "--em-iterations", "1",
        "--knots", "4", "--rp-values", "4,6",
        "1.25e-8", *files,
    ])
    d = json.load(open(os.path.join(outdir, "model.final.json")))
    assert d["model"]["class"] == "SMCModel"
    assert os.path.exists(os.path.join(outdir, "fold0", ".done"))
    assert os.path.exists(os.path.join(outdir, "fold1", "model.best.json"))
