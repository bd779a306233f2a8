"""Non-finite E-step outputs must abort loudly with a diagnostic dump
(VERDICT r1 weak item 7; reference analogue: the NaN matrix dumps at
/root/reference/src/hmm.cpp:35-43, src/inference_manager.cpp:466-474)."""

import numpy as np
import pytest

from tests.test_parallel import _make_im, _synth_contigs


def test_estep_nan_aborts_with_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("SMCPP_JAX_DEBUG_DUMP", str(tmp_path))
    rng = np.random.RandomState(21)
    n = 4
    im = _make_im(_synth_contigs(rng, n, 2, 1, 12), n)
    nanfn = lambda *a, **k: (
        np.nan,
        np.full(8, np.nan),
        np.zeros((8, 8)),
        np.zeros((im.em_idx.n_keys, 8)),
    )
    im._estep_fn = nanfn
    with pytest.raises(RuntimeError, match="non-finite E-step output"):
        im.E_step()
    dumps = list(tmp_path.glob("smcpp_jax_nan_dump_*.npz"))
    assert len(dumps) == 1
    z = np.load(dumps[0])
    assert set(z.files) >= {"pi", "T", "E", "loglik", "gamma0"}
    assert np.isnan(float(z["loglik"]))


def test_estep_finite_passes(tmp_path, monkeypatch):
    monkeypatch.setenv("SMCPP_JAX_DEBUG_DUMP", str(tmp_path))
    rng = np.random.RandomState(22)
    n = 4
    im = _make_im(_synth_contigs(rng, n, 2, 1, 12), n)
    ll = im.E_step()
    assert np.isfinite(ll)
    assert not list(tmp_path.glob("*.npz"))
