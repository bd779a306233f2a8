"""E-step matmul-precision plumbing + bf16 auto-fallback (VERDICT r1 item 5).

On the CPU backend every precision setting computes exact f32/f64 matmuls,
so these tests pin the *plumbing*: the precision parameter threads through
both kernels and the sharded paths without changing results, the manager's
escalation ladder rebuilds working kernels, and the optimizer's fallback
redoes the E-step when the likelihood decreases.  The accuracy of each
rung on a GPU is measured by chip_smoke.py's parity phase.
"""

import jax
import jax.numpy as jnp
import numpy as np

from smcpp_jax.ops import window_kernel as wk
from tests.test_parallel import _make_im, _synth_contigs


def test_window_kernel_precision_param():
    "Explicit precision gives identical results on CPU (param threads through)."
    rng = np.random.RandomState(3)
    nk, M, S, L = 7, 5, 4, 32
    keys = jnp.asarray(rng.randint(0, nk, (S, L)), jnp.int32)
    valid = jnp.asarray(rng.rand(S, L) < 0.9)
    pi = jnp.asarray(rng.dirichlet(np.ones(M)))
    T = jnp.asarray(rng.dirichlet(np.ones(M), size=M))
    E = jnp.asarray(rng.uniform(0.1, 1.0, (nk, M)))
    soc = np.arange(S, dtype=np.int32).reshape(S, 1)

    base = wk.estep_windows(pi, T, E, keys, valid, soc)
    for p in ("tensorfloat32", "highest"):
        out = wk.estep_windows(pi, T, E, keys, valid, soc, precision=p)
        for a, b in zip(base, out):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def _ladder_check(im):
    ll0 = im.E_step()
    assert im.precision == "default"
    assert im.raise_precision() == "tensorfloat32"
    # 'default' stores the scan carry in bf16, so even on CPU (where the
    # matmuls themselves are exact) escalation changes the result at the
    # bf16-carry level; tf32 and highest share the exact f32 carry.
    ll1 = im.E_step()
    assert np.isclose(ll1, ll0, rtol=1e-4)
    assert im.raise_precision() == "highest"
    assert np.isclose(im.E_step(), ll1, rtol=1e-6)
    assert im.raise_precision() is None  # top of the ladder
    assert im.precision == "highest"


def test_manager_precision_ladder_window_kernel():
    "Ladder rebuilds the (sharded) window kernel; E-step results unchanged."
    rng = np.random.RandomState(11)
    n = 4
    im = _make_im(_synth_contigs(rng, n, 3, 1, 12), n)  # 8-device mesh
    assert im._use_windows
    _ladder_check(im)


def test_manager_precision_ladder_span_kernel():
    "Ladder rebuilds the span kernel (default_matmul_precision wrapper)."
    rng = np.random.RandomState(12)
    n = 4
    im = _make_im(
        _synth_contigs(rng, n, 2, 2000, 9000), n, devices=[jax.devices()[0]]
    )
    assert not im._use_windows
    _ladder_check(im)


class _FallbackStub:
    "Analysis stub: loglik jumps down once, recovers after raise_precision."
    def __init__(self):
        self.raised = False
        self.esteps = 0

    def E_step(self):
        self.esteps += 1

    def loglik(self):
        return -1000.0 if self.raised else -1010.0

    def raise_precision(self):
        self.raised = True
        return True


def test_optimizer_precision_fallback():
    from smcpp_jax.inference.optimizer import SMCPPOptimizer

    a = _FallbackStub()
    opt = SMCPPOptimizer.__new__(SMCPPOptimizer)
    opt._analysis = a
    opt._ftol = 1e-6
    # first iteration: no previous loglik, no fallback
    opt._old_loglik = None
    assert opt._maybe_raise_precision(-1005.0) == -1005.0
    assert not a.raised
    # decrease beyond ftol triggers escalation + E-step redo
    opt._old_loglik = -1005.0
    ll = opt._maybe_raise_precision(-1010.0)
    assert a.raised and a.esteps == 1
    assert ll == -1000.0
    # at the top of the ladder (raise_precision returns False): no redo
    a2 = _FallbackStub()
    a2.raise_precision = lambda: False
    opt._analysis = a2
    assert opt._maybe_raise_precision(-1010.0) == -1010.0
    assert a2.esteps == 0
    # improvement never triggers
    a3 = _FallbackStub()
    opt._analysis = a3
    opt._old_loglik = -1005.0
    assert opt._maybe_raise_precision(-1001.0) == -1001.0
    assert not a3.raised


def test_bf16_carry_accuracy_and_ladder_dtype():
    """f32 inputs + 'default' precision store the scan carry in bf16
    (halves the kernel's HBM-bound traffic); escalation to tf32/highest
    restores an exact f32 carry.  Pins the accuracy envelope of the bf16
    carry against the f64 oracle on CPU."""
    rng = np.random.RandomState(5)
    nk, M, S, L = 12, 8, 6, 256
    keys = jnp.asarray(rng.randint(0, nk, (S, L)), jnp.int32)
    valid = jnp.asarray(rng.rand(S, L) < 0.95)
    pi = rng.dirichlet(np.ones(M))
    T = rng.dirichlet(np.ones(M), size=M)
    E = rng.uniform(0.05, 1.0, (nk, M))
    soc = np.arange(S, dtype=np.int32).reshape(S, 1)

    assert wk._carry_dtype("default", jnp.float32) == jnp.bfloat16
    assert wk._carry_dtype("tensorfloat32", jnp.float32) == jnp.float32
    assert wk._carry_dtype("highest", jnp.float32) == jnp.float32
    # f64 (CPU oracle) paths never degrade, whatever the precision knob
    assert wk._carry_dtype("default", jnp.float64) == jnp.float64

    f64 = wk.estep_windows(
        jnp.asarray(pi), jnp.asarray(T), jnp.asarray(E), keys, valid, soc,
        precision="highest",
    )
    a32 = [jnp.asarray(x, jnp.float32) for x in (pi, T, E)]
    bf = wk.estep_windows(*a32, keys, valid, soc, precision="default")
    # loglik essentially exact (per-step renorm keeps the carry O(1))
    np.testing.assert_allclose(float(bf[0]), float(f64[0]), rtol=1e-5)
    # statistics within the documented 'default'-tier envelope
    for ref, out, tol in zip(f64[1:], bf[1:], (5e-2, 2e-3, 5e-3)):
        np.testing.assert_allclose(
            np.asarray(out, np.float64), np.asarray(ref), rtol=tol, atol=1e-8
        )
