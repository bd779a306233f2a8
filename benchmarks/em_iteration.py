"""Full EM-iteration wall-time benchmark at the BASELINE.md C3 human scale
(n=50, 22 x 250 Mbp contigs, M=16 hidden states, w=100 windows), through the
real inference-manager path: E-step on the accelerator, Q+gradient M-step
coordinate loop on the CPU backend (coarse bracketing rounds as padded f32
batches on the accelerator, manager._setup_fast; zoom/refinement f64 on the
host).  On an H100: not measured yet.
"""

import numpy as np, time, sys
import jax
import smcpp_jax
from smcpp_jax.inference.manager import OnePopInferenceManager
from smcpp_jax.inference import estimation
from smcpp_jax.models import SMCModel
log = sys.stdout
rng = np.random.default_rng(0)

# synthetic human-scale post-pipeline data: n=50, 22 contigs, w=100 windows
n = 50
C = 22
WINDOWS = 2_500_000
def synth(rng):
    rows = []
    total = 0
    while total < WINDOWS:
        r = rng.random()
        if r < 0.80:
            span = int(rng.geometric(0.45)); key = (int(rng.integers(0,2)), 0, 0)
        elif r < 0.97:
            span = int(rng.geometric(0.02)); key = (0, 0, 0)
        else:
            span = 1
            a = int(rng.integers(0, 3)); b = int(rng.integers(0, n+1))
            key = (a, b, n)
        span = min(span, WINDOWS - total)
        rows.append((span,) + key)
        total += span
    return np.array(rows, dtype=np.int32)

t0 = time.time()
data = [synth(rng) for _ in range(C)]
print('synth data', time.time()-t0, file=log)
m = SMCModel(np.logspace(-2, 0.9, 8), 2e4, 'piecewise', ('pop1',))
m.y[:] = 0.0
hs = estimation.balance_hidden_states(m, 16)
t0 = time.time()
im = OnePopInferenceManager(n, data, hs, ('pop1',), 0.5)
print('manager build', time.time()-t0, 'kernel windows:', im._use_windows, 'keys:', im.em_idx.n_keys, file=log)
im.set_model(m); im.theta = 1e-4; im.rho = 1e-4; im.alpha = 100
t0 = time.time(); im.E_step(); print('E_step #1 (compile)', time.time()-t0, 'll', im._ll, file=log)
t0 = time.time(); im.E_step(); print('E_step #2', time.time()-t0, file=log)
t0 = time.time(); q, g = im.Q_and_grad(); print('Q_and_grad #1 (compile)', time.time()-t0, file=log)
t0 = time.time()
for _ in range(10): q, g = im.Q_and_grad()
print('Q_and_grad x10', time.time()-t0, file=log)
# full M-step-ish: simulate the analysis coordinate loop
from smcpp_jax.inference.optimizer import SMCPPOptimizer
class FakeAnalysis:
    def __init__(self): self.model = m; self._ims = {('pop1',): im}; self._theta = 1e-4; self._penalty = 0.0
    has_fast_batch = True
    def Q_batch(self, ys=None, rhos=None, coarse=False):
        return im.Q_batch(ys=ys, rhos=rhos, fast_ok=coarse)
    def Q_and_grad(self, y=None):
        return im.Q_and_grad(y=y)
    def Q(self, **kw): return im.Q(**kw)
    def E_step(self): im.E_step()
    def loglik(self): return im.loglik()
    def dump(self, fn): pass
fa = FakeAnalysis()
opt = SMCPPOptimizer(fa, single=True, learn_rho=True)
t0 = time.time(); opt.run(1); print('full EM iteration (compile)', time.time()-t0, file=log)
# iteration #2 pays the one-time compile of the 192-wide coarse-prefetch
# program (optimizer._prefetch_coarse); #3/#4 are steady state
for it in (2, 3, 4):
    opt._old_loglik = None   # disarm the ftol monitor: measure a full iteration
    t0 = time.time(); opt.run(1)
    print(f'full EM iteration #{it}', time.time()-t0, file=log)
print('done', file=log)
