"""Size-history models.

Same semantics and JSON serialization as the reference's model classes
(/root/reference/smcpp/model.py), but parameters live in a plain float
vector ``y`` and all derived quantities are pure jnp functions of it —
``jax.grad`` replaces the vendored ``ad`` package.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .. import defaults
from . import spline as spline_mod


def cumsum0(ary):
    return np.concatenate([[0.0], np.cumsum(ary)])


def _cpu_device():
    """Eager model evaluation must never dispatch to an accelerator: the
    spline chain is ~15 tiny ops, and on a device each one costs a launch,
    a round trip and a first-call compile."""
    return jax.local_devices(backend="cpu")[0]


class PiecewiseModel:
    "Raw (a, s) piecewise-constant model (model.py:58-95)."

    NPOP = 1

    def __init__(self, a, s, N0=None, pid=None):
        assert len(a) == len(s)
        self.a = np.asarray(a, dtype=np.float64)
        self.s = np.asarray(s, dtype=np.float64)
        self._N0 = N0
        self._pid = pid

    @property
    def N0(self):
        return self._N0

    @property
    def pid(self):
        return self._pid

    @property
    def knots(self):
        return np.cumsum(self.s)

    @property
    def distinguished_model(self):
        return self

    def stepwise_values(self):
        return self.a

    def for_pop(self, pop):
        assert pop == self.pid
        return self


class SMCModel:
    "Spline model over log-size at K knots (model.py:118-257)."

    NPOP = 1

    def __init__(self, knots, N0, spline_class="piecewise", pid=None):
        self._knots = np.array(knots, dtype=np.float64)
        self._N0 = N0
        self._pid = pid
        if isinstance(spline_class, str):
            self._spline_name = spline_class
        else:  # a class from spline_mod
            self._spline_name = spline_class.__name__
        self._spline = spline_mod.SPLINE_CLASSES[self._spline_name](
            np.log(self._knots)
        )
        self.y = np.zeros(getattr(self._spline, "n_coef", len(self._knots)))

    # -- canonical name as the reference serializes it
    _CANONICAL = {
        "piecewise": "Piecewise",
        "cubic": "CubicSpline",
        "pchip": "PChipSpline",
        "akima": "AkimaSpline",
        "bspline": "BSpline",
        "Piecewise": "Piecewise",
        "CubicSpline": "CubicSpline",
        "PChipSpline": "PChipSpline",
        "AkimaSpline": "AkimaSpline",
        "BSpline": "BSpline",
    }

    @property
    def N0(self):
        return self._N0

    @property
    def pid(self):
        return self._pid

    @property
    def knots(self):
        return self._knots

    @property
    def K(self):
        "Number of free parameters (== knots except for BSpline: K + 2)."
        return len(self.y)

    @property
    def s(self):
        "100-piece logspace discretization (model.py:134-144)."
        return np.r_[
            self._knots[0],
            np.diff(
                np.logspace(
                    np.log10(self._knots[0]),
                    np.log10(self._knots[-1]),
                    defaults.pieces,
                )
            ),
        ]

    @property
    def distinguished_model(self):
        return self

    def for_pop(self, pid):
        assert pid == self.pid
        return self

    def set_knot_values(self, values):
        "Set y so the spline matches log values at the knots (bspline: lsq fit)."
        logv = np.log(np.asarray(values, dtype=np.float64))
        if hasattr(self._spline, "fit_to"):
            self.y = np.asarray(self._spline.fit_to(logv))
        else:
            self.y = logv.copy()

    # ---- differentiable pipeline -------------------------------------
    def eval_at(self, y, points):
        "exp(spline(log points)); y may be traced."
        return jnp.exp(self._spline(y, np.log(np.asarray(points))))

    def stepwise_values_fn(self, y):
        "Traced stepwise values on the s-grid, clipped (model.py:203-209)."
        vals = self.eval_at(y, np.cumsum(self.s))
        return jnp.clip(
            vals,
            defaults.minimum_population_size,
            defaults.maximum_population_size,
        )

    def regularizer_fn(self, y):
        return self._spline.roughness(y)

    # ---- concrete conveniences (eager: pinned to the host CPU) -------
    def __call__(self, x):
        with jax.default_device(_cpu_device()):
            return np.asarray(self.eval_at(self.y, x))

    def stepwise_values(self):
        # one jitted CPU program per (model structure); called by every
        # plugin/dump/marginal-surgery path, often per EM iteration
        fn = getattr(self, "_sv_jit", None)
        if fn is None:
            fn = self._sv_jit = jax.jit(
                self.stepwise_values_fn, device=_cpu_device()
            )
        return np.asarray(fn(self.y))

    def regularizer(self):
        with jax.default_device(_cpu_device()):
            return float(self.regularizer_fn(self.y))

    def randomize(self, rng=np.random):
        self.y = self.y + rng.normal(0.0, 1e-4, size=len(self.y))

    def copy(self):
        return model_from_dict(self.to_dict())

    def to_dict(self):
        return {
            "class": "SMCModel",
            "knots": list(map(float, self._knots)),
            "N0": self._N0,
            "spline_class": self._CANONICAL[self._spline_name],
            "y": [float(v) for v in self.y],
            "pid": self._pid,
        }

    @classmethod
    def from_dict(cls, d):
        assert d["class"] == "SMCModel"
        r = cls(d["knots"], d["N0"], d["spline_class"], d["pid"])
        r.y = np.asarray(d["y"], dtype=np.float64)
        return r

    def to_msp(self):
        "msprime demographic events for simulation (model.py:247-257)."
        import msprime as msp

        a = self.stepwise_values() * 2 * self.N0
        cs = np.r_[0, np.cumsum(self.s)] * 2 * self.N0
        return [
            msp.PopulationParametersChange(
                time=t, initial_size=aa, growth_rate=0, population_id=0
            )
            for t, aa in zip(cs, a)
        ]


class SMCTwoPopulationModel:
    "Joint model: two marginal SMCModels and a split time (model.py:260-436)."

    NPOP = 2

    def __init__(self, model1, model2, split):
        self.model1 = model1
        self.model2 = model2
        self._split = float(split)

    @property
    def N0(self):
        assert self.model1.N0 == self.model2.N0
        return self.model1.N0

    @property
    def distinguished_model(self):
        return self.model1

    @property
    def split(self):
        return self._split

    @split.setter
    def split(self, x):
        self._split = float(x)

    @property
    def split_ind(self):
        "k such that model2.knots[k] <= split < model2.knots[k+1]."
        return np.searchsorted(self.model2.knots, self._split, side="right") - 1

    @property
    def s(self):
        return self.model1.s

    @property
    def K(self):
        return self.model1.K

    @property
    def pids(self):
        return [self.model1.pid, self.model2.pid]

    def for_pop(self, pid):
        """Marginal model for one population.

        pid None = "distinguished lineages apart": infinite size before the
        split, model1 after (model.py:279-292).
        """
        if pid is None:
            a = self.model1.stepwise_values()
            cs = cumsum0(self.model1.s)
            cs[-1] = np.inf
            ip = np.searchsorted(cs, self._split)
            sp = np.diff(np.insert(cs, ip, self._split))
            sp[-1] = 1.0
            s = sp[ip - 1 :]
            s[0] = self.split
            a = np.insert(a[ip - 1 :], 0, np.inf)
            return PiecewiseModel(a, s, None)
        i = self.pids.index(pid)
        if i == 0:
            return self.model1
        # pop 2: model2 below the split, model1 above (model.py:293-313)
        m1, m2 = self.model1, self.model2
        assert m1.N0 == m2.N0
        kts = np.unique(np.sort(np.r_[m1.knots, m2.knots, self._split]))
        i = np.searchsorted(kts, self._split)
        m = SMCModel(kts, m1.N0, m2._spline_name, m2.pid)
        vals = np.empty(len(kts))
        vals[:i] = m2(kts[:i])
        vals[i] = m1(np.array([self._split]))[0]
        vals[i + 1 :] = m1(kts[i + 1 :])
        m.set_knot_values(vals)
        return m

    def regularizer(self):
        return sum(
            float(self.for_pop(pid).regularizer()) for pid in self.pids
        )

    def randomize(self, rng=np.random):
        self.model1.randomize(rng)
        self.model2.randomize(rng)

    def to_dict(self):
        return {
            "class": "SMCTwoPopulationModel",
            "model1": self.model1.to_dict(),
            "model2": self.model2.to_dict(),
            "split": float(self._split),
        }

    @classmethod
    def from_dict(cls, d):
        assert d["class"] == "SMCTwoPopulationModel"
        return cls(
            SMCModel.from_dict(d["model1"]),
            SMCModel.from_dict(d["model2"]),
            d["split"],
        )

    def to_msp(self):
        import msprime as msp

        sp = 2 * self.N0 * self.split
        m1 = self.for_pop(self.pids[0]).to_msp()
        m2 = [
            ev
            for ev in self.for_pop(self.pids[1]).to_msp()
            if ev.time < sp
        ]
        for ev in m2:
            ev.population = 1
        return sorted(
            m1 + m2 + [msp.MassMigration(time=sp, source=1, dest=0)],
            key=lambda ev: ev.time,
        )


def model_from_dict(d):
    cls = {
        "SMCModel": SMCModel,
        "SMCTwoPopulationModel": SMCTwoPopulationModel,
    }[d["class"]]
    return cls.from_dict(d)


def aggregate(*models, stat=np.mean):
    "Mean-of-models over shared knots, for cross-validation (model.py:46-54)."
    x = np.unique(np.sort([k for m in models for k in m.knots]))
    yavg = stat(np.array([m(x) * 2 * m.N0 for m in models]), axis=0)
    ret = SMCModel(x, models[0].N0, "piecewise", models[0].pid)
    ret.y = np.log(yavg / (2 * models[0].N0))
    return ret
