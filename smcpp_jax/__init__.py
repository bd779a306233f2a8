"""smcpp_jax — a JAX reimplementation of the SMC++ method.

Estimates effective population-size history N(t) from whole-genome sequence
data with an EM-fitted hidden Markov model along the genome, following the
method of Terhorst, Kamm & Song (Nature Genetics 2017).  The numerical core is
pure JAX/XLA (plus one Pallas kernel for the E-step's statistic sweeps on
NVIDIA GPUs): the E-step forward-backward runs as window-lockstep batched
matrix products on the accelerator, and the M-step objective Q(theta) is
differentiated end-to-end through the rate function, transition matrix and
conditioned-SFS emissions.

Reference behavior: popgenmethods/smcpp (see SURVEY.md for the layer map).
"""

import os as _os

from jax import config as _config

# Double precision for all model-dependent setup math (rate function,
# transition, CSFS, M-step).  The E-step hot path casts to float32 explicitly
# (matching the reference's float32 forward pass, /root/reference/include/hmm.h:35).
_config.update("jax_enable_x64", True)

# Caches live inside the checkout (gitignored), never around it.
CACHE_ROOT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".cache"
)

# Persistent compilation cache: an `estimate` run compiles several large
# programs (E-step kernels, the M-step Q family), so repeat runs (CV folds,
# re-fits, parameter sweeps) start warm.  JAX_COMPILATION_CACHE_DIR, when
# set, names the directory (JAX reads it itself); otherwise the cache sits
# at a fixed path in the checkout — the path is part of the cache key.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _config.update(
        "jax_compilation_cache_dir", _os.path.join(CACHE_ROOT, "jax")
    )
# cache EVERYTHING: a small estimate issues dozens of sub-second compiles
_config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

from .version import __version__  # noqa: E402,F401
