"""Disk cache of traced + lowered JAX programs (cold-start lever).

The persistent XLA compile cache removes *compilation* from warm starts,
but every process still pays Python tracing + MLIR lowering for each jit
signature — about half a second per Q-pipeline signature on a CPU host, a
large share of a tiny `estimate`'s wall.  The reference has no analogous
cost at all (precompiled C++).

This module serializes whole traced programs with `jax.export`: on a
warm start a signature costs ~1 ms of deserialization plus an XLA
compile-cache hit instead of trace + lower + compile.

Correctness model: an entry's key includes (a) a schema counter, (b) a
hash of every source file whose code is baked into the traced programs
(ops/, models/, defaults) — so ANY edit to the compute code invalidates
the cache, (c) the caller-supplied closure fingerprint (grids, emission
index, model structure), and (d) the call-site argument shapes/dtypes.
Failures anywhere (old jax, serialization error) fall back to plain
`jax.jit`; ``STATS`` counts stores, hits and fallbacks so that a silent
fallback shows.  ``jax.export`` serializes through the optional
``flatbuffers`` package: without it the cache is off (one warning), so no
signature pays an export it cannot store.  ``SMCPP_JAX_EXPORT_CACHE=0``
disables; ``=<dir>`` relocates (default: ``export`` under the checkout's
cache root).
"""

import functools
import hashlib
import logging
import os

import jax
import numpy as np

logger = logging.getLogger(__name__)

SCHEMA = 1

# Per-process counts of cache stores, hits and plain-jit fallbacks.
STATS = {"store": 0, "hit": 0, "fallback": 0}

# jax.Device.platform names the CUDA backend "gpu"; jax.export names it
# "cuda".
_EXPORT_PLATFORM = {"gpu": "cuda"}


@functools.cache
def _can_serialize():
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        logger.warning(
            "export cache off: jax.export serialization needs the "
            "'flatbuffers' package"
        )
        return False
    return True


def _root():
    v = os.environ.get("SMCPP_JAX_EXPORT_CACHE")
    if v == "0" or not _can_serialize():
        return None
    if v and v != "1":
        return v
    import smcpp_jax

    return os.path.join(smcpp_jax.CACHE_ROOT, "export")


def _code_hash():
    """Hash of every source file baked into the traced programs."""
    global _CODE_HASH
    try:
        return _CODE_HASH
    except NameError:
        pass
    import smcpp_jax

    pkg = os.path.dirname(smcpp_jax.__file__)
    h = hashlib.sha256()
    files = [os.path.join(pkg, "defaults.py")]
    for sub in ("ops", "models"):
        d = os.path.join(pkg, sub)
        files += sorted(
            os.path.join(d, f) for f in os.listdir(d) if f.endswith(".py")
        )
    for f in files:
        h.update(f.encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    _CODE_HASH = h.hexdigest()[:16]
    return _CODE_HASH


def fingerprint(*parts):
    "Stable hash over arrays / bytes / strings / numbers / tuples."
    h = hashlib.sha256()

    def feed(p):
        if isinstance(p, np.ndarray):
            h.update(str((p.shape, str(p.dtype))).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        elif isinstance(p, (tuple, list)):
            for q in p:
                feed(q)
        else:
            h.update(repr(p).encode())

    for p in parts:
        feed(p)
    return h.hexdigest()[:24]


def _spec_of(a):
    if isinstance(a, jax.ShapeDtypeStruct):
        return a
    return jax.ShapeDtypeStruct(np.shape(a), np.result_type(a))


def _load_or_build(tag, fp, build, args, device):
    from jax import export as jexp

    specs = [_spec_of(a) for a in args]
    plat = device.platform if device is not None else jax.default_backend()
    plat = _EXPORT_PLATFORM.get(plat, plat)
    root = _root()
    path = None
    if root is not None:
        key = fingerprint(
            SCHEMA, _code_hash(), tag, fp,
            [(s.shape, str(s.dtype)) for s in specs],
            plat,
        )
        path = os.path.join(root, f"{tag}-{key}.jaxexp")
        if os.path.exists(path):
            try:
                exp = jexp.deserialize(open(path, "rb").read())
                logger.debug("export cache hit: %s", os.path.basename(path))
                STATS["hit"] += 1
                return jax.jit(exp.call, device=device)
            except Exception as e:
                logger.debug("export cache load failed (%s): %s", path, e)
    fn = build()
    if path is not None:
        try:
            # lower for the device the program is pinned to, not the
            # process default (the q family is CPU-pinned on accelerator
            # runs)
            exp = jexp.export(jax.jit(fn), platforms=[plat])(*specs)
            os.makedirs(root, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(exp.serialize())
            os.replace(tmp, path)
            logger.debug("export cache store: %s", os.path.basename(path))
            STATS["store"] += 1
            return jax.jit(exp.call, device=device)
        except Exception as e:
            logger.warning("export cache store failed (%s): %s", tag, e)
    STATS["fallback"] += 1
    return jax.jit(fn, device=device)


def exported_jit(tag, fp, build, device=None):
    """A lazily-resolved, shape-polymorphic-by-dispatch cached program.

    ``build`` returns the (already transformed — vmap/grad applied)
    callable; it is invoked only on a cache miss.  Each distinct argument
    shape/dtype signature resolves its own disk entry, so the canonical
    batch-width buckets each hit their own artifact."""
    progs = {}

    def call(*args):
        key = tuple((np.shape(a), str(np.result_type(a))) for a in args)
        f = progs.get(key)
        if f is None:
            f = progs[key] = _load_or_build(tag, fp, build, args, device)
        return f(*args)

    return call
