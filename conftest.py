"""Keeps a long-lived test process under the kernel's memory-mapping limit.

Every executable that XLA compiles for the CPU holds its own memory
mappings, and JAX keeps each one in its caches for the life of the process.
A pytest process (or an xdist worker) that runs many of the serving tests in
a row compiles thousands of them; once the process reaches
``vm.max_map_count`` mappings, the next ``mmap`` fails inside XLA's compiler
and the process dies with a segmentation fault.  After each test this hook
drops JAX's caches when the process has used half of that limit, so what a
process can run no longer depends on which tests it ran before.
"""
import gc
import sys

_MAX_MAP_COUNT = "/proc/sys/vm/max_map_count"
_MAPS = "/proc/self/maps"


def _map_limit() -> int | None:
    try:
        with open(_MAX_MAP_COUNT) as fh:
            return int(fh.read())
    except (OSError, ValueError):
        return None


_LIMIT = _map_limit()


def _n_maps() -> int:
    with open(_MAPS, "rb") as fh:
        return sum(1 for _ in fh)


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is None or _LIMIT is None:
        return
    if _n_maps() > _LIMIT // 2:
        jax.clear_caches()
        gc.collect()
