"""Keeps a long-lived test process under the kernel's memory-mapping limit,
and pytest-xdist's workers within their share of the cores and of the work.

Every executable that XLA compiles for the CPU holds its own memory
mappings, and JAX keeps each one in its caches for the life of the process.
A pytest process (or an xdist worker) that runs many of the serving tests in
a row compiles thousands of them; once the process reaches
``vm.max_map_count`` mappings, the next ``mmap`` fails inside XLA's compiler
and the process dies with a segmentation fault.  After each test this hook
drops JAX's caches when the process has used half of that limit, so what a
process can run no longer depends on which tests it ran before.

Each xdist worker is a process of its own, and torch's intra-op (OpenMP)
pool takes every core in each of them: six workers on eight cores then run
48 threads whose idle ones spin, and a small torch SVD that takes 3 s alone
took 89-101 s beside the other workers; numpy's BLAS pool does the same.
After collection each worker's pools are cut to its share of the cores.

xdist's load scheduler hands each worker runs of consecutive tests and
never takes them back.  ``tests/test_serve_fuzz.py`` holds a third of the
suite's work (1686 of 5187 s of test time in one 6-worker run, 40-220 s a
test) in 44 consecutive tests: replayed through the scheduler, that run's
durations kept one worker busy to 1326 s while the others ended at
729-907 s (the run took 1349 s).  Under xdist its tests are spread evenly
through the collection order instead, the rest keeping theirs; the same
command then took 980 s.
"""
import gc
import os
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


_SPREAD = "test_serve_fuzz.py"


def pytest_collection_modifyitems(session, config, items):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    heavy = [it for it in items if it.path.name == _SPREAD]
    if not heavy:
        return
    rest = [it for it in items if it.path.name != _SPREAD]
    step = len(rest) / len(heavy)
    for k, it in enumerate(heavy):  # every worker computes the same order
        rest.insert(int(k * step) + k, it)
    items[:] = rest


def pytest_collection_finish(session):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(share)
    try:  # numpy's BLAS pool (numpy is loaded before this file: too late for env vars)
        from threadpoolctl import threadpool_limits
    except ImportError:
        return
    threadpool_limits(share)
