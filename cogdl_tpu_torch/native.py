"""The host sampling library — the port of ``cogdl_tpu/native/__init__.py``.

The C++/OpenMP source is the port's own copy,
``cogdl_tpu_torch/csrc/host/graph_sampler.cpp``. At first use it is compiled
with ``g++ -O3 -march=native -shared -fPIC -fopenmp -std=c++17`` into
``build/cogdl_tpu_torch/`` beside the package, under a name keyed by a hash
of the source, the flags and the CPU target that ``-march=native`` resolves
to, and loaded with ``ctypes``. Each build writes a file of its own and
renames it into place, so processes that build at once never load a
half-written library. A failed build raises with g++'s output; nothing gives
way to numpy.

``sample_neighbors`` and ``random_walk`` are bound now; the file's
``node2vec_walk``, ``induced_subgraph`` and ``coo2csr`` wait for the modules
that call them (ROADMAP.md §1, item 13h). The draws of each are fixed by
``(seed, num_threads)``: thread ``t`` of ``T`` takes the seeds (or walk
starts) ``[n·t/T, n·(t+1)/T)`` with its own xorshift128+ stream seeded
``(seed, t + 1)``. :func:`sample_neighbors_reference` and
:func:`random_walk_reference` are the plain versions, numpy replays of the
same streams that give the same draws bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "graph_sampler.cpp"
BUILD_DIR = _PKG.parent / "build" / "cogdl_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
             "-std=c++17")

_MASK64 = (1 << 64) - 1


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: it builds the host "
                           "sampling library (csrc/host/graph_sampler.cpp)")
    return gxx


def _target(gxx: str) -> bytes:
    """What ``-march=native`` means on this machine, as g++ reports it: a
    library built for one CPU is not loaded on another."""
    out = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True)
    return out.stdout


def build() -> Path:
    """Compile the library unless a build of this source, these flags and
    this CPU target exists; returns its path. Raises with g++'s stderr if
    the build fails."""
    gxx = _gxx()
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _target(gxx)).hexdigest()[:16]
    lib = BUILD_DIR / f"libgraph_sampler_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sample_neighbors.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_uint64,
                                     ctypes.c_int, i64p, u8p]
    lib.sample_neighbors.restype = ctypes.c_int
    lib.random_walk.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_double,
                                ctypes.c_uint64, ctypes.c_int, i64p]
    lib.random_walk.restype = ctypes.c_int
    lib.omp_max_threads.argtypes = []
    lib.omp_max_threads.restype = ctypes.c_int
    return lib


def max_threads() -> int:
    """The OpenMP runtime's default thread count on this machine."""
    return int(load_library().omp_max_threads())


def _check(indptr: np.ndarray, seeds: np.ndarray, fanout: int,
           num_threads: int) -> None:
    if fanout < 0:
        raise ValueError(f"sample_neighbors: fanout must be >= 0, got {fanout}")
    if num_threads < 1:
        raise ValueError(f"sample_neighbors: num_threads must be >= 1, got "
                         f"{num_threads}")
    n_nodes = indptr.shape[0] - 1
    if seeds.size and (seeds.min() < 0 or seeds.max() >= n_nodes):
        raise ValueError(f"sample_neighbors: seed ids must lie in [0, "
                         f"{n_nodes}), got [{seeds.min()}, {seeds.max()}]")


def sample_neighbors(indptr, indices, seeds, fanout: int, seed: int,
                     num_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    """``fanout`` neighbours of every seed, drawn uniformly with replacement
    from its CSR row on ``num_threads`` OpenMP threads: ``(src int64[n·fanout],
    mask bool[n·fanout])``, seed-major. A seed without an edge gets itself in
    every slot, masked off. Raises if OpenMP ran another thread count than
    asked for (the draws would then be another pair's)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    seeds = np.ascontiguousarray(seeds, np.int64)
    fanout, num_threads = int(fanout), int(num_threads)
    _check(indptr, seeds, fanout, num_threads)
    n = seeds.shape[0]
    out = np.empty(n * fanout, np.int64)
    mask = np.empty(n * fanout, np.uint8)
    ran = load_library().sample_neighbors(indptr, indices, seeds, n, fanout,
                                          int(seed) & _MASK64, num_threads,
                                          out, mask)
    if ran != num_threads:
        raise RuntimeError(f"sample_neighbors ran on {ran} OpenMP threads, "
                           f"{num_threads} asked for")
    return out, mask.astype(bool)


def _xorshift_next(state) -> np.ndarray:
    """One xorshift128+ step of every stream in ``state = [s0, s1]``
    (``uint64`` arrays, updated in place), as ``graph_sampler.cpp``."""
    s0, s1 = state
    x, y = s0.copy(), s1.copy()
    s0[:] = y
    x ^= x << np.uint64(23)
    s1[:] = x ^ y ^ (x >> np.uint64(17)) ^ (y >> np.uint64(26))
    return s1 + y


def sample_neighbors_reference(indptr, indices, seeds, fanout: int, seed: int,
                               num_threads: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of :func:`sample_neighbors`: the same ``num_threads``
    xorshift128+ streams replayed in numpy (``uint64``, wrapping), stream
    ``t`` seeded ``(seed, t + 1)`` and warmed by 8 steps, drawing ``fanout``
    numbers for each seed with an edge in its range ``[n·t/T, n·(t+1)/T)``,
    in order; slot ``k`` takes edge ``draw % deg`` of the seed's row. Gives
    the library's ``(src, mask)`` bit for bit."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    seeds = np.asarray(seeds, np.int64)
    fanout, T = int(fanout), int(num_threads)
    _check(indptr, seeds, fanout, T)
    n = seeds.shape[0]
    lo = indptr[seeds]
    deg = indptr[seeds + 1] - lo
    src = np.repeat(seeds, fanout).reshape(n, fanout)
    mask = np.zeros((n, fanout), bool)
    with np.errstate(over="ignore"):
        state = [np.full(T, np.uint64(int(seed) & _MASK64)
                         ^ np.uint64(0x9E3779B97F4A7C15)),
                 np.arange(1, T + 1, dtype=np.uint64)
                 * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(1)]
        for _ in range(8):
            _xorshift_next(state)
        bounds = n * np.arange(T + 1, dtype=np.int64) // T
        live = [bounds[t] + np.nonzero(deg[bounds[t]: bounds[t + 1]] > 0)[0]
                for t in range(T)]
        steps = max([idx.size * fanout for idx in live], default=0)
        draws = np.empty((T, steps), np.uint64)
        for k in range(steps):
            draws[:, k] = _xorshift_next(state)
    for t, idx in enumerate(live):
        d = draws[t, : idx.size * fanout].reshape(idx.size, fanout)
        off = (d % deg[idx, None].astype(np.uint64)).astype(np.int64)
        src[idx] = indices[lo[idx, None] + off]
        mask[idx] = True
    return src.ravel(), mask.ravel()


def _check_walks(indptr: np.ndarray, starts: np.ndarray, walk_length: int,
                 restart_prob: float, num_threads: int) -> None:
    if walk_length < 1:
        raise ValueError(f"random_walk: walk_length must be >= 1, got "
                         f"{walk_length}")
    if not 0.0 <= restart_prob < 1.0:
        raise ValueError(f"random_walk: restart_prob must lie in [0, 1), "
                         f"got {restart_prob}")
    if num_threads < 1:
        raise ValueError(f"random_walk: num_threads must be >= 1, got "
                         f"{num_threads}")
    n_nodes = indptr.shape[0] - 1
    if starts.size and (starts.min() < 0 or starts.max() >= n_nodes):
        raise ValueError(f"random_walk: start ids must lie in [0, "
                         f"{n_nodes}), got [{starts.min()}, {starts.max()}]")


def random_walk(indptr, indices, starts, walk_length: int, seed: int,
                num_threads: int, restart_prob: float = 0.0) -> np.ndarray:
    """Uniform random walks over the CSR from every start on
    ``num_threads`` OpenMP threads: ``int64 [len(starts), walk_length]``,
    column 0 the starts. A step returns to the walk's start with
    probability ``restart_prob``, else moves to a uniform neighbour (a node
    without an edge stays put). Raises if OpenMP ran another thread count
    than asked for."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    walk_length, num_threads = int(walk_length), int(num_threads)
    _check_walks(indptr, starts, walk_length, restart_prob, num_threads)
    n = starts.shape[0]
    out = np.empty((n, walk_length), np.int64)
    ran = load_library().random_walk(indptr, indices, starts, n, walk_length,
                                     float(restart_prob),
                                     int(seed) & _MASK64, num_threads,
                                     out.reshape(-1))
    if ran != num_threads:
        raise RuntimeError(f"random_walk ran on {ran} OpenMP threads, "
                           f"{num_threads} asked for")
    return out


def random_walk_reference(indptr, indices, starts, walk_length: int,
                          seed: int, num_threads: int,
                          restart_prob: float = 0.0) -> np.ndarray:
    """Plain version of :func:`random_walk`: the ``num_threads`` streams
    replayed in numpy, every thread's walks advanced together, a stream
    drawing only where its thread's walk draws (the restart test when
    ``restart_prob > 0``, then a neighbour where the node has an edge).
    Gives the library's walks bit for bit."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    starts = np.asarray(starts, np.int64)
    T, L = int(num_threads), int(walk_length)
    _check_walks(indptr, starts, L, restart_prob, T)
    n = starts.shape[0]
    out = np.empty((n, L), np.int64)
    out[:, 0] = starts
    # C++'s (uint64_t)(p * (double)UINT64_MAX); the double is 2**64
    cut = np.uint64(int(restart_prob * float(2 ** 64)))
    bounds = n * np.arange(T + 1, dtype=np.int64) // T
    with np.errstate(over="ignore"):
        state = [np.full(T, np.uint64(int(seed) & _MASK64)
                         ^ np.uint64(0x9E3779B97F4A7C15)),
                 np.arange(1, T + 1, dtype=np.uint64)
                 * np.uint64(0xBF58476D1CE4E5B9) + np.uint64(1)]
        for _ in range(8):
            _xorshift_next(state)

        def draw(mask):
            """One number from the streams of ``mask``; the others wait."""
            sub = [state[0][mask], state[1][mask]]
            vals = np.zeros(T, np.uint64)
            vals[mask] = _xorshift_next(sub)
            state[0][mask], state[1][mask] = sub
            return vals

        for k in range(int((bounds[1:] - bounds[:-1]).max(initial=0))):
            live = bounds[:-1] + k < bounds[1:]
            rows = np.minimum(bounds[:-1] + k, max(n - 1, 0))
            cur = starts[rows].copy()
            for t in range(1, L):
                move = live.copy()
                if restart_prob > 0.0:
                    r = draw(live)
                    move &= ~(r < cut)
                    cur = np.where(live & (r < cut), starts[rows], cur)
                lo = indptr[cur]
                deg = indptr[cur + 1] - lo
                step = move & (deg > 0)
                d = draw(step)
                off = (d % np.maximum(deg, 1).astype(np.uint64)).astype(
                    np.int64)
                cur = np.where(step, indices[np.where(step, lo + off, 0)],
                               cur)
                out[rows[live], t] = cur[live]
    return out
