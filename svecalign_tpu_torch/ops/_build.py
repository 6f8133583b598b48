"""Build and load the port's CUDA kernels and host libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
into ``svecalign_tpu_torch/build/lib<name>-<digest>.so`` for ``sm_90a``,
then loaded with ctypes. The digest covers the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. Nothing
is built when the package is imported: the first :func:`load` of a kernel
builds it, and :func:`build_all` starts one nvcc per source at once.

The host libraries (``csrc/<name>.cpp``: the Vorbis reader and writer,
the float64 DP) are built the same way by g++ at first use,
:func:`build_host_library`, each with its own flags.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

from svecalign_tpu_torch.parallel.mesh import current_shard
from svecalign_tpu_torch.utils import trace

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# per-source flags, after NVCC_FLAGS
SOURCE_FLAGS = {
    # no FMA contraction: the DPs must match their plain versions bit for bit
    "banded_dp": ("--fmad=false",),
    "dense_dp": ("--fmad=false",),
}

_libs: Dict[str, ctypes.CDLL] = {}

SHARD_LAUNCHES: Counter = Counter()
"""Launches by ``(data shard, counter key)``, for work issued inside
``parallel.mesh.shard_scope``: each wrapper's ``LAUNCHES`` counts every
launch, this counts those of each shard of a mesh."""

_held = threading.local()


def count_launch(launches: dict, *keys: str, counter: Optional[str] = None) -> None:
    """Add one launch to ``launches[key]`` for each key, to
    :data:`SHARD_LAUNCHES` under the shard being issued, and to the
    tracer's counter ``counter`` if one is given. A wrapper calls it where
    it launches its kernel, and nowhere else.

    Inside :func:`holding_launches` (a CUDA graph's warm-up or capture)
    the launch is recorded instead of counted: a captured launch runs at
    each replay, and :func:`count_replay` counts it there."""
    held = getattr(_held, "launches", None)
    if held is not None:
        held.append((launches, keys, counter))
        return
    _count(launches, keys, counter)


def _count(launches: dict, keys, counter: Optional[str]) -> None:
    shard = current_shard()
    for key in keys:
        launches[key] += 1
        if shard is not None:
            SHARD_LAUNCHES[(shard, key)] += 1
    if counter is not None:
        trace.count(counter)


@contextlib.contextmanager
def holding_launches():
    """Record, on this thread, the launches :func:`count_launch` is told
    of inside the block instead of counting them; yields the record."""
    prev = getattr(_held, "launches", None)
    _held.launches = record = []
    try:
        yield record
    finally:
        _held.launches = prev


def count_replay(record) -> None:
    """Count once each launch of a :func:`holding_launches` record: one
    replay of the graph captured while it was made."""
    for launches, keys, counter in record:
        _count(launches, keys, counter)


def kernel_names():
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if "CUDA_HOME" in os.environ else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_flags(name: str) -> tuple:
    """Every nvcc flag of kernel ``name``; ptxas reports registers,
    shared memory and spills."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + ("-Xptxas", "-v")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


_build_lock = threading.Lock()


def prebuild(names: Iterable[str]) -> threading.Thread:
    """:func:`build_all` of ``names`` on a thread of its own, so that nvcc
    runs while the caller does other set-up; a later :func:`load` waits
    for it. A failed build here raises nothing: the :func:`load` that
    needs the kernel builds again and raises."""
    def run():
        try:
            build_all(names)
        except Exception:  # load() repeats the build and raises
            pass

    thread = threading.Thread(target=run, name="kernel-prebuild", daemon=True)
    thread.start()
    return thread


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named kernel (default: all of ``csrc/``) that is not
    built yet, one nvcc process per source, all started together. Returns
    each kernel's compiler output (ptxas register/shared-memory report;
    empty when it was already built). Raises if any build fails. One
    build runs at a time in a process (:func:`prebuild`'s thread too)."""
    with _build_lock:
        return _build_all(kernel_names() if names is None else list(names))


def _build_all(names) -> Dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [find_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    trace.count("build.kernels", len(procs))
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return logs


def build_host_library(name: str, flags: Sequence[str], link: Sequence[str] = (),
                       build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/<name>.cpp`` with g++ into
    ``build_dir/lib<name>-<digest>.so`` unless it is built (the digest
    covers the source, the flags and the link flags). Raises
    ``RuntimeError`` with the compiler's output when g++ is missing or
    fails; nothing is loaded in its place."""
    src = CSRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(tuple(flags) + tuple(link)).encode())
    out = Path(build_dir) / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    trace.count("build.kernels")
    try:
        res = subprocess.run(["g++", *flags, str(src), "-o", str(tmp), *link],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {src.name} needs g++, and there is none: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {src.name}:\n{res.stderr[-2000:]}")
    tmp.replace(out)  # atomic: concurrent builds each rename a whole library
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        build_all([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    return _libs[name]
