"""Build and load the port's CUDA kernels.

Each ``gncde_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers: a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/gncde_tpu_torch/<name>_<hash>.so <name>.cu

The build runs at first use, inside the process that launches the kernel,
never at import; :func:`build` compiles several sources at once, one
``nvcc`` each, all started together. The library's file name carries a hash
of its sources (the ``.cu`` file and every ``.cuh`` header beside it), so an
edited source rebuilds and a stale library is never loaded. Every C entry
point returns a ``cudaError_t``; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gncde_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: tp.Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: Seconds spent in ``nvcc`` by this process, per library.
BUILD_SECONDS: tp.Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from source at first use"
    )


def _source_hash(src: Path) -> str:
    h = hashlib.sha256()
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return BUILD_DIR / f"{name}_{_source_hash(src)}.so"


def _compile(name: str, lib_path: Path) -> None:
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    src = CSRC / f"{name}.cu"
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-O3", "-std=c++17", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}",
        "-o", str(tmp), str(src),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    (BUILD_DIR / f"{name}.ptxas.log").write_text(proc.stderr)
    os.replace(tmp, lib_path)


def sources() -> tp.List[str]:
    """Names of every ``csrc/<name>.cu`` (each is one library)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: tp.Sequence[str]) -> None:
    """Compile the named ``csrc/<name>.cu`` that are not built yet, one
    ``nvcc`` process each, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _lib_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            for fut in [pool.submit(_compile, n, p) for n, p in todo]:
                fut.result()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} reported by the launch")


#: Streaming multiprocessors of the card the launch plans are sized for (an
#: H100 SXM): K3's split (``tiled.fwd2_splits``) and K10's CTA size.
SMS = 132

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def ptr(t) -> P:
    """Device pointer of a tensor (``None`` -> NULL)."""
    return P(0 if t is None else t.data_ptr())


def stream(device_index: tp.Optional[int] = None) -> int:
    """The current CUDA stream of a device (by default the current device)
    as an integer ``cudaStream_t``. PyTorch's CUDA build answers with a raw
    query, so no ``torch.cuda.Stream`` object is made per launch."""
    import torch

    if device_index is None:
        device_index = torch.cuda.current_device()
    query = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if query is None:
        return torch.cuda.current_stream(device_index).cuda_stream
    return query(device_index)
