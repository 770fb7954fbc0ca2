"""Build the port's CUDA and host C++ sources into shared libraries and
load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into
``<repo>/build/<name>-<source hash>.so`` and loaded with ``ctypes``; a
changed source, or a changed shared header ``csrc/*.cuh``, gets a new hash
and so a fresh build. The host sources,
``csrc/<name>.cpp`` (the resize loops of ``data/imresize.py``), are built
the same way with ``g++`` (``build_host``, ``load_host``). Nothing is
built when a module is imported, so the package imports on a machine
without CUDA.

Every kernel wrapper calls its C entry the same way: ``check`` raises its
``ValueError``s, ``dispatch`` runs its plain version on the CPU and its
kernel on CUDA, ``entry`` declares the entry's argument types once, and
``launch`` calls it on the current stream of the tensors' device and
turns its error code into a ``RuntimeError``. ``split_bf16`` is the
hi + lo split that the kernels on split bf16 operands share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC)]
# no -march=native: without FMA contraction the host loops round as
# numpy's multiply-then-add does
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-pthread"]

_LIBS: dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()
# name -> (seconds, compiler log) of the build this process ran
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path(name, suffix=".cu"):
    src = CSRC / f"{name}{suffix}"
    digest = hashlib.sha256(src.read_bytes())
    if suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(name, src, lib, command):
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*command, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{command[0]} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return lib


def build(name):
    """Compile ``csrc/<name>.cu`` unless the hashed library exists.
    Returns the library path; raises with the compiler output on failure."""
    src, lib = library_path(name)
    return _compile(name, src, lib, [_nvcc(), *NVCC_FLAGS])


def build_host(name):
    """Compile ``csrc/<name>.cpp`` with g++ unless the hashed library
    exists. Returns the library path; raises with the compiler output on
    failure (or when g++ is missing)."""
    src, lib = library_path(name, ".cpp")
    gxx = shutil.which("g++")
    if not gxx:
        raise RuntimeError(f"g++ not found on PATH: cannot build {src}")
    return _compile(name, src, lib, [gxx, *GXX_FLAGS])


def build_all():
    """Build every ``csrc/*.cu`` at once, one nvcc process per source.
    Returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def load_host(name):
    """The ctypes handle of ``csrc/<name>.cpp``, built on first use."""
    with _HOST_LOCK:  # the data loader's worker threads resize at once
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build_host(name)))
    return _LIBS[name]


def check(name, cond, msg):
    """Raise ``ValueError(f"{name}: {msg}")`` unless ``cond``."""
    if not cond:
        raise ValueError(f"{name}: {msg}")


def dispatch(name, device, plain, kernel):
    """``plain()`` on the CPU, ``kernel()`` on CUDA; raises on other devices."""
    if device.type == "cpu":
        return plain()
    check(name, device.type == "cuda", f"unsupported device {device}")
    return kernel()


def split_bf16(t):
    """t as the f32 values of its bf16 pair: hi = bf16(t), lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def entry(name, symbol, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built and loaded on
    first use), its ``argtypes`` and int return code declared on first use."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(name, fn, device, *args):
    """``fn(*args, stream)`` under ``device``, on its current stream, each
    tensor in ``args`` passed as its data pointer. Raises ``RuntimeError``
    when the C entry returns a CUDA error code."""
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
