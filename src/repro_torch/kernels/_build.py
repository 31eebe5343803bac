"""Build the port's CUDA kernels from the sources in this package.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes).  Builds happen on first use, never at import:
the CPU tests import every module on machines with no ``nvcc``.  Outputs go
to ``kernels/build/`` (git-ignored), keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
``ptx`` compiles a source to PTX with the same flags, cached the same way,
and ``sass`` disassembles a built library, so the two texts of one source
can be set side by side (``repro_torch.core.isa``).  A build already
running in this process for the same library is waited for, not started
twice, so callers may load kernels while ``build_all`` runs in a thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CUDA_BIN = Path("/usr/local/cuda/bin")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded library (one per process; a rebuild needs a new process)
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> what the build in this process reported (a cached load does not
# overwrite a compile's entry)
BUILD_LOG: Dict[str, dict] = {}
# library path -> set when the compile of it running in this process ends
_RUNNING: Dict[Path, threading.Event] = {}
_RUNNING_LOCK = threading.Lock()


def _tool(name: str) -> str:
    """The CUDA toolkit's ``name`` (on PATH, else under ``CUDA_BIN``);
    raises, naming it, where the toolkit has none."""
    path = shutil.which(name) or str(CUDA_BIN / name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return path


def _digest(text: bytes) -> str:
    """The build key of a source: its text, the headers beside the kernels
    and the flags."""
    h = hashlib.sha256(text)
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, source: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``source``, the text of a variant of
    a kernel, under ``name``) unless an up-to-date library exists; returns
    its path.  Raises with nvcc's output when the build fails."""
    text = ((CSRC / f"{name}.cu").read_text() if source is None
            else source).encode()
    out = BUILD_DIR / f"lib{name}-{_digest(text)}.so"
    with _RUNNING_LOCK:
        running = _RUNNING.get(out)
        owner = running is None and not out.exists()
        if owner:
            _RUNNING[out] = threading.Event()
    if running is not None:
        running.wait()
    if not owner and out.exists():
        BUILD_LOG.setdefault(name, {"cached": True, "seconds": 0.0,
                                    "log": ""})
        return out
    # (a waiter whose compile failed compiles again, to raise nvcc's output)
    try:
        return _compile(name, source, text, out)
    finally:
        if owner:
            with _RUNNING_LOCK:
                _RUNNING.pop(out).set()


def _compile(name: str, source: Optional[str], text: bytes,
             out: Path) -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = CSRC / f"{name}.cu"
    if source is not None:      # beside csrc, so its includes resolve
        src = out.with_suffix(".cu")
        src.write_bytes(text)
    cmd = [_tool("nvcc"), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"cached": False, "seconds": secs,
                       "log": proc.stdout + proc.stderr}
    return out


def build_all(names: Optional[List[str]] = None,
              variants: Optional[Dict[str, str]] = None) -> Dict[str, Path]:
    """Build every kernel source at once, one nvcc process per source,
    and beside them ``variants`` (name -> source text)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: (n, None) for n in names}
    jobs.update({n: (n, src) for n, src in (variants or {}).items()})
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        futures = {n: pool.submit(build, *job) for n, job in jobs.items()}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib


def ptx(name: str, source: str) -> str:
    """The PTX of ``source`` (``nvcc -ptx``, sm_90a, the flags ``build``
    uses less the link step's ``-shared``), cached in the build directory
    under the key ``build`` gives the same text; returns the PTX text.
    Raises, naming the tool, where the toolkit is missing, and with nvcc's
    output where the compile fails."""
    text = source.encode()
    out = BUILD_DIR / f"{name}-{_digest(text)}.ptx"
    if out.exists():
        return out.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".ptx.cu")
    src.write_bytes(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    proc = subprocess.run([_tool("nvcc"), *flags, "-ptx", "-I", str(CSRC), "-o",
                           str(tmp), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc -ptx failed for {name} "
                           f"(rc={proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out.read_text()


def sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library.  Raises where the toolkit
    has no cuobjdump."""
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_mix(name: str, top: int = 16) -> Dict[str, dict]:
    """The SASS of ``csrc/<name>.cu``'s built library by ``cuobjdump
    -sass``: for each kernel function (mangled name), its instruction
    count and its ``top`` most frequent opcodes (with their modifiers, as
    ``HMMA.16816.F32.BF16``), counted by ``core.isa.sass_census``'s rule
    (no ``NOP`` padding, no self-loop ``BRA``).  Raises where the toolkit
    has no cuobjdump."""
    from repro_torch.core.isa.sass_census import census

    return {fn: {"instructions": c["n_ops"],
                 "top": dict(list(c["op_histogram"].items())[:top])}
            for fn, c in census(sass(build(name))).items()}
