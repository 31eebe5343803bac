"""Build the port's CUDA kernels from the sources in this package.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes).  Builds happen on first use, never at import:
the CPU tests import every module on machines with no ``nvcc``.  Outputs go
to ``kernels/build/`` (git-ignored), keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded library (one per process; a rebuild needs a new process)
_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> what the last build in this process reported
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build(name: str, source: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``source``, the text of a variant of
    a kernel, under ``name``) unless an up-to-date library exists; returns
    its path.  Raises with nvcc's output when the build fails."""
    text = ((CSRC / f"{name}.cu").read_text() if source is None
            else source).encode()
    h = hashlib.sha256(text)
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_LOG[name] = {"cached": True, "seconds": 0.0, "log": ""}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = CSRC / f"{name}.cu"
    if source is not None:      # beside csrc, so its includes resolve
        src = out.with_suffix(".cu")
        src.write_bytes(text)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
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


def sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library.  Raises where the toolkit
    has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def sass_mix(name: str, top: int = 16) -> Dict[str, dict]:
    """The SASS of ``csrc/<name>.cu``'s built library by ``cuobjdump
    -sass``: for each kernel function (mangled name), its instruction
    count and its ``top`` most frequent opcodes (with their modifiers, as
    ``HMMA.16816.F32.BF16``).  Raises where the toolkit has no cuobjdump."""
    import re
    from collections import Counter

    text = sass(build(name))
    func = re.compile(r"Function : (\S+)")
    inst = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")
    mixes: Dict[str, Counter] = {}
    cur = None
    for line in text.splitlines():
        m = func.search(line)
        if m:
            cur = mixes.setdefault(m.group(1), Counter())
            continue
        m = inst.search(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return {fn: {"instructions": sum(c.values()),
                 "top": dict(c.most_common(top))}
            for fn, c in mixes.items()}
