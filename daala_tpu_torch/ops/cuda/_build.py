"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles on first use, with the CUDA toolkit's
`nvcc`, into a shared library with a plain C interface under
`build/daala_tpu_torch/` at the repository root, and loads with ctypes.
The file name carries a hash of the sources (the `.cu` and the headers
of `csrc/`), so an edited source rebuilds and a stale library is never
loaded.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

from daala_tpu_torch.utils import devstats

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "daala_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

PTXAS: dict = {}  # source name -> ptxas's report of the build done now
_LIBS: dict = {}
_LOCKS: dict = {}  # source name -> its lock, so sources build in parallel
_LOCK = threading.Lock()  # guards _LOCKS


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def _digest(name):
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    srcs = [os.path.join(CSRC, name + ".cu")]
    srcs += sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load(name, entries):
    """The ctypes library built from csrc/<name>.cu, with each entry
    point `fn` of `entries` ({fn: argtypes}) declared as
    `int fn(*argtypes)`.  Builds on first use."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        so = os.path.join(BUILD_DIR, "%s-%s.so" % (name, _digest(name)))
        if not os.path.exists(so):
            _compile(name, so)
        lib = ctypes.CDLL(so)
        for fn_name, argtypes in entries.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def _compile(name, so):
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A unique temporary name, so that two processes building at once
    # never load a half-written library.
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp,
                                    os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed for %s.cu:\n%s%s"
                               % (name, r.stdout, r.stderr))
        os.replace(tmp, so)
        PTXAS[name] = r.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    devstats.built(name, time.perf_counter() - t0)


def ptxas_report(text):
    """[(kernel, registers, stack bytes, spill store bytes, spill load
    bytes)] for every entry function of a ptxas -v report, names
    demangled by c++filt where it is installed."""
    rows, name = [], None
    stack = spill_st = spill_ld = 0
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spill_st, spill_ld = map(int, m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), stack, spill_st, spill_ld])
            name, stack, spill_st, spill_ld = None, 0, 0, 0
    filt = shutil.which("c++filt")
    if rows and filt:
        r = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                           capture_output=True, text=True)
        names = r.stdout.splitlines()
        if r.returncode == 0 and len(names) == len(rows):
            for row, nm in zip(rows, names):
                row[0] = nm
    return [tuple(r) for r in rows]


def check(err, name):
    """Raise when a kernel's C entry returned a CUDA error code."""
    if err:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))
