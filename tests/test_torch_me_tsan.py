"""ThreadSanitizer on the port's native motion search: ec_core.cc built
with -fsanitize=thread, and the inter frame's motion-search call of a
two-frame lean encode replayed through it on 8 and 3 threads (the
refinement's wavefront, its thread pool and its prelude), each field
equal to the serial one.  Skips where the toolchain has no
ThreadSanitizer.

The replay runs in a subprocess that preloads the sanitizer's runtime;
it imports torch but runs none of its threads (its own, uninstrumented,
are not this test's), so every report is the engine's.
"""

import copy
import os
import pickle
import subprocess
import sys

import pytest

from daala_tpu_torch.codec import headers, mvest
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.utils.profile import make_natural_clip
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "daala_tpu_torch", "native", "ec_core.cc")

_REPLAY = r"""
import copy, pickle, sys
import numpy as np
from daala_tpu_torch.codec import mvest
import daala_tpu_torch.native as NM
assert NM.available(), "the sanitized engine failed to load"
grid, cur, refs, info, args, kw = pickle.load(open(sys.argv[1], "rb"))
fields = {}
for n in (8, 3, 1):
    g = copy.deepcopy(grid)
    assert mvest.estimate_all_native(g, cur, refs, info, *args, threads=n,
                                     **kw)
    fields[n] = (g.valid, g.ref, g.mv, g.mv1, g.global_mvs)
for n in (8, 3):
    for a, b in zip(fields[n][:4], fields[1][:4]):
        assert np.array_equal(a, b), n
    assert fields[n][4] == fields[1][4], n
print("TSAN_OK")
"""


def _tsan_runtime():
    try:
        out = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             capture_output=True, text=True)
    except OSError:
        return None
    path = out.stdout.strip()
    return path if os.path.sep in path and os.path.exists(path) else None


def _inter_call():
    """A copy of the arguments of a 320x192 lean encode's first inter
    frame's motion search."""
    calls = []
    real = mvest.estimate_all_native

    def rec(grid, cur, refs, info, *args, **kw):
        calls.append(copy.deepcopy((grid, cur, refs, info, args, kw)))
        return real(grid, cur, refs, info, *args, **kw)

    w, h = 320, 192
    enc = Encoder(headers.Info(pic_width=w, pic_height=h), quant=25,
                  complexity=7, device="cpu", use_device_analysis=False,
                  use_device_pvq=True)
    mvest.estimate_all_native = rec
    try:
        for frame in make_natural_clip(w, h, 2, seed=3):
            enc.encode_frame(frame)
    finally:
        mvest.estimate_all_native = real
    assert len(calls) == 1
    return calls[0]


def test_wavefront_under_thread_sanitizer(tmp_path):
    runtime = _tsan_runtime()
    if runtime is None:
        pytest.skip("g++ has no ThreadSanitizer runtime")
    lib = str(tmp_path / "ec_core_tsan.so")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fwrapv", "-ffp-contract=off",
         "-fno-math-errno", "-std=c++17", "-shared", "-fPIC", "-pthread",
         "-fsanitize=thread", SRC, "-o", lib],
        capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip("g++ cannot build with -fsanitize=thread: "
                    + build.stderr[-500:])
    call = str(tmp_path / "call.pkl")
    with open(call, "wb") as f:
        pickle.dump(_inter_call(), f)
    env = dict(os.environ, LD_PRELOAD=runtime, DAALA_TPU_NATIVE_LIB=lib,
               TSAN_OPTIONS="halt_on_error=1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    res = subprocess.run([sys.executable, "-c", _REPLAY, call], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "TSAN_OK" in res.stdout, (
        "--- stdout ---\n%s\n--- stderr ---\n%s"
        % (res.stdout[-4000:], res.stderr[-8000:]))
