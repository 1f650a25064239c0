"""The least time one NVIDIA H100 could take for a kernel call: the
published peaks and the counting rules of the hand kernels' bounds.

A call's bound is the larger of its bytes over the HBM bandwidth and,
for each type of operation it counts, those operations over their
peak.  Bytes count each logical input once and each output once,
whatever the kernel reads again.  Operations are those the algorithm
needs for the call's inputs, so that one call reads the same work
whatever implements it; a kernel whose file counts no operations is
bound by its bytes alone, and its share is then an upper estimate of
how near it runs to the card's limits only on the bandwidth side.

Each hand kernel has a file codecbench/kernels/<name>.py, which names
the port's function that launches it once a call (`WRAPPER`, a module
and a function) and gives `work(args)`: (bytes, {peak: operations}) of
the call's arguments.  A kernel without such a file is left out of
the share's sums.
"""

from __future__ import annotations

import ast
import functools
import importlib.util
import os

# NVIDIA's data sheet, H100 SXM, at the 700 W limit: HBM3 3.35 TB/s;
# float32 67 TFLOP/s outside the tensor cores (a fused multiply-add
# counts 2); int32 operations at 64 lanes of 132 SMs at the 1,980 MHz
# boost clock; 8-bit absolute differences with their accumulation at 4
# a lane (the video instructions' vabsdiff4).
PEAKS = {"bytes": 3.35e12, "fp32": 67e12, "int32": 132 * 64 * 1.98e9,
         "sad8": 4 * 132 * 64 * 1.98e9}


def bound_s(nbytes, ops):
    """Seconds of a call that moves nbytes and does ops ({peak name:
    operations}): the largest of its bounds."""
    return max([nbytes / PEAKS["bytes"]]
               + [v / PEAKS[k] for k, v in ops.items()])


@functools.lru_cache(maxsize=None)
def lifting_ops(name):
    """Operations of one lifting network of codecbench/reference/
    lifting.py (the codec's normative integer networks): each operator
    once, each dct_rshift or c_div as 4 (its add, sign, mask, shift)."""
    path = os.path.join(os.path.dirname(__file__), "reference",
                        "lifting.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return sum(1 if isinstance(n, (ast.BinOp, ast.UnaryOp)) else 4
               for n in ast.walk(fn)
               if isinstance(n, (ast.BinOp, ast.UnaryOp, ast.Call)))


def load_kernels(root):
    """{kernel name: module} of codecbench/kernels/*.py under `root`."""
    kdir = os.path.join(root, "codecbench", "kernels")
    out = {}
    for fname in sorted(os.listdir(kdir)) if os.path.isdir(kdir) else []:
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3]
        spec = importlib.util.spec_from_file_location(
            "codecbench_kernel_" + name.replace(".", "_"),
            os.path.join(kdir, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out
