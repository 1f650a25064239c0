"""The port stands alone: no module of daala_tpu_torch, nor chip_smoke.py,
imports anything of the JAX package, and the port's copies of the JAX
package's jax-free host codec (codec/, entropy/, native/, the numpy
ops/, utils/logging.py, utils/dump.py, utils/y4m.py, utils/metrics.py,
utils/ogg.py, utils/granule.py)
and of its training subsystem (train/) equal their originals apart
from their import lines and the definitions listed in COPIES, which
carry the port's device tier where the original has its JAX one.  The
encoder's Python coefficient path is an exact copy; only its choice
differs, as the port raises without the native engine where the
original falls back to it.

Every value compared is an integer, so the tolerance is zero.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from daala_tpu.codec import mc as jmc
from daala_tpu.ops import _lifting as jL
from daala_tpu.ops import intrin as jintrin
from daala_tpu_torch.codec import mc as tmc
from daala_tpu_torch.ops import _lifting as tL
from daala_tpu_torch.ops import intrin as tintrin
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "daala_tpu_torch")

NETWORKS = ["%s%d" % (k, n) for n in (4, 8, 16, 32, 64)
            for k in ("fdct", "idct")] + [
    "%s_filter%d" % (k, n) for n in (4, 8, 16, 32) for k in ("pre", "post")]

# Each copied module, with the definitions (module-level functions,
# Class.method, or "stmt:<names it binds>") where the copy differs from
# daala_tpu's: the port's device tier in place of the JAX one, the
# native engine loaded at first use, what those changes left unused,
# and no silent fallback to the encoder's Python coefficient path.
COPIES = {
    "codec/blocksize.py": (),
    "codec/decoder.py": (
        # use_device_synthesis with the port's back end
        # (models/synthesis.py, models/restore.py) on `device`, and its
        # batched dering
        "Decoder.__init__", "Decoder._decode_coefficients_native",
        "Decoder._apply_dering_device", "Decoder._decode_coefficients",
        "Decoder._decode_dering",
        # devstats host spans
        "Decoder.decode_packet"),
    "codec/dist.py": (),
    "codec/encoder.py": (
        # device, use_device_analysis, use_device_pvq and
        # mv_refine_mode: the port's analysis, PVQ search, SAD fields
        # and sweep
        "Encoder.__init__", "Encoder.mv_refine_mode",
        "Encoder.mv_refine_mode#2", "Encoder._encode_one",
        # the Python coefficient path only where the caller asks for
        # it: a missing native engine raises instead of falling back
        "Encoder._encode_coefficients",
        # device dering: the port's candidates on `device`
        "Encoder._encode_coefficients_native",
        # the check's embedded decoder is asked for as the host decoder
        "Encoder._encoder_check"),
    "codec/headers.py": (),
    "codec/mc.py": ("stmt:_NLIB", "_nlib", "pred_l0_native",
                    "_predict_frame_plane_native"),
    # the port's sweep; the greedy refinement's counters
    "codec/mvest.py": ("refine_sweep", "estimate_all_native"),
    "codec/pvq_codec.py": (),
    "codec/quantizer.py": (),
    "codec/rate.py": (),
    "codec/state.py": (),
    "codec/wavelet.py": (),
    "entropy/__init__.py": (),
    "entropy/adapt.py": (),
    "entropy/ec.py": (),
    "entropy/ec_native.py": (),
    "entropy/models.py": (),
    "native/__init__.py": ("get_lib",),  # the engine starts threads
    "ops/_lifting.py": (),
    "ops/_tables.py": (),
    # numpy or torch in place of numpy or jax.numpy; blocks_of/unblocks
    "ops/dct.py": ("stmt:_NLIB", "_native_dct2d", "_xp", "_stack",
                   "blocks_of", "unblocks"),
    "ops/dering.py": (),
    "ops/filter.py": (),
    "ops/haar.py": (),
    "ops/intra.py": (),
    "ops/intrin.py": (),
    "ops/partition.py": ("coding_to_raster",),  # numpy only
    "ops/pvq.py": (),
    # The training subsystem: the numpy table generators as they are;
    # the k-means step, the coding-gain search and the zigzag statistics
    # on a torch device (a card by default) in place of JAX
    "train/__init__.py": (),
    "train/basis.py": (),
    "train/cos_search.py": (),
    "train/gain.py": ("_const", "_params", "_filter_matrix", "dct_matrix",
                      "ar_autocorrelation", "coding_gain_1d", "search",
                      "main"),
    "train/laplace.py": (),
    "train/vq.py": ("_make_step_jax", "_make_step_torch", "_segment_sums",
                    "train", "main"),
    "train/zigzag.py": ("measure_mags", "read_luma", "main"),
    "utils/dump.py": (),
    "utils/granule.py": (),
    "utils/logging.py": (),
    "utils/metrics.py": (),
    "utils/ogg.py": (),
    "utils/y4m.py": (),
}
NATIVE_SOURCES = ["ec_core.cc", "bs_enc.inc", "frame_dec.inc",
                  "frame_enc.inc", "lifting_gen.inc", "me_enc.inc"]
# The native sources whose copy differs from the original, by top-level
# piece (_cpp_pieces): the greedy refinement of me_enc.inc runs as a
# wavefront over host threads, bit-identical to the original's serial
# loop (tests/test_torch_me_wavefront.py).
NATIVE_DIVERGES = {
    "me_enc.inc": dict(
        # new in the port: the headers, the lanes, the thread pool, the
        # report, the wavefront
        added=("#include <atomic>", "#include <condition_variable>",
               "#include <functional>", "#include <memory>",
               "#include <mutex>", "#include <thread>",
               "#include <linux/futex.h>", "#include <sched.h>",
               "#include <sys/syscall.h>", "#include <time.h>",
               "#include <unistd.h>",
               "RefineLane", "lane_ctx", "lane_eval_block", "RefinePool",
               "RefineReport", "RefineWave", "refine_vertex", "RowDone",
               "refine_wave_pass"),
        # each lane's plane, memo and rects in place of the context's;
        # atomic block sums read once a vertex; the prelude over the lanes
        changed=("fc_refresh_block", "fc_build", "fc_region_sad",
                 "fc_eval_cand", "refine_mvs", "refine_mvs_impl"),
        # every line of the original kept, in order: the report's line
        extended=("me_estimate",)),
}


def _port_modules():
    """Every module of daala_tpu_torch, by dotted name."""
    names = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f[:-3]), REPO)
                names.append(rel.replace(os.sep, ".").replace(
                    ".__init__", ""))
    return sorted(names)


def test_device_layer_imports_no_daala_tpu_and_no_jax():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    process: no daala_tpu and no jax module is loaded."""
    mods = _port_modules() + ["chip_smoke"]
    for name in ("daala_tpu_torch.ops.cuda.obmc_kernels",
                 "daala_tpu_torch.codec.encoder",
                 "daala_tpu_torch.models.pvqsearch",
                 "daala_tpu_torch.models.mefield",
                 "daala_tpu_torch.models.restore",
                 "daala_tpu_torch.models.synthesis",
                 "daala_tpu_torch.native", "daala_tpu_torch.utils.profile",
                 "daala_tpu_torch.parallel", "daala_tpu_torch.parallel.mesh",
                 "daala_tpu_torch.parallel.dryrun", "daala_tpu_torch.train",
                 "daala_tpu_torch.train.vq", "daala_tpu_torch.train.gain",
                 "daala_tpu_torch.train.zigzag",
                 "daala_tpu_torch.utils.sweep_quality",
                 "daala_tpu_torch.tools.encode",
                 "daala_tpu_torch.tools.decode"):
        assert name in mods
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('daala_tpu', 'jax')"
            " or m.startswith(('daala_tpu.', 'jax.')))\n"
            "print(len(%r), 'modules;', 'leaked:', bad)\n"
            "sys.exit(1 if bad else 0)\n" % (mods, mods))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr


class _ToPort(ast.NodeTransformer):
    """daala_tpu.x -> daala_tpu_torch.x in import statements."""

    @staticmethod
    def _name(name):
        return re.sub(r"^daala_tpu(?=\.|$)", "daala_tpu_torch", name)

    def visit_ImportFrom(self, node):
        node.module = self._name(node.module or "")
        return node

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._name(a.name)
        return node


def _bound_names(node):
    return sorted({n.id for n in ast.walk(node)
                   if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)})


def _definitions(path, to_port):
    """{name: ast dump} of a module's definitions: module-level functions
    and classes (each method as Class.method, repeats as name#2), other
    statements as stmt:<names they bind>.  The module docstring and the
    module-level imports are left out."""
    with open(path) as f:
        tree = ast.parse(f.read())
    if to_port:
        tree = _ToPort().visit(tree)
    out = {}

    def put(key, node):
        k, i = key, 1
        while k in out:
            i += 1
            k = "%s#%d" % (key, i)
        out[k] = ast.dump(node)

    body = tree.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    for node in body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    put(node.name + "." + m.name, m)
                else:
                    put(node.name + ".stmt:" + ",".join(_bound_names(m)), m)
            header = ast.ClassDef(name=node.name, bases=node.bases,
                                  keywords=node.keywords, body=[],
                                  decorator_list=node.decorator_list)
            put(node.name, header)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            put(node.name, node)
        else:
            put("stmt:" + ",".join(_bound_names(node)), node)
    return out


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_differs_only_where_listed(rel):
    orig = _definitions(os.path.join(REPO, "daala_tpu", rel), True)
    copy = _definitions(os.path.join(PKG, rel), False)
    differ = sorted(k for k in set(orig) | set(copy)
                    if orig.get(k) != copy.get(k))
    assert differ == sorted(COPIES[rel])


def _cpp_pieces(text):
    """({name: lines}, rest) of a C++ source, blank lines left out: each
    top-level definition at column 0 (a function `... name(`, `struct
    name`, `class name`) with the comment lines directly above it,
    through the next line at column 0 that opens with '}' (a declaration
    ending in ';', or a body on the header's line, on its line alone),
    under its name (a declaration and its definition under one); each
    #include line under itself; every other line in `rest`."""
    pieces, rest, pending = {}, [], []
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip():
            rest += pending
            pending = []
            continue
        if line.startswith("//"):
            pending.append(line)
            continue
        m = re.match(r"(?:struct|class) (?:alignas\(\d+\) )?(\w+)", line)
        f = None
        if line[:1].isalpha() and not line.startswith(
                ("namespace", "extern", "using", "template")):
            f = re.match(r"[^;{(]*?(\w+)\(", line)
        name = (line if line.startswith("#include")
                else m.group(1) if m else f.group(1) if f else None)
        if name is None:
            rest += pending + [line]
            pending = []
            continue
        span = pending + [line]
        pending = []
        one_line = line.rstrip().endswith(";") or (
            "{" in line and line.count("{") == line.count("}"))
        if name != line and not one_line:
            while not lines[i].startswith("}"):
                if lines[i].strip():
                    span.append(lines[i])
                i += 1
            span.append(lines[i])
            i += 1
        pieces.setdefault(name, []).extend(span)
    return pieces, rest + pending


def _is_subsequence(short, long):
    it = iter(long)
    return all(line in it for line in short)


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_source_is_the_original(name):
    """Byte for byte, but for the named pieces of NATIVE_DIVERGES: those
    added are the port's alone, those changed differ, those extended keep
    every line of the original in order, and every other piece and line
    is the original's."""
    with open(os.path.join(REPO, "daala_tpu", "native", name)) as f:
        orig = f.read()
    with open(os.path.join(PKG, "native", name)) as f:
        copy = f.read()
    if name not in NATIVE_DIVERGES:
        assert copy == orig
        return
    named = NATIVE_DIVERGES[name]
    o_pieces, o_rest = _cpp_pieces(orig)
    c_pieces, c_rest = _cpp_pieces(copy)
    assert c_rest == o_rest
    for k in named["added"]:
        assert k in c_pieces and k not in o_pieces, k
    for k in named["changed"] + named["extended"]:
        assert k in o_pieces and c_pieces.get(k, o_pieces[k]) != o_pieces[k], k
    for k in named["extended"]:
        assert _is_subsequence(o_pieces[k], c_pieces[k]), k
    differ = sorted(k for k in set(o_pieces) | set(c_pieces)
                    if o_pieces.get(k) != c_pieces.get(k))
    assert differ == sorted(sum(named.values(), ()))


def test_cpp_pieces_find_every_definition():
    """The splitter of the native sources names every definition of
    me_enc.inc the original has, and its rest holds no function body."""
    with open(os.path.join(REPO, "daala_tpu", "native", "me_enc.inc")) as f:
        pieces, rest = _cpp_pieces(f.read())
    for k in ("Grid", "MeCtx", "FieldCache", "refine_mvs", "refine_mvs_impl",
              "fc_eval_cand", "try_vertex", "me_estimate", "sweep_ctx"):
        assert k in pieces, k
    assert len(pieces["refine_mvs_impl"][0]) < 80  # its declaration first
    assert not any(line.startswith("  if (") for line in rest)


def test_lifting_copy_differs_only_in_its_import_line():
    with open(jL.__file__) as f:
        orig = f.read().splitlines()
    with open(tL.__file__) as f:
        copy = f.read().splitlines()
    assert len(orig) == len(copy)
    diff = [(a, b) for a, b in zip(orig, copy) if a != b]
    assert diff == [("from daala_tpu.ops.intrin import dct_rshift, c_div",
                     "from daala_tpu_torch.ops.intrin import dct_rshift, "
                     "c_div")]


@pytest.mark.parametrize("name", NETWORKS)
def test_lifting_copy_matches_jax_package(name):
    """The port's network on torch int32 tensors == the JAX package's on
    numpy int32 arrays, on inputs that reach the int32 wraparound."""
    n = int(re.search(r"\d+$", name).group())
    rng = np.random.default_rng(n + len(name))
    x = [rng.integers(-(1 << 16), 1 << 16, 257).astype(np.int32)
         for _ in range(n)]
    x[0][:4] = [(1 << 31) - 1, -(1 << 31), (1 << 30), -(1 << 30)]
    with np.errstate(over="ignore"):
        want = getattr(jL, name)([v.copy() for v in x])
    got = getattr(tL, name)([torch.from_numpy(v.copy()) for v in x])
    assert len(got) == n
    for k in range(n):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_intrin_copy_matches_jax_package():
    assert tintrin.OD_COEFF_SHIFT == jintrin.OD_COEFF_SHIFT
    rng = np.random.default_rng(1)
    a = rng.integers(-(1 << 20), 1 << 20, 1000).astype(np.int32)
    b = rng.integers(1, 300, 1000).astype(np.int32) * rng.choice([-1, 1],
                                                                 1000)
    b = b.astype(np.int32)
    for sh in range(0, 16):
        np.testing.assert_array_equal(
            tintrin.dct_rshift(torch.from_numpy(a), sh).numpy(),
            jintrin.dct_rshift(a, sh))
        assert tintrin.dct_rshift(-12345, sh) == jintrin.dct_rshift(-12345,
                                                                    sh)
    np.testing.assert_array_equal(
        tintrin.c_div(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        jintrin.c_div(a, b))
    for x, y in ((7, 2), (-7, 2), (7, -2), (-7, -2), (0, 5)):
        assert tintrin.c_div(x, y) == jintrin.c_div(x, y)


def test_mc_constants_match_jax_package():
    for name in ("OD_BUFFER_PADDING", "OD_LOG_MVB_DELTA0", "OD_MVB_DELTA0",
                 "OD_VERT_DX", "OD_VERT_DY", "VERT_SETUP_DX",
                 "VERT_SETUP_DY"):
        assert getattr(tmc, name) == getattr(jmc, name), name
    assert tmc.SUBPEL_FILTER_SET.dtype == jmc.SUBPEL_FILTER_SET.dtype
    np.testing.assert_array_equal(tmc.SUBPEL_FILTER_SET,
                                  jmc.SUBPEL_FILTER_SET)
    for x in range(-300, 301):
        for shift in range(3):
            assert tmc.div_pow2_re(x, shift) == jmc.div_pow2_re(x, shift)


@pytest.mark.parametrize("log_x", [2, 3, 4, 5, 6])
def test_mc_setup_s_split_matches_jax_package(log_x):
    for log_y in range(2, 7):
        for oc in range(4):
            for s in range(4):
                assert (tmc._setup_s_split(oc, s, log_x, log_y)
                        == jmc._setup_s_split(oc, s, log_x, log_y))
