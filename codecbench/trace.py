"""The traced run's profile of the window, read in memory (no trace file
is written).

`Recorder` runs torch.profiler over the whole window, puts every
devstats span of the port in a profiler range of its name ("span:"
and the name), and every call of a hand kernel that codecbench/kernels/
counts in a range ("kernel:" and its file's name) with the call's
bytes and operations.  `stop` reduces the events to a `Summary`:

- busy_s: the union of the device's kernel, copy and set intervals
  (the port's utils/profile.py arithmetic), over window_s;
- device time and launch count by kernel name, and the kernels the
  port writes by hand (their names from each ops/cuda module's
  KERNELS) apart from PyTorch's own;
- each hand-kernel call's device time (the work its range launched,
  by correlation id) beside its bound (codecbench/roofline.py);
- the idle gaps between busy intervals, each labelled by the innermost
  port span open on the host at its middle ("host" where none is).
"""

from __future__ import annotations

import contextlib
import importlib
import pkgutil

import torch

from codecbench import roofline

_DEVICE_KINDS = ("kernel", "copy")
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def hand_kernel_names():
    """The __global__ function names of the port's hand kernels: every
    daala_tpu_torch.ops.cuda module's KERNELS."""
    import daala_tpu_torch.ops.cuda as pkg
    names = []
    for m in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(pkg.__name__ + "." + m.name)
        names += list(getattr(mod, "KERNELS", ()))
    return tuple(names)


def kind(e):
    """"annotation" (a profiler range on the host), "kernel" or "copy"
    (a copy or a set on the card), "device_annotation", or "host"."""
    on_card = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "device_annotation" if on_card else "annotation"
    if not on_card:
        return "host"
    return "copy" if e.name().startswith(("Memcpy", "Memset")) else "kernel"


def union_s(intervals):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    busy, end = 0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy / 1e9


class Summary:
    """The reduced trace of one window."""

    def __init__(self, window_s):
        self.window_s = window_s
        self.busy_s = 0.0
        self.launches = 0
        self.by_kernel = {}  # name -> [seconds, launches]
        self.hand = set()  # names of the hand kernels seen
        self.copies = set()  # names of the copies and sets seen
        self.calls = []  # (kernel file, device s, bound s) a call
        self.gaps = {}  # host label -> idle seconds
        self.reduce_s = None  # seconds that reading the trace took

    def breakdown(self):
        """The 10 device operations that took most time (by name, cut
        to 200 characters) and the 10 host labels with the most idle
        device time, in seconds."""
        ops = sorted(((k[:200], v[0]) for k, v in self.by_kernel.items()),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}

    def kernel_seconds(self, hand):
        """Device seconds of the hand kernels, or of PyTorch's own."""
        return sum(v[0] for k, v in self.by_kernel.items()
                   if k not in self.copies and (k in self.hand) == hand)


class Recorder:
    """Profiles the window; start() before it, stop(window_s) after."""

    def __init__(self, dev, root="."):
        self.dev = dev
        self.kernels = roofline.load_kernels(root)
        self._undo = []
        self._pending = []  # (kernel file, range index, work or thunk)
        self._seq = 0
        self.prof = None

    def _patch(self, mod, name, new):
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, new)

    def start(self):
        from daala_tpu_torch.utils import devstats
        orig_span = devstats.span

        @contextlib.contextmanager
        def span(name):
            with torch.profiler.record_function("span:" + name):
                with orig_span(name):
                    yield
        self._patch(devstats, "span", span)
        for kname, kmod in self.kernels.items():
            mod = importlib.import_module(kmod.WRAPPER[0])
            self._patch(mod, kmod.WRAPPER[1],
                        self._wrap(kname, kmod,
                                   getattr(mod, kmod.WRAPPER[1])))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def _wrap(self, kname, kmod, fn):
        def call(*args, **kw):
            tag = "kernel:%s#%d" % (kname, self._seq)
            self._seq += 1
            self._pending.append((kname, tag, kmod.work(args)))
            with torch.profiler.record_function(tag):
                return fn(*args, **kw)
        return call

    def stop(self, window_s):
        self.prof.__exit__(None, None, None)
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []
        events = self.prof.profiler.kineto_results.events()
        s = Summary(window_s)
        hand_names = hand_kernel_names()
        dev_by_corr = {}
        busy = []
        kinds = [kind(e) for e in events]
        for e, k in zip(events, kinds):
            if k not in _DEVICE_KINDS:
                continue
            t0, t1 = e.start_ns(), e.end_ns()
            busy.append((t0, t1))
            name = e.name()
            row = s.by_kernel.setdefault(name, [0.0, 0])
            row[0] += (t1 - t0) / 1e9
            row[1] += 1
            if k == "copy":
                s.copies.add(name)
            elif any(h in name for h in hand_names):
                s.hand.add(name)
            c = e.correlation_id()
            dev_by_corr[c] = dev_by_corr.get(c, 0) + (t1 - t0)
        s.launches = len(busy)
        s.busy_s = union_s(busy)
        launches = sorted(
            (e.start_ns(), e.correlation_id())
            for e, k in zip(events, kinds)
            if k == "host" and e.name().startswith(_LAUNCH_CALLS))
        ranges = {}
        spans = []
        for e, k in zip(events, kinds):
            if k != "annotation":
                continue
            name = e.name()
            if name.startswith("kernel:"):
                ranges[name] = (e.start_ns(), e.end_ns())
            elif name.startswith("span:"):
                spans.append((e.start_ns(), e.end_ns(), name[5:]))
        self._calls(s, ranges, launches, dev_by_corr)
        self._gaps(s, busy, spans)
        return s

    def _calls(self, s, ranges, launches, dev_by_corr):
        import bisect
        starts = [t for t, _ in launches]
        for kname, tag, work in self._pending:
            if tag not in ranges:
                continue
            t0, t1 = ranges[tag]
            lo = bisect.bisect_left(starts, t0)
            hi = bisect.bisect_right(starts, t1)
            dev_ns = sum(dev_by_corr.get(c, 0) for _, c in launches[lo:hi])
            if dev_ns <= 0:
                continue
            nbytes, ops = work() if callable(work) else work
            s.calls.append((kname, dev_ns / 1e9,
                            roofline.bound_s(nbytes, ops)))
        self._pending = []

    @staticmethod
    def _gaps(s, busy, spans):
        import bisect
        merged = []
        for t0, t1 in sorted(busy):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])]
        mids = [(a + b) // 2 for a, b in gaps]
        best = [None] * len(gaps)  # (span length, name) of the innermost
        for st, en, name in spans:
            for i in range(bisect.bisect_left(mids, st),
                           bisect.bisect_right(mids, en)):
                if best[i] is None or en - st < best[i][0]:
                    best[i] = (en - st, name)
        for (a, b), lab in zip(gaps, best):
            label = "host" if lab is None else lab[1]
            s.gaps[label] = s.gaps.get(label, 0.0) + (b - a) / 1e9
