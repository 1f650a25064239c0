"""The readers of the port's host spans (metrics/host_passes.py and
the eight metrics that use it) on traced 64x64 cells, and on a program
that keeps no host spans, as the port before them."""

import time

import pytest

from codecbench import run as R

SEED = 2 ** 33 + 29
NEW = {"tiny-translation": ("motion_search_ms_per_frame",
                            "mc_predict_ms_per_frame.enc",
                            "trial_pass_ms_per_frame",
                            "code_frame_ms_per_frame",
                            "untraced_ms_per_frame.enc"),
       "tiny-play": ("native_parse_ms_per_frame",
                     "mc_predict_ms_per_frame.dec",
                     "untraced_ms_per_frame.dec")}


def _traced(root, workload):
    result, checked = R.run_cell(workload, SEED, 0.5, 1, root=root,
                                 device="cpu", t_start=time.perf_counter())
    assert result["correct"], checked
    return result["metrics"]


@pytest.mark.parametrize("workload", sorted(NEW))
def test_host_span_metrics_report(tiny_root, workload):
    got = _traced(tiny_root, workload)
    for name in NEW[workload]:
        assert got[name]["unit"] == "ms"
        assert got[name]["value"] >= 0, name
    # what the spans do not cover is part of the older remainders
    if workload == "tiny-play":
        rest = got["parse_ms_per_frame"]["value"]
        assert got["native_parse_ms_per_frame"]["value"] <= rest
    else:
        rest = got["host_rest_ms_per_frame"]["value"]
        assert got["untraced_ms_per_frame.enc"]["value"] <= rest


@pytest.mark.parametrize("workload", sorted(NEW))
def test_no_host_spans_leaves_them_out(tiny_root, workload, monkeypatch):
    """A program whose devstats has no host spans: the new metrics are
    left out of the line and every older one still reports."""
    from daala_tpu_torch.utils import devstats
    real = devstats.snapshot

    def older():
        s = real()
        del s["host_spans_s"]
        return s

    monkeypatch.setattr(devstats, "snapshot", older)
    got = _traced(tiny_root, workload)
    assert not set(NEW[workload]) & set(got)
    assert got
