"""The reader of mv_refine_ms_per_frame (the native motion search's
greedy refinement, devstats counter me_refine_us): on synthetic counter
snapshots, on traced 64x64 encode cells, and on a program that keeps no
such counter, as the port before it."""

import os
import time
from types import SimpleNamespace

import pytest

from codecbench import run as R
from codecbench.metrics import read_metrics

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NAME = "mv_refine_ms_per_frame"
SEED = 2 ** 33 + 31


def _run(mode, frames, counts):
    return SimpleNamespace(mode=mode, frames=frames,
                           stats={"counts": dict(counts)})


@pytest.mark.parametrize("mode,frames,counts,want", [
    ("encode", 4, {"me_refine_us": 2_000_000, "me_refine_visits": 9,
                   "me_refine_threads": 24}, 500.0),
    ("encode", 3, {"me_refine_us": 0}, 0.0),
    ("encode", 4, {"pvq_rows": 7}, None),      # a program without it
    ("decode", 4, {"me_refine_us": 1000}, None),
])
def test_reads_the_counter_a_frame(mode, frames, counts, want):
    assert read_metrics(REPO, NAME, _run(mode, frames, counts)) == want


def _traced(root, workload):
    result, checked = R.run_cell(workload, SEED, 0.5, 1, root=root,
                                 device="cpu", t_start=time.perf_counter())
    assert result["correct"], checked
    return result["metrics"]


@pytest.mark.parametrize("workload", ["tiny-natural", "tiny-sweep"])
def test_reported_in_traced_encode_cells(tiny_root, workload):
    got = _traced(tiny_root, workload)
    assert got[NAME]["unit"] == "ms"
    assert got[NAME]["value"] > 0
    assert got[NAME]["value"] <= got["motion_search_ms_per_frame"]["value"]


def test_absent_counter_leaves_it_out(tiny_root, monkeypatch):
    """A program whose devstats counts no refinement: the metric is left
    out of the line and the others still report."""
    from daala_tpu_torch.utils import devstats
    real = devstats.snapshot

    def older():
        s = real()
        s["counts"] = {k: v for k, v in s["counts"].items()
                       if not k.startswith("me_refine_")}
        return s

    monkeypatch.setattr(devstats, "snapshot", older)
    got = _traced(tiny_root, "tiny-natural")
    assert NAME not in got
    assert "motion_search_ms_per_frame" in got
