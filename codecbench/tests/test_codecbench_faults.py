"""The check against faults planted under a run: an answer altered
where a device layer produces it makes `correct` come out false, and a
layer that never runs is missed.  The look for a card is skipped
(device "cpu"); the rest of the run is the benchmark's own."""

import time

import numpy as np
import pytest
import torch

from codecbench import run as R

SEED = 2 ** 32 + 3


def _run(root, workload):
    return R.run_cell(workload, SEED, 0.3, 0, root=root, device="cpu",
                      t_start=time.perf_counter())


def _alter_sad(mod):
    orig = mod.fullpel_sad_fields

    def f(*a, **k):
        out = orig(*a, **k)
        out[0][0, 0, 0] += 1
        return out
    return "fullpel_sad_fields", f


def _alter_coeff(mod):
    orig = mod.analyze_inter

    def f(*a, **k):
        d, md, finish = orig(*a, **k)
        t = d[0].tiles[0].data
        t.view(-1)[7] += 1
        return d, md, finish
    return "analyze_inter", f


def _alter_pulse(mod):
    orig = mod.search_frame

    def f(*a, **k):
        finish = orig(*a, **k)

        def altered():
            table = finish()
            r = table.groups[0]["bands"][0]
            r["k"] = r["k"] + 1
            return table
        return altered
    return "search_frame", f


def _alter_leaf_cells(mod):
    orig = mod.leaf_cells_batch

    def f(*a, **k):
        out = orig(*a, **k)
        out[0, 0, 0] += 1
        return out
    return "leaf_cells_batch", f


def _alter_synthesis(mod):
    orig = mod.synthesize_frame

    def f(*a, **k):
        out = orig(*a, **k)
        out[0][5, 5] += 64
        return out
    return "synthesize_frame", f

def _alter_pyramid(mod):
    orig = mod.analyze_rdo_pyramid

    def f(*a, **k):
        d, md, merged = orig(*a, **k)
        d[2][3, 5] += 1
        return d, md, merged
    return "analyze_rdo_pyramid", f


def _alter_dering_cand(mod):
    orig = mod.dering_candidates_device

    def f(*a, **k):
        cands, dirs = orig(*a, **k)
        cands[0, 4, 9, 9] += 1
        return cands, dirs
    return "dering_candidates_device", f


@pytest.mark.parametrize("workload,module,fault,number", [
    ("tiny-translation", "mefield", _alter_sad, "sad_fields_off"),
    ("tiny-translation", "keyframe", _alter_coeff, "coeffs_off"),
    ("tiny-translation", "pvqsearch", _alter_pulse, "pvq_rows_off"),
    ("tiny-sweep", "mesweep", _alter_leaf_cells, "sweep_cells_off"),
    ("tiny-play", "synthesis", _alter_synthesis, "planes_off"),
    ("tiny-analysis", "keyframe", _alter_pyramid, "rdo_pyramid_off"),
    ("tiny-analysis", "restore", _alter_dering_cand, "dering_cands_off"),
])
def test_altered_answer_fails(tiny_root, monkeypatch, workload, module,
                              fault, number):
    import importlib
    mod = importlib.import_module("daala_tpu_torch.models." + module)
    name, f = fault(mod)
    monkeypatch.setattr(mod, name, f)
    result, checked = _run(tiny_root, workload)
    assert not result["correct"]
    assert checked[number][0] > checked[number][1], checked


def _alter_base_qm(monkeypatch):
    from daala_tpu_torch.codec import state
    orig = state.P.init_qm
    monkeypatch.setattr(state.P, "init_qm",
                        lambda base: orig(np.asarray(base) + 4))


def _alter_interp_qm(monkeypatch):
    from daala_tpu_torch.codec import encoder
    orig = encoder.interp_qm
    monkeypatch.setattr(encoder, "interp_qm", lambda q, m, pli: [
        min(255, v * 3 // 2) for v in orig(q, m, pli)])


@pytest.mark.parametrize("fault", [_alter_base_qm, _alter_interp_qm])
def test_altered_qm_fails(tiny_root, monkeypatch, fault):
    """A quantisation matrix that the port derives wrongly reaches its
    search and its stream alike, so its own decoder agrees; the
    reference, which works the matrices out from the configuration,
    does not."""
    fault(monkeypatch)
    result, checked = _run(tiny_root, "tiny-translation")
    assert not result["correct"]
    assert checked["pvq_rows_off"][0] > 0, checked
    assert checked["recon_off"][0] == 0, checked


def test_unseen_layer_fails(tiny_root, monkeypatch):
    """A sampled frame whose search the check never sees (here: the port
    reached through another name) counts as missing, not as equal."""
    from codecbench import check as C
    monkeypatch.setattr(C.Capture, "install_encode",
                        lambda self: None)
    result, checked = _run(tiny_root, "tiny-translation")
    mix = R.resolve_cell(tiny_root, "tiny-translation")[3]
    assert not result["correct"]
    assert checked["stages_missing"][0] == mix["checked_frames"]


def test_control_reads_above_every_limit_it_covers(tiny_root):
    """The reference one precision down (int16 lifting and sums, the PVQ
    search on bfloat16 planes, the dering directions' costs in int16) in
    the port's place fails its numbers."""
    from codecbench import check as C
    from codecbench import window as W
    for workload, numbers in (
            ("tiny-translation", ("sad_fields_off", "coeffs_off",
                                  "pvq_rows_off")),
            ("tiny-sweep", ("sweep_cells_off",)),
            ("tiny-play", ("planes_off",)),
            ("tiny-analysis", ("rdo_pyramid_off", "dering_cands_off"))):
        bench, cell, config, mix = R.resolve_cell(tiny_root, workload)
        dev = torch.device("cpu")
        run = W.run_window(config, mix, SEED, 0.3, False, dev,
                           time.perf_counter(), tiny_root)
        sound = C.readings(run, config, dev)
        low = C.readings(run, config, dev, control=True)
        lim = C.limits(run.capture.stages)
        for k in numbers:
            assert sound[k] <= lim[k] < low[k], (k, sound, low)
    assert np.isfinite(sum(low.values()))
