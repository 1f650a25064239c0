"""A configuration, a mix and a per-layer metric added as new files
only, and a cell of them run: no file of the benchmark is edited."""

import json
import os
import time

from codecbench import run as R


def test_new_config_mix_and_metric_are_files(tiny_root):
    cb = os.path.join(tiny_root, "codecbench")
    with open(os.path.join(cb, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(width=96, height=64, quant=40)
    with open(os.path.join(cb, "configs", "newcfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(cb, "mixes", "newmix.json"), "w") as f:
        json.dump({"mode": "encode", "content": "natural", "clip_frames": 5,
                   "warm_frames": 1, "quality_frames": 4,
                   "checked_within": 4, "checked_frames": 2,
                   "why": "test"}, f)
    with open(os.path.join(cb, "metrics", "frames_seen.py"), "w") as f:
        f.write('"""Frames in the window."""\n\n\n'
                'def read(run):\n    return float(run.frames)\n')
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "newcfg", "source": "test",
                             "file": "codecbench/configs/newcfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "newcfg",
                               "traffic": "newmix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "lean1080-translation" in m.get("workloads", ["new-cell"]):
            m.setdefault("workloads", []).append("new-cell")
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "encode_mpix_s",
                               "workloads": ["new-cell"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    for trace in (0, 1):
        result, checked = R.run_cell("new-cell", 5, 0.2, trace,
                                     root=tiny_root, device="cpu",
                                     t_start=time.perf_counter())
        assert result["correct"], checked
        if trace:
            assert result["metrics"]["frames_seen"]["value"] >= 4
        else:
            assert set(result["metrics"]) == {
                "encode_mpix_s", "bits_per_pixel", "psnr_y_db", "setup_s"}


STAGE = '''"""A test stage: the SAD fields' shapes against their definition."""


def _wrap(orig, slot):
    def f(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r=16, **kw):
        out = orig(cur, refs_padded, pad, vis, nvmvbs, nhmvbs, r, **kw)
        rec = slot()
        if rec is not None:
            rec["shapes"] = [tuple(o.shape) for o in out]
            rec["want"] = ((2 * r + 1) ** 2, nvmvbs // 8 + 1,
                           nhmvbs // 8 + 1)
        return out
    return f


ENTRIES = (("daala_tpu_torch.models.mefield", "fullpel_sad_fields", _wrap),)
INTER_ONLY = True
NUMBERS = {"sad_shapes_off": 0}


def compare(rec, frame):
    return {"sad_shapes_off": sum(s != rec["want"] for s in rec["shapes"])}
'''


def test_new_check_stage_is_files(tiny_root):
    """A check stage, a configuration that names it and a cell, added as
    new files and entries: the cell compares that stage's number beside
    the stages it names, and no other."""
    cb = os.path.join(tiny_root, "codecbench")
    with open(os.path.join(cb, "stages", "sad_shapes.py"), "w") as f:
        f.write(STAGE)
    with open(os.path.join(cb, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["checked_stages"] = ["front", "sad_shapes"]
    with open(os.path.join(cb, "configs", "stagecfg.json"), "w") as f:
        json.dump(cfg, f)
    bench_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "stagecfg", "source": "test",
                             "file": "codecbench/configs/stagecfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "stage-cell", "config": "stagecfg",
                               "traffic": "translation", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "lean1080-translation" in m.get("workloads", ["stage-cell"]):
            m.setdefault("workloads", []).append("stage-cell")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    result, checked = R.run_cell("stage-cell", 7, 0.2, 0, root=tiny_root,
                                 device="cpu", t_start=time.perf_counter())
    assert result["correct"], checked
    assert set(checked) == {"coeffs_off", "sad_shapes_off", "recon_off",
                            "stages_missing"}
    assert all(v == 0 and lim == 0 for v, lim in checked.values())
