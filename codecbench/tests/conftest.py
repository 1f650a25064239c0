"""Fixtures of the benchmark's CPU tests: a checkout root under a
temporary directory whose BENCHMARK.json adds 64x64 cells of the real
configurations and mixes (the `tiny_root` fixture)."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


def make_root(path, size=64):
    """A root at `path` with the benchmark's configurations, mixes,
    metric readers, kernel counts and check stages, and a BENCHMARK.json
    holding the real cells plus `tiny-*` cells of size x size copies of
    the configurations."""
    for kind in ("configs", "mixes", "metrics", "kernels", "stages"):
        shutil.copytree(os.path.join(REPO, "codecbench", kind),
                        os.path.join(path, "codecbench", kind))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, real in (("tiny", "lean_1080p"), ("tinysweep", "sweep_1080p"),
                       ("tinyanalysis", "analysis_1080p")):
        with open(os.path.join(REPO, "codecbench", "configs",
                               real + ".json")) as f:
            cfg = json.load(f)
        cfg["width"] = cfg["height"] = size
        with open(os.path.join(path, "codecbench", "configs",
                               name + ".json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": "codecbench/configs/%s.json" % name,
                                 "reduced": ["width", "height"],
                                 "why": "test"})
    like = {"tiny-translation": ("tiny", "translation",
                                 "lean1080-translation"),
            "tiny-natural": ("tiny", "natural", "lean1080-translation"),
            "tiny-play": ("tiny", "play", "lean1080-play"),
            "tiny-sweep": ("tinysweep", "natural", "sweep1080-natural"),
            "tiny-analysis": ("tinyanalysis", "translation",
                              "analysis1080-translation")}
    for name, (cfg, mix, real) in like.items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
