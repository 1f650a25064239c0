"""A cell end to end at 64x64 on the CPU, with the port's plain kernel
versions: set-up, window, trace, the check and the result's line."""

import json
import subprocess
import sys
import time

import pytest

from codecbench import run as R

SEED = 2 ** 33 + 17  # seeds may be wider than 32 signed bits


@pytest.mark.parametrize("workload,trace", [
    ("tiny-translation", 0), ("tiny-translation", 1), ("tiny-play", 0),
    ("tiny-play", 1), ("tiny-sweep", 1)])
def test_cell_runs_correct(tiny_root, workload, trace):
    result, checked = R.run_cell(workload, SEED, 0.5, trace, root=tiny_root,
                                 device="cpu",
                                 t_start=time.perf_counter())
    assert result["correct"], checked
    assert all(v == 0 for v, _ in checked.values())
    assert result["attempted"] >= 3 and result["failed"] == 0
    bench = json.load(open(tiny_root + "/BENCHMARK.json"))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in R.cell_metrics(bench, workload, kind)}
    got = set(result["metrics"])
    if trace:
        # The device's metrics need a card's trace; the spans do not.
        assert got and got <= want
        assert "breakdown" in result and "busy_s" in result["device"]
    else:
        assert got == want
        assert result["metrics"]["setup_s"]["value"] > 0
    for m in result["metrics"].values():
        assert m["value"] == m["value"] and m["value"] >= 0


def test_seed_decides_the_work(tiny_root):
    """The same seed gives the same stream; another seed other pixels of
    the same sizes."""
    from codecbench import source as S
    a = S.make_clip("natural", 64, 64, 4, SEED)
    b = S.make_clip("natural", 64, 64, 4, SEED)
    c = S.make_clip("natural", 64, 64, 4, SEED + 1)
    assert all((x == y).all() for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert any((x != y).any() for fa, fc in zip(a, c) for x, y in zip(fa, fc))
    assert [p.shape for p in a[0]] == [p.shape for p in c[0]]
    assert [S.palindrome(4, i) for i in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]


def test_leaked_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "daala_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "daala_tpu.fake", sys)
    assert "daala_tpu.fake" in R.leaked_modules()
    assert "daala_tpu_torch_like" not in R.leaked_modules()


def test_cli_refuses_without_a_card(tiny_root):
    """No card: exit 3 and no result on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "-m", "codecbench.run", "--workload",
                        "tiny-translation", "--seed", "1", "--seconds", "1"],
                       cwd=tiny_root, capture_output=True, text=True,
                       env={"PYTHONPATH": R.__file__.rsplit("/codecbench",
                                                            1)[0],
                            "PATH": "/usr/bin:/bin"}, timeout=300)
    assert p.returncode == 3, p.stderr
    assert p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny-translation", "tiny-sweep",
                                      "tiny-play"])
def test_cell_on_the_card(tiny_root, workload):
    """A traced 64x64 cell through the port's CUDA kernels: correct, and
    the trace saw the device work."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device")
    result, checked = R.run_cell(workload, SEED, 0.5, 1, root=tiny_root,
                                 t_start=time.perf_counter())
    assert result["correct"], checked
    dev = result["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] < dev["window_s"]
    assert result["breakdown"]["device_ops"]
