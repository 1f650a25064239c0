"""A cell end to end at 64x64 on the CPU, with the port's plain kernel
versions: set-up, window, trace, the check and the result's line."""

import json
import os
import subprocess
import sys
import time

import pytest

from codecbench import run as R

SEED = 2 ** 33 + 17  # seeds may be wider than 32 signed bits
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# The numbers each kind of cell compares, all with limit 0: the
# existing cells' as they were before the check's stages became files.
CHECK_KEYS = {
    "lean": {"sad_fields_off", "coeffs_off", "pvq_rows_off", "recon_off",
             "stages_missing"},
    "sweep": {"sad_fields_off", "coeffs_off", "pvq_rows_off",
              "sweep_cells_off", "recon_off", "stages_missing"},
    "play": {"planes_off", "stages_missing"},
    "analysis": {"sad_fields_off", "coeffs_off", "rdo_pyramid_off",
                 "dering_cands_off", "recon_off", "stages_missing"}}
KIND = {"tiny-translation": "lean", "tiny-natural": "lean",
        "tiny-play": "play", "tiny-sweep": "sweep",
        "tiny-analysis": "analysis"}


@pytest.mark.parametrize("workload,trace", [
    ("tiny-translation", 0), ("tiny-translation", 1), ("tiny-play", 0),
    ("tiny-play", 1), ("tiny-sweep", 1), ("tiny-analysis", 0),
    ("tiny-analysis", 1)])
def test_cell_runs_correct(tiny_root, workload, trace):
    result, checked = R.run_cell(workload, SEED, 0.5, trace, root=tiny_root,
                                 device="cpu",
                                 t_start=time.perf_counter())
    assert result["correct"], checked
    assert all(v == 0 for v, _ in checked.values())
    assert set(checked) == CHECK_KEYS[KIND[workload]]
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


@pytest.mark.parametrize("workload,kind", [
    ("lean1080-translation", "lean"), ("sweep1080-natural", "sweep"),
    ("lean1080-play", "play"),
    ("analysis1080-translation", "analysis")])
def test_cells_check_keys(workload, kind):
    """Each real cell compares its kind's numbers, every limit 0: the
    cells that were there before the stages became files compare what
    they compared then."""
    from codecbench import check as C
    config, mix = R.resolve_cell(REPO, workload)[2:]
    keys = dict(C.LIMITS)
    if mix["mode"] == "encode":
        keys = C.limits(C.load_stages(REPO, config))
        keys.pop("planes_off")
    else:
        keys.pop("recon_off")
    assert set(keys) == CHECK_KEYS[kind]
    assert set(keys.values()) == {0}


def test_info_and_attributes_reach_the_codec():
    """A configuration's `info` (fields of headers.Info) reaches the
    Encoder and the Decoder, its `attributes` the Encoder, and a clip
    made under them decodes to the encoder's reconstruction."""
    import torch
    from codecbench import source as S
    from codecbench import window as W
    with open(os.path.join(REPO, "codecbench", "configs",
                           "analysis_1080p.json")) as f:
        cfg = json.load(f)
    cfg.update(width=64, height=64,
               info={"timebase_numerator": 25, "pixel_aspect_numerator": 1,
                     "pixel_aspect_denominator": 1,
                     "plane_dec": [[0, 0], [1, 1], [1, 1]]},
               attributes={"b_frames": 1, "mv_res_min": 1})
    dev = torch.device("cpu")
    enc = W.new_encoder(cfg, dev)
    dec = W.new_decoder(cfg, dev)
    for codec in (enc, dec):
        assert codec.info.timebase_numerator == 25
        assert codec.info.pixel_aspect_numerator == 1
        assert codec.info.plane_dec == ((0, 0), (1, 1), (1, 1))
        assert (codec.info.pic_width, codec.info.pic_height) == (64, 64)
    assert (enc.b_frames, enc.mv_res_min) == (1, 1)
    clip = S.make_clip("translation", 64, 64, 3, SEED)
    packets = [p for fr in clip for p in enc.encode_frame(fr)]
    packets += enc.flush()
    got = [out for p in packets for out in dec.decode_packet(p)]
    assert len(got) == len(clip)
    for frame, src in zip(got, clip):
        assert W.luma_psnr(frame[0], src[0]) > 25


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


def test_texture_seed_fixes_the_textures():
    """A mix's texture_seed: every seed gets the textures of the clip of
    that seed and grain of its own; without it the clip is unchanged."""
    import numpy as np
    from codecbench import source as S
    bare = S.natural_clip(64, 64, 3, 7, grain=0.0)
    for seed in (SEED, SEED + 1):
        fixed = S.natural_clip(64, 64, 3, seed, grain=0.0, texture_seed=7)
        assert all((x == y).all() for fa, fb in zip(bare, fixed)
                   for x, y in zip(fa, fb))
    a = S.make_clip("natural", 64, 64, 3, SEED, texture_seed=7)
    b = S.make_clip("natural", 64, 64, 3, SEED + 1, texture_seed=7)
    assert any((x != y).any() for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert all(np.abs(x.astype(int) - y.astype(int)).mean() < 8
               for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    plain = S.make_clip("natural", 64, 64, 3, SEED)
    assert all((x == y).all() for fa, fb in zip(
        plain, S.natural_clip(64, 64, 3, SEED)) for x, y in zip(fa, fb))


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
