"""The port's parallel encodes (daala_tpu_torch/parallel/mesh.py,
parallel/dryrun.py) against the JAX package's (daala_tpu/parallel/
mesh.py, __graft_entry__.py), on the CPU: the mesh, JAX's default dp
and the refusals, batch_encode_step against JAX's on a 2-device mesh
(with an sse that wraps int32) and on a 2 x 2 mesh of CPU tiles, the
batched multi-clip encode in both schedules against serial encodes,
on rows of one column and of two (each clip's planes in tiles), the
segment-parallel encode, the dry run with its spatially sharded leg;
and the port's devstats under threads and its copy of the natural clip.

Packets and planes are compared byte for byte, the tolerance is zero.
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import content
from daala_tpu.codec import headers as JH
from daala_tpu.codec.encoder import Encoder as HostEncoder
from daala_tpu.parallel import mesh as JPM
from daala_tpu_torch.codec import headers
from daala_tpu_torch.codec.decoder import Decoder
from daala_tpu_torch.codec.encoder import Encoder
from daala_tpu_torch.parallel import dryrun, mesh as PM
from daala_tpu_torch.utils import devstats, profile
import torch_threads

torch_threads.share_cores()

CPU2 = ["cpu", "cpu"]
CPU4 = ["cpu"] * 4


# -- the mesh ----------------------------------------------------------------

def _jax_default_shape(n):
    dp = 2 if n % 2 == 0 else 1
    return (dp, n // dp)


def test_make_mesh_takes_every_card_or_raises():
    """make_mesh() is the cards in JAX's default (dp, sp); without one
    it raises."""
    if torch.cuda.is_available():
        m = PM.make_mesh()
        assert m.shape == _jax_default_shape(torch.cuda.device_count())
        assert all(d.type == "cuda" for d in m.ravel())
    else:
        with pytest.raises(RuntimeError):
            PM.make_mesh()
    m = PM.make_mesh(devices=CPU2)
    assert m.shape == (2, 1)
    assert [d.type for d in m.ravel()] == ["cpu", "cpu"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_default_dp_is_jax(n):
    """make_mesh(devices=["cpu"] * n) has JAX's make_mesh(n)'s shape
    ((2, 2) for 4), a device named more than once fills every place, and
    dp may be asked for."""
    m = PM.make_mesh(devices=["cpu"] * n)
    jm = JPM.make_mesh(n)
    assert m.shape == jm.devices.shape == _jax_default_shape(n)
    assert all(d == torch.device("cpu") for d in m.ravel())
    assert PM.make_mesh(devices=["cpu"] * n, dp=1).shape == (1, n)
    if n >= 2:
        assert PM.make_mesh(2, devices=["cpu"] * n).shape == (2, 1)


def test_make_mesh_refusals():
    with pytest.raises(RuntimeError):
        PM.make_mesh(3, devices=CPU2)
    with pytest.raises(ValueError):
        PM.make_mesh(devices=["cpu"] * 3, dp=2)


def test_shard_batch():
    """The batch over dp and columns over sp, cut on superblocks, with
    the forward lapped filter's halo of 2 beside each column cut."""
    frames = np.random.default_rng(0).integers(0, 256, (4, 16, 200),
                                               np.uint8)
    sp = PM.shard_batch(frames, PM.make_mesh(devices=CPU2))
    assert [tuple(t.data.shape) for t in sp.tiles] == [(2, 16, 200)] * 2
    np.testing.assert_array_equal(sp.gather(), frames)
    sp = PM.shard_batch(frames, PM.make_mesh(devices=CPU4))
    assert [(t.start, t.stop) for t in sp.tiles] == [
        ((0, 0, 0), (2, 16, 128)), ((0, 0, 128), (2, 16, 200)),
        ((2, 0, 0), (4, 16, 128)), ((2, 0, 128), (4, 16, 200))]
    assert [tuple(t.data.shape) for t in sp.tiles] == [(2, 16, 130),
                                                       (2, 16, 74)] * 2
    np.testing.assert_array_equal(sp.tiles[1].data.numpy(),
                                  frames[:2, :, 126:])
    np.testing.assert_array_equal(sp.gather(), frames)
    with pytest.raises(ValueError):
        PM.shard_batch(frames[:3], PM.make_mesh(devices=CPU2))


# -- batch_encode_step against JAX's ----------------------------------------

def _jax_batch_step(frames, **kw):
    jm = JPM.make_mesh(2)
    with jm:
        rec, sse, nz = JPM.batch_encode_step(JPM.shard_batch(frames, jm),
                                             **kw)
        return np.asarray(rec), int(sse), int(nz)


def test_batch_encode_step_matches_jax():
    """A (4, 128, 128) batch at JAX's defaults (bs = 1, quant = 3840),
    sharded over 2 rows, and in one shard; each frame's encode_step."""
    frames = np.random.default_rng(0).integers(0, 256, (4, 128, 128),
                                               np.uint8)
    jrec, jsse, jnz = _jax_batch_step(frames)
    m = PM.make_mesh(devices=CPU2)
    rec, sse, nz = PM.batch_encode_step(PM.shard_batch(frames, m))
    np.testing.assert_array_equal(rec.gather(), jrec)
    assert (sse, nz) == (jsse, jnz)
    rec1, sse1, nz1 = PM.batch_encode_step(torch.from_numpy(frames))
    np.testing.assert_array_equal(rec1.numpy(), jrec)
    assert (sse1, nz1) == (jsse, jnz)
    from daala_tpu_torch.models.analysis import encode_step
    per = [encode_step(torch.from_numpy(f)) for f in frames]
    assert sum(int(p[1]) for p in per) == sse
    assert sum(int(p[2]) for p in per) == nz


def test_batch_encode_step_sse_wraps_as_jax():
    """0/255 checkerboards at a quantizer that zeroes every coefficient:
    every pixel reconstructs as 128, the squared error passes 2^31, and
    sse is JAX's wrapped int32."""
    yy, xx = np.mgrid[0:256, 0:256]
    board = np.where((yy + xx) % 2 == 0, 0, 255).astype(np.uint8)
    frames = np.stack([board, 255 - board, board, 255 - board])
    quant = 1 << 30
    true_sse = int(((frames.astype(np.int64) - 128) ** 2).sum())
    assert true_sse > (1 << 31)
    jrec, jsse, jnz = _jax_batch_step(frames, quant=quant)
    m = PM.make_mesh(devices=CPU2)
    rec, sse, nz = PM.batch_encode_step(PM.shard_batch(frames, m),
                                        quant=quant)
    np.testing.assert_array_equal(rec.gather(), jrec)
    assert (jrec == 128).all() and jnz == nz == 0
    assert sse == jsse == (true_sse + (1 << 31)) % (1 << 32) - (1 << 31)


@pytest.mark.parametrize("shape,bs", [((4, 128, 192), 1),
                                      ((2, 192, 320), 2)])
def test_batch_encode_step_in_tiles_matches_jax(shape, bs):
    """The batch over the 2 rows and its columns over the 2 columns of
    make_mesh(devices=["cpu"] * 4): 3 superblock columns cut 2 + 1 (5:
    3 + 2), each frame's lapped filters across the cut from the uploaded
    halo and the exchanged one; rec, sse and nz equal JAX's batch step
    and the port's in one piece."""
    frames = np.random.default_rng(bs).integers(0, 256, shape, np.uint8)
    jrec, jsse, jnz = _jax_batch_step(frames, bs=bs)
    devstats.reset()
    sp = PM.shard_batch(frames, PM.make_mesh(devices=CPU4))
    assert len(sp.tiles) == 4
    rec, sse, nz = PM.batch_encode_step(sp, bs=bs)
    np.testing.assert_array_equal(rec.gather(), jrec)
    assert (sse, nz) == (jsse, jnz)
    # Each frame's inverse filter took 2 columns from its neighbour
    # tile, each way, over its rows (int32).
    assert devstats.snapshot()["counts"]["halo_bytes"] == \
        shape[0] * 2 * 2 * shape[1] * 4


# -- encode_clips_batched ----------------------------------------------------

W, H = 256, 192


@pytest.fixture(scope="module")
def clips():
    return [content.make_clip(W, H, 2, seed=s) for s in (1, 2)]


@pytest.fixture(scope="module")
def serial(clips):
    """Each clip through the port's Encoder on the CPU and JAX's host
    Encoder, one after the other (complexity 7, quant 18)."""
    out = {"port": [], "host": []}
    for frames in clips:
        for name, enc in (
                ("port", Encoder(headers.Info(pic_width=W, pic_height=H),
                                 quant=18, complexity=7, device="cpu")),
                ("host", HostEncoder(JH.Info(pic_width=W, pic_height=H),
                                     quant=18, complexity=7))):
            pk = [bytes(p) for fr in frames for p in enc.encode_frame(fr)]
            out[name].append(pk + [bytes(p) for p in enc.flush()])
    return out


@pytest.mark.parametrize("threads", [False, True],
                         ids=["round_robin", "threads"])
def test_encode_clips_batched_matches_serial(clips, serial, threads):
    """tests/test_parallel.py's case: 2 clips on 2 CPU rows, byte-identical
    to the port's serial encodes and to JAX's host encoder (which
    test_parallel.py holds to JAX's encode_clips_batched)."""
    devstats.reset()
    outs = PM.encode_clips_batched(clips, dict(pic_width=W, pic_height=H),
                                   PM.make_mesh(devices=CPU2), quant=18,
                                   complexity=7, threads=threads)
    for ci in range(len(clips)):
        got = [bytes(p) for p in outs[ci]]
        assert got == serial["port"][ci]
        assert got == serial["host"][ci]
    assert devstats.snapshot()["dispatches"] > 0


@pytest.mark.slow
def test_encode_clips_batched_matches_jax_batched(clips, serial):
    """Against JAX's own encode_clips_batched on PM.make_mesh(dp=2) in
    both schedules (slow: JAX compiles its device tier, about a minute
    cold)."""
    for threads in (False, True):
        outs = JPM.encode_clips_batched(
            clips, dict(pic_width=W, pic_height=H), JPM.make_mesh(dp=2),
            quant=18, complexity=7, threads=threads)
        for ci in range(len(clips)):
            assert [bytes(p) for p in outs[ci]] == serial["port"][ci]


@pytest.mark.parametrize("threads", [False, True],
                         ids=["round_robin", "threads"])
def test_encode_clips_batched_in_tiles_matches_serial(clips, serial,
                                                     threads):
    """The same 2 clips on make_mesh(devices=["cpu"] * 4), a (2, 2)
    mesh: each clip's planes cut over its row's 2 columns (the 256-wide
    frame in 2 + 2 superblock columns), byte-identical to the serial
    encodes; the tiles exchanged no halo (an encoder's analysis takes
    its halos with the upload)."""
    devstats.reset()
    outs = PM.encode_clips_batched(clips, dict(pic_width=W, pic_height=H),
                                   PM.make_mesh(devices=CPU4), quant=18,
                                   complexity=7, threads=threads)
    for ci in range(len(clips)):
        got = [bytes(p) for p in outs[ci]]
        assert got == serial["port"][ci]
        assert got == serial["host"][ci]
    assert "halo_bytes" not in devstats.snapshot()["counts"]


class _Boom(Exception):
    pass


class _BadFrame(list):
    def __getitem__(self, i):
        raise _Boom("bad frame")


def test_thread_error_is_reraised(clips):
    """An error in one clip's thread fails the call; the other clip's
    thread runs to its end."""
    bad = [clips[0], [_BadFrame(clips[1][0])]]
    with pytest.raises(_Boom):
        PM.encode_clips_batched(bad, dict(pic_width=W, pic_height=H),
                                PM.make_mesh(devices=CPU2), quant=18,
                                complexity=7, threads=True)
    with pytest.raises(ValueError):
        PM.encode_clips_batched(clips, dict(pic_width=W, pic_height=H),
                                PM.make_mesh(devices=CPU2),
                                enc_kwargs={"device": "cpu"})


# -- encode_clip_parallel ----------------------------------------------------

def test_segment_parallel_encode_decodes():
    """tests/test_parallel.py's clip in 2 spawned workers on the CPU: 20
    frames decoded, PSNR > 25, and the packets of serial encodes of the
    two segments, each by a fresh Encoder.  (One encoder over a longer
    clip would differ from frame 20 on: its golden frames, every 10th
    keyframe or P frame it codes, run across the keyframe at 16.)"""
    w = h = 64
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.clip(128 + 50 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0)
                   + rng.normal(size=(h, w)) * 8, 0, 255).astype(np.uint8)
    cb = np.full((h // 2, w // 2), 119, np.uint8)
    cr = np.full((h // 2, w // 2), 131, np.uint8)
    frames = [[np.roll(base, i, axis=1), cb, cr] for i in range(20)]
    info_kwargs = dict(pic_width=w, pic_height=h, nplanes=3,
                       plane_dec=((0, 0), (1, 1), (1, 1)),
                       keyframe_rate=16)
    kw = dict(quant=20, complexity=1, device="cpu")
    pkts = PM.encode_clip_parallel(frames, info_kwargs, kw, segment_len=16,
                                   workers=2)
    assert len(pkts) == 20
    info = headers.Info(**info_kwargs)
    want = []
    for seg in (frames[:16], frames[16:]):
        enc = Encoder(info, **kw)
        want += [bytes(p) for fr in seg for p in enc.encode_frame(fr)]
        want += [bytes(p) for p in enc.flush()]
    assert [bytes(p) for p in pkts] == want
    dec = Decoder(info, device="cpu")
    out = [o for p in pkts for o in dec.decode_packet(p)]
    assert len(out) == 20
    ps = 10 * np.log10(255 ** 2 / max(1e-9, np.mean(
        (out[-1][0].astype(float) - frames[-1][0].astype(float)) ** 2)))
    assert ps > 25


# -- the dry run -------------------------------------------------------------

def test_entry_matches_jax():
    """dryrun.entry on the CPU: JAX's __graft_entry__.entry's plane."""
    import __graft_entry__ as GE
    fn, args = dryrun.entry("cpu")
    total, d = fn(*args)
    jfn, jargs = GE.entry()
    jtotal, jd = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert int(total) == int(jtotal)


@functools.lru_cache(maxsize=None)
def _host_kf_p():
    """JAX's host encoder's keyframe + P-frame packets of the dry run's
    frames, computed once for both dry-run tests."""
    enc = HostEncoder(JH.Info(pic_width=256, pic_height=192), quant=18,
                      complexity=7)
    enc.keyframe_rate = 64
    return [bytes(enc.encode_frame(fr)[0])
            for fr in (dryrun._test_frame(256, 192, seed=1),
                       dryrun._test_frame(256, 192, seed=2))]


def test_dryrun_multichip_on_cpu_rows():
    """dryrun_multichip(2, device="cpu"); its keyframe + P-frame packets
    are JAX's host encoder's."""
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["kf_p"] == _host_kf_p()
    assert len(out["clips"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dryrun.dryrun_multichip(1)


def test_dryrun_multichip_sharded_on_cpu():
    """dryrun_multichip(4, device="cpu"): a (2, 2) mesh; the spatially
    sharded leg's keyframe + P-frame packets are JAX's host encoder's,
    and the batched clips ran over rows of 2 columns."""
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert out["kf_p"] == out["sharded"] == _host_kf_p()
    assert len(out["clips"]) == 2


# -- devstats under threads, the natural clip --------------------------------

def test_devstats_counts_exactly_under_threads():
    """8 threads x 10,000 launch / count / dispatch / span calls, with a
    short switch interval: no update is lost."""
    n_threads, n = 8, 10_000
    devstats.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                devstats.launch("k")
                devstats.count("c", 2)
                devstats.dispatch()
                with devstats.span("s"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = devstats.snapshot()
    assert snap["launches"] == {"k": n_threads * n}
    assert snap["counts"] == {"c": 2 * n_threads * n}
    assert snap["dispatches"] == n_threads * n
    assert snap["spans_s"]["s"] > 0


@pytest.mark.parametrize("kw", [dict(w=96, h=64, nframes=3, seed=3),
                                dict(w=64, h=48, nframes=2, seed=1,
                                     fourcc="444", grain=5.0)])
def test_natural_clip_is_the_original(kw):
    got = profile.make_natural_clip(**kw)
    want = content.make_natural_clip(**kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for pa, pb in zip(a, b):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)
