"""The benchmark's source clips, made from the run's seed.

Frozen copies of the clip makers of the port's utils/profile.py (the
clips of bench.py's 1080p encode), with every random draw taken from
the seed: the translation clip's noise and the phases of its patterns,
the natural clip's textures and grain.  The seed changes what the
pixels hold, never the shapes of the work: the sizes, the motion and
the textures' spectra are the same for every seed.  A mix may fix the
natural clip's textures with `texture_seed`: the seed then draws only
the grain, so that every seed asks the encoder for the same work (with
the textures drawn from the seed, a 1080p window's rate moved by up to
8% from seed to seed where one seed's runs agreed within 5%).

A mix plays its clip forward and then back (frames 0 .. L-1 .. 1, 0,
...), so that the motion stays continuous however many frames a window
takes.
"""

from __future__ import annotations

import numpy as np


def translation_clip(w, h, nframes, seed):
    """A smooth pattern under global translation (2, 3 pixels a frame)
    plus fixed noise, 4:2:0 8-bit; a list of [y, cb, cr]."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2.0 * np.pi, 5)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 50 * np.sin(xx / 17.0 + ph[0])
            + 35 * np.cos(yy / 23.0 + ph[1])
            + 20 * np.sin((xx + yy) / 9.0 + ph[2]))
    noise = rng.normal(0, 5, (h, w))
    frames = []
    for t in range(nframes):
        y = (np.roll(base, (2 * t, 3 * t), (0, 1)) + noise) \
            .clip(0, 255).astype(np.uint8)
        cb = (128 + 25 * np.sin((xx[::2, ::2] + 5 * t) / 19.0 + ph[3])) \
            .clip(0, 255).astype(np.uint8)
        cr = (128 + 25 * np.cos((yy[::2, ::2] + 4 * t) / 21.0 + ph[4])) \
            .clip(0, 255).astype(np.uint8)
        frames.append([y, cb, cr])
    return frames


def _lowpass(a, k):
    """Separable box low-pass of width k (zero beyond the edges)."""
    kernel = np.ones(k) / k
    a = np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 0, a)
    return np.apply_along_axis(lambda r: np.convolve(r, kernel, "same"), 1,
                               a)


def _octave_noise(shape, rng, octaves=((3, 60), (9, 45), (27, 35))):
    """Filtered noise octaves: the 1/f-like spectrum of natural texture."""
    acc = np.zeros(shape)
    for k, sigma in octaves:
        acc += _lowpass(rng.normal(0, sigma, shape), k)
    return acc


def natural_clip(w, h, nframes, seed, grain=3.0, texture_seed=None):
    """A natural-statistics clip, 4:2:0 8-bit: a textured background with
    a nearer layer, a slow non-integer pan, a foreground occluder with
    its own motion, luminance flicker and fresh film grain each frame.
    The textures come from `texture_seed` where it is given, else from
    the seed; the grain always from the seed."""
    rng = np.random.default_rng(seed)
    tseed = seed if texture_seed is None else texture_seed
    tex = rng if texture_seed is None else np.random.default_rng(tseed)
    pad = 96
    wp, hp = w + 2 * pad, h + 2 * pad
    yy, xx = np.mgrid[0:hp, 0:wp]
    bg = (120 + 40 * np.sin(xx / 171.0) + 25 * np.cos(yy / 133.0)
          + _octave_noise((hp, wp), tex))
    fgtex = 140 + _octave_noise((hp, wp), np.random.default_rng(tseed + 1),
                                octaves=((3, 80), (15, 50)))
    oy, ox = np.mgrid[0:h // 2, 0:w // 2]
    blob = (((oy - h / 4.0) / (h / 4.0)) ** 2
            + ((ox - w / 4.0) / (w / 4.0)) ** 2) < 0.8
    frames = []
    for t in range(nframes):
        bx = pad + int(round(1.7 * t))
        by = pad + int(round(0.9 * t))
        fx = pad + int(round(3.4 * t))
        fy = pad + int(round(1.2 * t))
        img = bg[by:by + h, bx:bx + w] * (1.0 + 0.02 * np.sin(t / 2.3))
        py = (h // 4 + int(round(2.6 * t))) % (h - h // 2)
        px = (w // 6 + int(round(4.1 * t))) % (w - w // 2)
        patch = fgtex[fy + py:fy + py + h // 2, fx + px:fx + px + w // 2]
        region = img[py:py + h // 2, px:px + w // 2]
        img[py:py + h // 2, px:px + w // 2] = np.where(blob, patch, region)
        img = img + rng.normal(0, grain, (h, w))
        sub = img[::2, ::2]
        frames.append([np.clip(img, 0, 255).astype(np.uint8),
                       np.clip(128 + 0.25 * (sub - 128), 0, 255)
                       .astype(np.uint8),
                       np.clip(128 - 0.18 * (sub - 128), 0, 255)
                       .astype(np.uint8)])
    return frames


CONTENTS = {"translation": translation_clip, "natural": natural_clip}


def make_clip(content, w, h, nframes, seed, texture_seed=None):
    """The mix's clip: `content` names one of CONTENTS; `texture_seed`,
    the mix's key of that name, is passed on where it is given."""
    if content not in CONTENTS:
        raise ValueError("unknown content %r (have %s)"
                         % (content, ", ".join(sorted(CONTENTS))))
    opts = {} if texture_seed is None else {"texture_seed": texture_seed}
    return CONTENTS[content](w, h, nframes, seed, **opts)


def palindrome(nframes, i):
    """The clip frame shown as the window's i-th frame: forward, then
    back, without repeating either end."""
    if nframes == 1:
        return 0
    period = 2 * (nframes - 1)
    k = i % period
    return k if k < nframes else period - k
