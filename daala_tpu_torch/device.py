"""Device resolution.  The port's entry points (codec.encoder.Encoder,
codec.decoder.Decoder, parallel.mesh) run on the card unless the caller
asks for the CPU; the device functions below them take the device their
caller resolved.  Nothing falls back to the CPU behind the caller's
back."""

from __future__ import annotations

import torch


def resolve(device):
    """The torch.device for `device` (a str or torch.device).

    A CUDA device raises when no card is present: it never silently
    becomes the CPU."""
    if device is None:
        raise ValueError("daala_tpu_torch needs an explicit device "
                         "('cpu' or 'cuda[:N]')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %r requested but torch sees no "
                               "CUDA device" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError("device %r: only %d CUDA device(s)"
                               % (str(device), torch.cuda.device_count()))
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r" % str(device))
    return dev
