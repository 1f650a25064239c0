"""The port's command-line tools: the counterparts of the JAX package's
tools/encode.py (y4m -> Ogg/Daala) and tools/decode.py (Ogg/Daala ->
y4m), run as `python -m daala_tpu_torch.tools.encode` and `python -m
daala_tpu_torch.tools.decode`, on the card unless --device names the
CPU."""
