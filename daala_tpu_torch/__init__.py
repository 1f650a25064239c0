"""daala_tpu_torch: the PyTorch / CUDA port of daala_tpu.

The JAX package `daala_tpu` stays the reference.  This package mirrors
its layout (codec/, entropy/, native/, ops/, models/, utils/), imports
`torch`, never `jax`, and imports nothing of daala_tpu.  Its host codec
(codec/, entropy/, native/, the numpy ops/, utils/logging.py and
utils/dump.py) is a copy of daala_tpu's jax-free one, equal to it apart
from the import lines and the definitions where the port's device tier
(models/, ops/cuda/) takes the place of the JAX one;
tests/test_torch_copies.py holds every copy to its original.  Every
function that touches tensors takes an explicit `device`; there is no
global device state.
"""
