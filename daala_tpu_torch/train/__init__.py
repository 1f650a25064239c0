"""Training / table-generation subsystem.

The port's re-implementation of the reference's offline training and
codegen tools (reference: tools/gen_laplace_tables.c, tools/gen_cdf.c,
tools/compute_basis.c, tools/cos_search.c, tools/vq_train.c,
tools/trans_gain.c, tools/gen_zigzag*.m).  Where the reference ships
C/Matlab search programs, these modules provide the same *search
capability* as vectorized numpy/torch code: the shipped normative tables
in `daala_tpu_torch.ops._tables` are regenerable from first principles
(tests/test_torch_train.py holds them, and every search, to the JAX
package's), and the searches that touch a device (the zigzag statistics
through the lapped-transform kernels, the VQ codebook's k-means step,
the lapped-filter coding-gain search) run on a CUDA card unless the
caller passes device="cpu".  `python -m daala_tpu_torch.train` is the
command-line front end.
"""
