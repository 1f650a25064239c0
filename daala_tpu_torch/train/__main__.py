"""Offline training / table-generation CLI of the port.

Counterpart of the reference's tools/{gen_laplace_tables,gen_cdf,
compute_basis,cos_search,vq_train,trans}.c and tools/gen_zigzag*.m,
backed by the `daala_tpu_torch.train` modules.  The subcommands that
touch a device (vq, zigzag, gain --search) run on the CUDA card unless
given --device cpu.

Usage:
  python -m daala_tpu_torch.train laplace [n] [shift]
  python -m daala_tpu_torch.train cdf [n] [shift]
  python -m daala_tpu_torch.train basis <ln> <coeff|mag|coeff420|mag420>
  python -m daala_tpu_torch.train cos-search [--radius R]
  python -m daala_tpu_torch.train vq <dims> <max_vectors> <bits>
      [--device D] [< vectors.txt]
  python -m daala_tpu_torch.train zigzag <n> [--clip clip.y4m] [--device D]
  python -m daala_tpu_torch.train gain [--filt 4|8] [--rho R] [--search]
      [--device D]
"""

import sys


def main(args=None):
    args = sys.argv[1:] if args is None else list(args)
    if not args:
        print(__doc__)
        return 1
    cmd, argv = args[0], args[1:]
    if cmd in ("laplace", "cdf"):
        from daala_tpu_torch.train.laplace import main as m
        return m([cmd] + argv)
    if cmd == "basis":
        from daala_tpu_torch.train.basis import main as m
        return m(argv)
    if cmd == "cos-search":
        from daala_tpu_torch.train.cos_search import main as m
        return m(argv)
    if cmd == "vq":
        from daala_tpu_torch.train.vq import main as m
        return m(argv)
    if cmd == "zigzag":
        from daala_tpu_torch.train.zigzag import main as m
        return m(argv)
    if cmd == "gain":
        from daala_tpu_torch.train.gain import main as m
        return m(argv)
    print("unknown subcommand %r" % cmd)
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
