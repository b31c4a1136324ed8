"""Hand-written Hopper kernels, each driven by the comprehensive tree.

Families: ``matmul_h100`` (paper Fig. 3/4; K1), ``flash_attention_h100``
(K2), ``ssd_scan_h100`` (K3), and the paper's case studies
``transpose_h100`` (Fig. 8; K4), ``matadd_h100`` (Fig. 1/2; K5) and
``jacobi1d_h100`` (Fig. 7; K6).  Each module holds the kernel wrapper
(CUDA source under ``csrc/``, built at first use by :mod:`.build`), its
plain PyTorch version, a launch counter and a FamilySpec; ``ops`` holds
the public wrappers and ``ref`` the oracles.
"""
from . import ref  # noqa: F401
