"""Hand-written Hopper kernels, each driven by the comprehensive tree.

Families: ``matmul_h100`` (paper Fig. 3/4; K1), ``flash_attention_h100``
(K2) and ``ssd_scan_h100`` (K3).  Each module holds the kernel wrapper
(CUDA source under ``csrc/``, built at first use by :mod:`.build`), its
plain PyTorch version, a launch counter and a FamilySpec; ``ops`` holds
the public wrappers and ``ref`` the oracles.
"""
from . import ref  # noqa: F401
