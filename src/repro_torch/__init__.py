"""PyTorch/CUDA port of the comprehensive-optimization system.

A second package beside the JAX reference ``repro``; it imports nothing of
it.  Same module layout and names: ``core`` (the paper's symbolic machinery,
with the ``H100_SXM`` machine), ``artifacts.dispatch``, ``kernels``
(hand-written Hopper kernels ``matmul_h100`` and ``flash_attention_h100``
with their plain PyTorch versions), ``models``, ``configs``, ``runtime``
(paged ``ServeEngine``), ``plans.trace`` and ``launch.serve``.
"""
