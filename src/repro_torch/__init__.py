"""PyTorch/CUDA port of the MSched reproduction for one NVIDIA H100.

Beside the JAX package it ports, with the same layout and names:
``configs`` and ``core`` are copies of the reference's pure-Python modules,
``models`` holds the dense transformer over a params dict whose leaves are the
runtime's pageable segments, ``kernels`` the hand-written CUDA kernels with
their plain PyTorch versions, and ``runtime``/``launch`` the live multi-model
server. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
