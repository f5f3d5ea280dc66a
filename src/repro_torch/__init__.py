"""PyTorch/CUDA port of the MSched reproduction for one NVIDIA H100.

Beside the JAX package it ports, with the same layout and names:
``configs`` and ``core`` are copies of the reference's pure-Python modules,
``models`` holds the dense transformer over a params dict whose leaves are the
runtime's pageable segments, ``kernels`` the hand-written CUDA kernels with
their plain PyTorch versions, and ``runtime``/``launch`` the live multi-model
server. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The simulator path (``core.simulator``, ``serving``, ``telemetry``, and
``control.deadline`` / ``cluster.aggregate`` beside them) is the exception:
like the JAX package's, it models a ``Platform`` (``core.hardware``) in host
Python and touches no device, so it takes no ``device`` argument. It has no
CPU "fallback" because it has no device path to fall back from.
"""
