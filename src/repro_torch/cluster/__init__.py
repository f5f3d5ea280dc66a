"""Multi-GPU cluster scheduling, copied from the JAX package's ``cluster/``:
so far only ``aggregate`` (the request statistics the serving engine reads).

Import the submodules directly; this package pulls in nothing on import.
"""
