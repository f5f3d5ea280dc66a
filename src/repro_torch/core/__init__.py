"""MSched core: proactive memory scheduling, copied from the JAX package's
pure-Python modules, plus the live runtime over PyTorch tensors.

Import the submodules directly; this package pulls in nothing on import.
"""
