"""Control plane, copied from the JAX package's ``control/``: so far only
``deadline`` (the SLO deadline policy the serving admission reads).

Import the submodules directly; this package pulls in nothing on import.
"""
