"""NN modules of the port (twin of ``satrans_tpu/nn``)."""

from . import attention, core, initializers, interactions, metanet  # noqa: F401
