"""Layer configs/implementations of the port.

Importing this package registers every ported layer type with the config
serde registry, so JSON written by the JAX package reads back here.
Ported so far: CausalSelfAttention, RnnOutputLayer (and the base and
recurrent contracts they stand on).
"""

from . import attention  # noqa: F401
from . import base  # noqa: F401
from . import recurrent  # noqa: F401
