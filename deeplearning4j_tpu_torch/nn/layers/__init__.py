"""Layer configs/implementations of the port.

Importing this package registers every ported layer type with the config
serde registry, so JSON written by the JAX package reads back here.
Ported so far: the core feed-forward layers (Dense, Output, Loss,
Activation, Dropout, Embedding), Convolution, Subsampling, ZeroPadding,
GlobalPooling, BatchNormalization, LocalResponseNormalization,
CausalSelfAttention, GravesLSTM, GravesBidirectionalLSTM and
RnnOutputLayer (and the base and recurrent contracts they stand on).
"""

from . import attention  # noqa: F401
from . import base  # noqa: F401
from . import convolution  # noqa: F401
from . import core  # noqa: F401
from . import normalization  # noqa: F401
from . import pooling  # noqa: F401
from . import recurrent  # noqa: F401
