"""Layer configs/implementations of the port.

Importing this package registers every ported layer type with the config
serde registry, so JSON written by the JAX package reads back here.
Every layer type of the JAX package is here: the core feed-forward
layers (Dense, Output, Loss, Activation, Dropout, Embedding),
Convolution, Subsampling, ZeroPadding, GlobalPooling, BatchNormalization,
LocalResponseNormalization, CausalSelfAttention, GravesLSTM,
GravesBidirectionalLSTM, RnnOutputLayer, the pretraining families
(AutoEncoder, RBM, VariationalAutoencoder with its reconstruction
distributions) and CenterLossOutputLayer (and the base and recurrent
contracts they stand on).
"""

from . import attention  # noqa: F401
from . import base  # noqa: F401
from . import convolution  # noqa: F401
from . import core  # noqa: F401
from . import normalization  # noqa: F401
from . import pooling  # noqa: F401
from . import pretrain  # noqa: F401
from . import recurrent  # noqa: F401
from . import training  # noqa: F401
from . import variational  # noqa: F401
