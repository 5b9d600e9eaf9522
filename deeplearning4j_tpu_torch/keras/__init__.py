"""Keras 1.x import (``keras_model_import``), the VGG-16 model path
(``trained_models``) and the JSON-over-TCP training-backend bridge
(``bridge``: ``KerasBridgeServer``, ``KerasBridgeClient``,
``KerasBridgeEntryPoint``, ``HDF5MiniBatchDataSetIterator``)."""
