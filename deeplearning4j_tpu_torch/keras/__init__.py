"""Keras 1.x import (``keras_model_import``) and the VGG-16 model path
(``trained_models``); ``bridge.py``, the JSON-over-TCP bridge of the JAX
package, is not ported yet (ROADMAP A11)."""
