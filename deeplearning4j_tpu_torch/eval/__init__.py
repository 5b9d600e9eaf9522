"""Evaluation of the port: classification, ROC and regression metrics
(own copies of ``deeplearning4j_tpu/eval``, host numpy)."""
