"""Neural-network modules of the port (mirrors ``deeplearning4j_tpu/nn``)."""
