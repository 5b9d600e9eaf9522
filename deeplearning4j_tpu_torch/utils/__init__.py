"""Utilities of the port: crash-safe writes and the model serializer."""
