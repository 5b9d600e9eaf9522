"""Network configuration of the port."""
