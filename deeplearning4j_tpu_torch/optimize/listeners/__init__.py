"""Training listeners of the port (:mod:`.listeners`)."""
