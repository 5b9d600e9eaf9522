"""Optimization of the port: the line-search solvers (:mod:`.solvers`) and
the training listeners (:mod:`.listeners`)."""
