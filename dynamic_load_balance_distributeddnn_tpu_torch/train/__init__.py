"""Training: the elastic DBS step, the optimizer and the engine."""
