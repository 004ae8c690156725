"""One rank (`mesh`): the reference's stand-in for the port's parallelism."""
