"""Launch tooling of the port: the training driver (``launch.train``)."""
