"""Launch layer of the port: the epsilon-join serving driver (``serve``) and
its load generator (``loadgen``)."""
