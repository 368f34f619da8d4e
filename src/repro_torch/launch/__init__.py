"""Launch layer of the port: the epsilon-join serving driver (``serve``)
and its load generator (``loadgen``), the training driver (``train``), the
meshes of ranks (``mesh``), and the dry run (``dryrun``) with its roofline
(``roofline``)."""
