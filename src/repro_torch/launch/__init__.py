"""Launch tooling of the port: the training driver (``launch.train``), the
meshes (``launch.mesh``), the dry run at the production meshes
(``launch.dryrun`` over ``launch.cost``), the H100 roofline
(``launch.roofline``) and the dry run's tables (``launch.report``)."""
