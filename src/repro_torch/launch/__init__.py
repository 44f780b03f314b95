"""Command-line launchers of the port: LM serving (``serve``), training
(``train``) and the H100-cluster dry run (``dryrun``, with ``mesh`` and
``roofline``)."""
