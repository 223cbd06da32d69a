"""Distribution: the mesh, its sharding rules and the collectives that
carry them out (port of ``repro.parallel``)."""
