"""Launchers: ``launch.serve`` (the Viterbi, engine and LM services) and
``launch.train`` (the LM testbed's training).  The reference's sharding
launchers (dryrun, mesh) wait for the sharding slice of the port."""
