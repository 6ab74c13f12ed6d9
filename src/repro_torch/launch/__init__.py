"""Launchers: ``launch.serve`` (the Viterbi, engine and LM services).  The
reference's training launchers (train, dryrun, mesh) wait for the
training and sharding slices of the port."""
