"""Launchers: ``launch.serve`` (the Viterbi and engine services).  The
reference's LM launchers (train, dryrun, mesh) wait for the LM testbed."""
