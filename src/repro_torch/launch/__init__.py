"""Launchers: ``launch.serve`` (the Viterbi, engine and LM services),
``launch.train`` (the LM testbed's training), ``launch.mesh`` (meshes of
logical shards) and ``launch.dryrun`` (every cell's per-shard program
counted on ``meta`` and priced on the H100 roofline)."""
