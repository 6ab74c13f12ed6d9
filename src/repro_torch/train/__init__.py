"""Training of the LM testbed: ``step`` (the loss, gradients and AdamW
update of one step, with microbatches) and ``loop`` (steps, logging,
checkpoints and resume), ports of the reference's ``train/`` modules."""
