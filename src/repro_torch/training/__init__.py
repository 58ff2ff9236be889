"""Training substrate of the port: optimizers, train steps, checkpointing."""
