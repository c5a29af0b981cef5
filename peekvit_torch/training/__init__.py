"""Training for the port: optimizers, the fused train path and the Trainer."""
