"""Training of the port: the optimizers, the trainer and the evaluator."""
