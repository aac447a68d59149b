"""Training: optimizer, train state, train and eval steps, the trainer loop."""
