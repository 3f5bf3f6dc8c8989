"""The plain reference: inputs, the model and its training step."""
