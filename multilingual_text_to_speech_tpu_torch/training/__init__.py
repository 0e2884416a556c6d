"""Training: the optimizer, its schedules and one training step."""
