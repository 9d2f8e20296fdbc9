"""Training: losses, schedules and optimizers, the train step and the loop."""
