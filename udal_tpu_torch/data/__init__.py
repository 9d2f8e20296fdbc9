"""Training labels and synthetic batches."""
