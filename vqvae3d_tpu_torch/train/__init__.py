"""Stage-1 training of the port: optimizer state and the train/eval steps."""
