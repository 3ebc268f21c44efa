"""Train and eval steps, the Trainer and score production."""
