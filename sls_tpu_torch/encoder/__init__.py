"""XLS-R encoder."""
