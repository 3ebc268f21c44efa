"""Online scoring: batching engine and scorer."""
