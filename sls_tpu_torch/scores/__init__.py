"""Score files."""
