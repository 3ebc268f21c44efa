"""Classification heads."""
