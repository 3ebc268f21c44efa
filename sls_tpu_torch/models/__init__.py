"""Full detectors."""
