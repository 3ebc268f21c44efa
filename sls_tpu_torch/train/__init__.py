"""Eval step and score production."""
