"""Checkpoints: atomic last / best saves and the resume chain."""
