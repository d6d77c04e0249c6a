"""Exploration-exploitation experiments (EEE) of the reference (eee/src)."""
