"""Helpers of the port that depend on nothing else of it."""
