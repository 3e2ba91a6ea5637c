"""The port's evaluation: caption metrics and ``eval_split``."""
