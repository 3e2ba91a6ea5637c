"""The port's training-side modules (so far: checkpoint files)."""
