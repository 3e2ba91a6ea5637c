"""The port's data layer: feature readers and the caption dataset
(numpy on the host)."""
