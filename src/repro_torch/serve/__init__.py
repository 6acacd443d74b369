"""Serving of the port's decoder LM (copy of ``repro/serve``)."""
