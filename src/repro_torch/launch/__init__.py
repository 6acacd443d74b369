"""Entry points of the port's model stack (copies of ``repro/launch``)."""
