"""Flow-level fabric simulator on torch tensors (port of ``repro.sim``):
max-min water-filling (:mod:`.fairshare`) and the event loop
(:mod:`.events`)."""
